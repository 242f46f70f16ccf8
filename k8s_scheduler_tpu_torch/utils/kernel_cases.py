"""Seeded edge cases of K5 `capacity` and K1 `static_base`, one source for
the CPU tests (plain versions against the reference) and for chip_smoke.py
(kernels against their plain versions on the card). Every input is made
with numpy from a fixed seed.

K5: sorted claims whose node runs cross the 32-claim chunk and the
256-claim block boundaries (`CAPACITY_RUNS`), every claim dead, one and
eight resources, and a revocation fold of five claims. Requests are whole
millicores (multiples of 250) and whole multiples of 2^20 bytes, like the
encoder's, and small enough that an f32 cumsum over all claims stays
exact.

K1: a 130-node cluster (`k1_objects`, built with either package's models)
that sets every static filter bit — unschedulable nodes, pinned pods,
NoSchedule taints and tolerations, node selectors and required affinity,
host ports, room for the fit filter, a sampling window that bites — and
the three static score terms; `k1_profile` keeps one filter or a prefix
of the score terms. `static_base_edge_inputs` derives the card's cases
from it: each filter bit alone, 0-3 score terms, one partial tile (N = 8),
an N that is not a multiple of 4, a misaligned row and P = 65537.

K16 / K17 (`static_reject_cases`, `dyn_reject_cases`): the first-rejector
attribution over the K1 cluster's static filters and over `_dyn_raw`'s
dynamic parts: a filter without a mask between two with one, every node
rejected by the first filter, rows all false and all true, F = 1 and 9,
columns out of the filters' default order, one part of each kind alone, a
start mask all false, and the scalar paths (N = 13, misaligned rows)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

CAPACITY_RUNS = (0, 1, 31, 32, 33, 255, 256, 257, 2000)
K1_FILTERS = ("NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity",
              "NodePorts")
K1_SCORES = (("ImageLocality", 1), ("NodeAffinity", 1), ("TaintToleration", 3))
K1_SAMPLING_PCT = 30

# per-resource request units: millicores (x250), bytes (x2^20), pods
_UNITS = (250.0, float(2**24), float(2**20), 1.0)


def _capacity_inputs(rng, runs, R, dead, N_extra=3):
    """(live, best, rank, req, node_req, alloc) numpy: node k has runs[k]
    live claims (zero-claim nodes interleaved), `dead` claims on no node."""
    runs = list(runs)
    N = len(runs) + N_extra
    nodes = rng.permutation(N)[: len(runs)]  # runs on scattered nodes
    best = np.concatenate([np.full(n, nodes[k], np.int32) for k, n in enumerate(runs)]
                          + [rng.integers(0, N, dead).astype(np.int32)])
    live = np.arange(best.shape[0]) < sum(runs)
    B = best.shape[0]
    perm = rng.permutation(B)  # claims in no particular order
    best, live = best[perm], live[perm]
    rank = rng.permutation(B).astype(np.int32)
    units = np.array([_UNITS[r % len(_UNITS)] for r in range(R)], np.float64)
    req = rng.integers(1, 8, (B, R)) * units
    node_req = rng.integers(0, 6, (N, R)) * units
    node_req[rng.random(N) < 0.3] = -0.0  # untouched rows keep -0.0
    # room for about 60% of each node's run
    load = np.zeros((N, R))
    np.add.at(load, best[live], req[live])
    alloc = node_req + np.floor(0.6 * load / units) * units + units
    return (live, best, rank, req.astype(np.float32), node_req.astype(np.float32),
            alloc.astype(np.float32))


def capacity_cases(device="cpu") -> dict:
    """{tag: (args, raw)}: args for `capacity_plain` / `capacity_cuda`;
    raw the unsorted numpy inputs (a pass: live, best, rank, req, node_req,
    alloc, slack; the fold: revoked, best, req, node_req)."""
    from ..ops.resources import fit_slack

    rng = np.random.default_rng(20260)
    cases = {}
    spec = {"runs, R=4": (CAPACITY_RUNS, 4, 40), "runs, R=1": (CAPACITY_RUNS, 1, 40),
            "runs, R=8": (CAPACITY_RUNS, 8, 40), "every claim dead": ((0,) * 6, 4, 300)}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    for tag, (runs, R, dead) in spec.items():
        live, best, rank, req, node_req, alloc = _capacity_inputs(rng, runs, R, dead)
        B, N = best.shape[0], node_req.shape[0]
        slack = fit_slack(torch.from_numpy(alloc)).numpy()
        rank_bits = int(B - 1).bit_length()
        key = np.where(live, best, N).astype(np.int64) * (1 << rank_bits) + rank
        order = np.argsort(key, kind="stable")
        args = (t(key[order]), t(order), rank_bits, t(req), t(node_req), t(alloc),
                t(slack), True)
        cases[tag] = (args, (live, best, rank, req, node_req, alloc, slack))
    # the round-end revocation fold: 5 revoked claims, negative requests
    live, best, _, req, node_req, alloc = _capacity_inputs(rng, CAPACITY_RUNS[:6], 4, 10)
    N = node_req.shape[0]
    revoked = np.zeros_like(live)
    revoked[rng.choice(np.flatnonzero(live), 5, replace=False)] = True
    key = np.where(revoked, best, N).astype(np.int64)
    order = np.argsort(key, kind="stable")
    slack = fit_slack(torch.from_numpy(alloc)).numpy()
    args = (t(key[order]), t(order), 0, t(-req), t(node_req), t(alloc), t(slack), False)
    cases["revocation fold, 5 claims"] = (args, (revoked, best, req, node_req))
    return cases


def k1_objects(m):
    """(nodes, pods, existing) of the K1 cases, from a models module
    (`MakeNode`, `MakePod`) of either package."""
    rng = np.random.default_rng(71)
    nodes = []
    for i in range(130):
        b = m.MakeNode(f"n{i}").capacity({
            "cpu": str(int(rng.choice([2, 4, 8]))),
            "memory": f"{int(rng.choice([4, 8, 16]))}Gi"}).labels(
            {"zone": f"z{i % 4}", "disk": ["ssd", "hdd"][i % 2]})
        if i % 9 == 4:
            b.unschedulable()
        if i % 7 == 0:
            b.taint("dedicated", "gpu")
        if i % 5 == 2:
            b.taint("soft", "x", "PreferNoSchedule")
        if i % 3 == 0:
            b.image("img-a", 500 * 2**20)
        if i % 4 == 1:
            b.image("img-b", 2 * 2**30)
        nodes.append(b.obj())
    pods = []
    for j in range(70):
        b = (m.MakePod(f"p{j}")
             .req({"cpu": f"{int(rng.integers(1, 12)) * 250}m",
                   "memory": f"{int(rng.integers(1, 24)) * 512}Mi"},
                  image=["img-a", "img-b", ""][j % 3])
             .created(float(j)))
        if j % 5 == 0:
            b.host_port(8080)
        if j % 6 == 2:
            b.node_selector({"disk": "ssd"})
        if j % 7 == 3:
            b.node_affinity_in("zone", ["z1", "z3"])
        if j % 4 == 1:
            b.node_affinity_preferred(5, "zone", ["z2"])
        if j % 8 == 5:
            b.toleration("dedicated", "gpu", "NoSchedule")
        if j % 3 == 1:
            b.toleration("soft", "x", "PreferNoSchedule")
        if j % 17 == 6:
            b.node(f"n{(j * 7) % 130}")
        pods.append(b.obj())
    existing = [(m.MakePod(f"e{k}").req({"cpu": "1"}).host_port(8080).obj(), f"n{3 * k}")
                for k in range(20)]
    return nodes, pods, existing


def k1_profile(config, filters=K1_FILTERS, n_scores: int = 3):
    """A profile (either package's config module) whose static filters are
    `filters` and whose score plugins are the first `n_scores` of
    `K1_SCORES`."""
    E = config.PluginEntry
    return config.SchedulerConfiguration(profiles=[config.Profile(plugins=config.Plugins(
        filter=config.PluginSet(disabled=["*"], enabled=[E(f) for f in filters]),
        score=config.PluginSet(disabled=["*"],
                               enabled=[E(n, w) for n, w in K1_SCORES[:n_scores]])))])


def _narrow(x, n: int):
    """The inputs cut to their first n nodes."""
    node = {f: getattr(x, f)[:n].contiguous() for f in (
        "node_valid", "node_unsched", "node_taintset", "node_used_ports", "node_room")}
    rows = {f: getattr(x, f)[:, :n].contiguous() for f in ("req", "pref", "img")}
    mask = None if x.mask is None else x.mask[:, :n].contiguous()
    return dataclasses.replace(x, **node, **rows, mask=mask,
                               samp_n=min(x.samp_n, n), samp_k=min(x.samp_k, n // 2))


def _misaligned(x):
    """The same values with every node-side vector and row table at an
    offset of one element from its allocation: the scalar path."""
    def off(t):
        buf = torch.empty((t.numel() + 1,), dtype=t.dtype, device=t.device)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        return v

    return dataclasses.replace(x, **{f: off(getattr(x, f)) for f in (
        "node_valid", "node_unsched", "node_taintset", "req", "pref", "img")},
        mask=None if x.mask is None else off(x.mask))


def _tile_pods(x, P: int):
    """The inputs with their pods repeated to P pods."""
    idx = torch.arange(P, device=x.node_valid.device) % x.shape[0]
    pod = {f: getattr(x, f)[idx].contiguous() for f in (
        "pod_node_name", "pod_tolset", "pod_req_id", "pod_sel_req_id", "pod_pref_id",
        "pod_imageset", "pod_ports", "pod_requested", "samp_off")}
    mask = None if x.mask is None else x.mask[idx].contiguous()
    return dataclasses.replace(x, **pod, mask=mask)


def static_base_edge_inputs(device) -> dict:
    """{tag: StaticBaseInputs} of the card's K1 edge cases, from
    `k1_objects` under the default filters and scores, with sampling, the
    fit filter and a seeded mask operand (every bit set)."""
    from .. import models
    from ..core.cycle import sampling_window
    from ..framework.interfaces import CycleContext
    from ..framework.runtime import Framework
    from ..ops import static_base as sb

    nodes, pods, existing = k1_objects(models)
    snap = models.SnapshotEncoder(device=device).encode(nodes, pods, existing)
    x = sb.static_base_inputs(Framework.from_config(), CycleContext(snap), fit=True,
                              sampling=sampling_window(snap, K1_SAMPLING_PCT))
    P, N = x.shape
    rng = np.random.default_rng(72)
    x = dataclasses.replace(x, flags=x.flags | sb.F_MASK, mask=torch.from_numpy(
        rng.random((P, N)) < 0.8).to(device))
    cases = {"every bit, 3 terms": x}
    for name, bit in (("NodeUnschedulable", sb.F_UNSCHED), ("NodeName", sb.F_NODENAME),
                      ("TaintToleration", sb.F_TAINT), ("NodeAffinity", sb.F_AFFINITY),
                      ("NodePorts", sb.F_PORTS), ("fit", sb.F_FIT),
                      ("sampling", sb.F_SAMPLE), ("mask operand", sb.F_MASK)):
        cases[f"{name} alone"] = dataclasses.replace(x, flags=bit)
    for k in range(3):
        cases[f"{k} score terms"] = dataclasses.replace(x, terms=x.terms[:k])
    cases["N=8, one partial tile"] = _narrow(x, 8)
    cases["N=13, scalar path"] = _narrow(x, 13)
    cases["misaligned rows, scalar path"] = _misaligned(x)
    cases["P=65537 x N=64"] = _tile_pods(_narrow(x, 64), 65537)
    return cases


# ---- K9 `preempt_claim` ---------------------------------------------------

CLAIM_SLICES = 16  # csrc/preempt_claim.cu kClusterWant: the cluster's node slices


def _claim_inputs(rng, device, *, N=8192, C2=64, n_live=None, R=4, MPN=8, MB=2, GP=4,
                  Q=4, MP=2, prio_base=0, gate_p=0.9, ok_p=0.9, port_p=0.2, pdb_p=0.2,
                  same_nodes=False):
    """A `ClaimInputs` made with numpy: per node 0..MPN victims in ascending
    priority (prio_base + 0..49) with whole-unit requests, so the prefix
    sums of freed requests are exact; preemptors at prio_base + 20..59
    needing 1-4 units a resource against 0-2 units of room; gate and
    what-if verdicts drawn with gate_p and ok_p, ports from Q ids with
    port_p, each victim in up to MB of GP budgets with pdb_p each. With
    `same_nodes` every node has the same victims."""
    from ..ops import preemption as pre
    from ..ops.argsel import wrap_i32
    from ..ops.resources import fit_slack

    n_live = C2 if n_live is None else n_live
    units = np.array([_UNITS[r % len(_UNITS)] for r in range(R)], np.float64)
    if same_nodes:
        cnt = np.full(N, MPN)
        prio_row = np.sort(rng.integers(0, 50, MPN))
        vprio = np.tile(prio_row, (N, 1))
        vreq = np.tile(rng.integers(1, 4, (1, MPN, R)), (N, 1, 1))
        vstart = np.tile(rng.integers(0, 100, (1, MPN)), (N, 1))
        room = np.tile(rng.integers(0, 3, (1, R)), (N, 1))
    else:
        cnt = rng.integers(0, MPN + 1, N)
        vprio = np.sort(rng.integers(0, 50, (N, MPN)), axis=1)
        vreq = rng.integers(1, 4, (N, MPN, R))
        vstart = rng.integers(0, 100, (N, MPN))
        room = rng.integers(0, 3, (N, R))
    valid = np.arange(MPN)[None, :] < cnt[:, None]
    E = int(valid.sum()) + 5
    node_pods = np.full((N, MPN), -1, np.int64)
    node_pods[valid] = rng.permutation(int(valid.sum()))
    vict_prio = np.where(valid, prio_base + vprio, pre.BIG_I32)
    vict_start = np.where(valid, vstart, 0).astype(np.float32)
    vict_pdb = np.where(valid[..., None] & (rng.random((N, MPN, MB)) < pdb_p),
                        rng.integers(0, GP, (N, MPN, MB)), -1)
    freed = np.where(valid[..., None], vreq * units, 0.0)
    prefix_freed = np.concatenate([np.zeros((N, 1, R)), np.cumsum(freed, axis=1)], axis=1)
    alloc = np.full((N, R), 8.0) * units
    node_req = alloc - room * units
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(dt).to(device)  # noqa: E731
    prefix_prio = torch.cat([torch.zeros((N, 1), dtype=torch.int32), wrap_i32(torch.cumsum(
        torch.from_numpy(np.where(valid, vict_prio, 0)), dim=1))], dim=1).to(device)
    tables = pre.VictimTables(
        t(node_pods, torch.int32), t(vict_prio, torch.int32), t(vict_start, torch.float32),
        t(vict_pdb, torch.int32), t(prefix_freed, torch.float32), prefix_prio)
    alloc_t = t(alloc, torch.float32)
    return pre.ClaimInputs(
        n_live=torch.tensor([n_live], dtype=torch.int32, device=device),
        live=t(np.arange(C2) < n_live, torch.bool),
        prio=t(prio_base + rng.integers(20, 60, C2), torch.int32),
        req=t(rng.integers(1, 5, (C2, R)) * units, torch.float32),
        port_ids=t(np.where(rng.random((C2, MP)) < port_p, rng.integers(0, Q, (C2, MP)), -1),
                   torch.int32),
        gate=t(rng.random((C2, N)) < gate_p, torch.bool),
        ok_nr=t(rng.random((C2, N, MPN + 1)) < ok_p, torch.bool),
        node_valid=t(rng.random(N) < 0.97, torch.bool),
        alloc=alloc_t, node_requested=t(node_req, torch.float32), slack=fit_slack(alloc_t),
        pdb_allowed=t(rng.integers(0, 3, GP), torch.int32),
        tables=tables, num_existing=E, num_ports=Q)


def _gate_only(x, nodes):
    """x with every rank's gate open on `nodes` only."""
    gate = torch.zeros_like(x.gate)
    gate[:, list(nodes)] = True
    return dataclasses.replace(x, gate=gate)


def _one_node(x, node):
    """x with the gate open on `node` only, no room there, prefix k of
    every node's victims freeing k units of each resource and every rank
    asking one unit above all victims' priorities: rank r takes victim r
    (k_claimed grows by one a rank) until the node runs out."""
    N, M1, R = x.tables.prefix_freed.shape
    dev = x.req.device
    units = torch.tensor([_UNITS[r % len(_UNITS)] for r in range(R)],
                         dtype=torch.float32, device=dev)
    freed = torch.arange(M1, dtype=torch.float32, device=dev)[None, :, None] * units
    return _gate_only(dataclasses.replace(
        x, req=units.expand_as(x.req).contiguous(), prio=torch.full_like(x.prio, 1000),
        node_requested=x.alloc.clone(),
        tables=dataclasses.replace(x.tables, prefix_freed=freed.expand(N, M1, R).contiguous())),
        [node])


def claim_cases(device="cpu") -> dict:
    """{tag: ClaimInputs} of K9's edge cases, at shapes that stress the
    cluster's split of the nodes into CLAIM_SLICES slices: N = 13 (three
    slices empty), 8193 and 16 * 512 + 7 (uneven slices); the winner in
    the last slice; keys equal on every field in two slices (the lower
    index wins); one node taken by consecutive ranks; PDB budgets spent
    part way through a 64-rank loop; port claims that block later ranks;
    n_live 0 and n_live = C2; R = 1 and 8 (8 reads the victim tables from
    L2: they do not fit in shared memory), MB = 4; victim priorities near
    2^30, so the priority sums wrap in i32."""
    rng = np.random.default_rng(90210)
    last = 8192 - 8192 // CLAIM_SLICES
    return {
        "N=13": _claim_inputs(rng, device, N=13, C2=16),
        "N=8193": _claim_inputs(rng, device, N=8193),
        "N=16*512+7": _claim_inputs(rng, device, N=16 * 512 + 7),
        "winner in the last slice": _gate_only(
            _claim_inputs(rng, device, C2=16, ok_p=1.0), range(last, 8192)),
        "equal keys in two slices": _gate_only(
            _claim_inputs(rng, device, C2=16, ok_p=1.0, port_p=0.0, pdb_p=0.0,
                          same_nodes=True), [700, 7000]),
        "one node, consecutive ranks": _one_node(
            _claim_inputs(rng, device, C2=16, ok_p=1.0, port_p=0.0, pdb_p=0.0,
                          same_nodes=True), 4321),
        "PDB budgets spent, 64 ranks": _claim_inputs(rng, device, GP=4, pdb_p=0.9),
        "ports block later ranks": _gate_only(
            _claim_inputs(rng, device, C2=32, Q=2, MP=1, port_p=1.0, ok_p=1.0),
            range(0, 8192, 1024)),
        "n_live=0": _claim_inputs(rng, device, n_live=0),
        "n_live=C2": _claim_inputs(rng, device, C2=64, n_live=64, gate_p=0.3),
        "n_live<C2": _claim_inputs(rng, device, C2=64, n_live=40),
        "R=1": _claim_inputs(rng, device, R=1),
        "R=8": _claim_inputs(rng, device, R=8),
        "MB=4": _claim_inputs(rng, device, MB=4, GP=8, pdb_p=0.5),
        "priority sums wrap": _claim_inputs(rng, device, prio_base=2**30),
    }


# ---- K4 `affinity_update` -------------------------------------------------

def _affinity_update_raw(rng, *, S=24, N=64, Z=4, B=100, MA=2, acc_p=0.5, match_p=0.1,
                         sel_none_p=0.5, no_zone_p=0.0, no_host_p=0.0, has_aff=True,
                         one_selector=False, pref0=None, w_lo=-100, w_hi=100):
    """numpy inputs of `affinity_update_batched`: N nodes with a zone (Z
    zones, key 0) and a hostname (key 1) domain, either missing with the
    given odds; D = Z + N + 3 global domain ids (3 unused); B pods, a
    share accepted on random nodes (-1 for some of the rest); MA anti and
    preferred term slots a pod over S selectors and both keys, integer
    weights in [w_lo, w_hi]; an integer-valued old state (pref_sym all
    `pref0` when given)."""
    D = Z + N + 3
    zone = np.where(rng.random(N) < no_zone_p, -1, rng.integers(0, Z, N))
    host = np.where(rng.random(N) < no_host_p, -1, Z + np.arange(N))
    node_domains = np.stack([zone, host], axis=1).astype(np.int32)
    accepted = rng.random(B) < acc_p
    node_of = np.where(accepted | (rng.random(B) < 0.7), rng.integers(0, N, B), -1)

    def terms():
        sel = np.where(rng.random((B, MA)) < sel_none_p, -1, rng.integers(0, S, (B, MA)))
        if one_selector:
            sel[:] = 0
        return np.stack([sel, rng.integers(0, 2, (B, MA))], axis=2).astype(np.int32)

    m_pending = rng.random((S, B)) < match_p
    if one_selector:
        m_pending[0] = True
    return {
        "node_domains": node_domains, "pod_anti_terms": terms(), "pod_pref_aff": terms(),
        "pod_pref_aff_w": rng.integers(w_lo, w_hi + 1, (B, MA)).astype(np.float32),
        "has_inter_pod_affinity": has_aff,
        "counts": rng.integers(0, 5, (S, D)).astype(np.float32),
        "total": rng.integers(0, 50, S).astype(np.float32),
        "anti_presence": rng.random((S, N)) < 0.05,
        "pref_sym": (np.full((S, N), pref0, np.float32) if pref0 is not None
                     else rng.integers(-20, 20, (S, N)).astype(np.float32)),
        "m_pending": m_pending, "accepted": accepted, "node_of": node_of.astype(np.int32),
    }


def affinity_update_raw_cases() -> dict:
    """{tag: numpy inputs} of K4's edge cases: nodes with no domain for a
    key (d < 0), mostly empty term slots (sel = -1), hostname and zone
    terms in one round (every case), many accepted pods on one selector,
    preferred sums near 2^24, MA = 1 and 4, B not a multiple of 32 (and
    N = 13, D = 20: the row fold's scalar path), no accepted pod, and a
    snapshot without inter-pod affinity (counts and totals only)."""
    rng = np.random.default_rng(4404)
    return {
        "nodes without a domain (d < 0)": _affinity_update_raw(rng, no_zone_p=0.3,
                                                               no_host_p=0.1),
        "mostly empty term slots (sel = -1)": _affinity_update_raw(rng, sel_none_p=0.8),
        "zone and hostname terms": _affinity_update_raw(rng, sel_none_p=0.0),
        "many accepted pods on one selector": _affinity_update_raw(
            rng, acc_p=0.9, one_selector=True),
        "preferred sums near 2^24": _affinity_update_raw(
            rng, acc_p=1.0, sel_none_p=0.0, pref0=float(2**24 - 2**16), w_lo=1, w_hi=100),
        "MA=1": _affinity_update_raw(rng, MA=1),
        "MA=4": _affinity_update_raw(rng, MA=4),
        "B=13, N=13": _affinity_update_raw(rng, B=13, N=13),
        "B=100": _affinity_update_raw(rng, B=100),
        "no accepted pod": _affinity_update_raw(rng, acc_p=0.0),
        "no inter-pod affinity": _affinity_update_raw(rng, has_aff=False),
    }


def affinity_update_args(raw: dict, device) -> tuple:
    """(snap, state, m_pending, accepted, node_of) of the port's
    `affinity_update` from `affinity_update_raw_cases` inputs; `snap`
    holds just the fields the function reads."""
    import types

    from ..ops import interpod as ip

    t = lambda k: torch.from_numpy(np.ascontiguousarray(raw[k])).to(device)  # noqa: E731
    B = raw["accepted"].shape[0]
    N = raw["node_domains"].shape[0]
    snap = types.SimpleNamespace(
        P=B, N=N, node_domains=t("node_domains"), pod_anti_terms=t("pod_anti_terms"),
        pod_pref_aff=t("pod_pref_aff"), pod_pref_aff_w=t("pod_pref_aff_w"),
        has_inter_pod_affinity=raw["has_inter_pod_affinity"])
    state = ip.AffinityState(t("counts"), t("total"), t("anti_presence"), t("pref_sym"))
    return snap, state, t("m_pending"), t("accepted"), t("node_of")


# ---- K13 `scan_commit` ----------------------------------------------------

SCAN_SLICES = 16  # ops/scan_commit.CLUSTER: the cluster's CTAs


def scan_cta(n: int, N: int) -> int:
    """The CTA of a 16-CTA cluster that owns node n of N: the one whose
    slice of ceil(N / 16) nodes holds it."""
    return n // -(-N // SCAN_SLICES)

SCAN_TAGS = (
    "N=13", "N=8193", "N=16*512+7", "winner in the last slice",
    "equal best scores in two slices", "-0.0 / +0.0 tie",
    "nominated: another slice, and infeasible", "no feasible node",
    "hard spread, minimum in another slice's zone",
    "matched selectors counted in another slice's zone",
    "required affinity bootstrapped by total == 0",
    "anti-affinity written by one pod and read by the next",
    "host-port conflicts between consecutive pods", "pad pods interleaved in order",
    "R=1", "R=8")
ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
_EXTENDED = ("example.com/a", "example.com/b", "example.com/c", "example.com/d")


def _scan_nodes(m, n, zones=3, cpu=4, big=(), big_cpu=64, extra=None):
    """n nodes `node-i` of `cpu` cores (`big` ones of big_cpu) in `zones`
    contiguous zones z0, z1, ..., with hostname labels; `extra` adds 8 of
    each extended resource."""
    nodes = []
    for i in range(n):
        cap = {"cpu": str(big_cpu if i in big else cpu), "memory": "32Gi"}
        if extra:
            cap.update({r: "8" for r in extra})
        nodes.append(m.MakeNode(f"node-{i}").capacity(cap).labels(
            {ZONE: f"z{i * zones // n}", HOST: f"node-{i}"}).obj())
    return nodes


def _pod(m, name, cpu="500m", app="a", extra=None):
    req = {"cpu": cpu}
    if extra:
        req.update({r: "1" for r in extra})
    return m.MakePod(name).req(req).labels({"app": app})


def scan_objects(m, tags=None) -> dict:
    """{tag: (nodes, pods, existing, opts)} of K13's edge cases (SCAN_TAGS,
    or those of `tags`), made with a models module (`MakeNode`, `MakePod`)
    of either package. `opts`:
    `resources` the encoder's resource names, `narrow` to cut the padded
    node axis to the real nodes (so the kernel's N is theirs),
    `keep_resources` to keep the first k resources (cpu alone: R = 1,
    which the encoder cannot give, every pod asking for one of `pods`),
    `profile`
    "static scores" for a profile without dynamic scores, `edit` a change
    of the packed inputs (`scan_inputs`)."""
    cases = {}

    def mixed(n, n_pods, zones=3, big=()):
        """Pods over two apps with required zone affinity, hostname
        anti-affinity, zone spread (hard and soft), preferred terms, host
        ports and one nomination; running pods of both apps."""
        rng = np.random.default_rng(1313 + n)
        nodes = _scan_nodes(m, n, zones=zones, big=big)
        pods = []
        for j in range(n_pods):
            app = ("a", "b")[j % 2]
            b = _pod(m, f"p{j}", cpu=f"{int(rng.integers(1, 6)) * 250}m", app=app)
            kind = j % 6
            if kind == 0:
                b.pod_affinity(ZONE, {"app": app})
            elif kind == 1:
                b.pod_affinity(HOST, {"app": app}, anti=True)
            elif kind == 2:
                b.spread(1, ZONE, {"app": app})
            elif kind == 3:
                b.spread(1, ZONE, {"app": app}, when_unsatisfiable="ScheduleAnyway")
                b.pod_affinity(ZONE, {"app": "b"}, weight=5)
            elif kind == 4:
                b.host_port(8080)
            if j == 5:
                b.nominated(f"node-{n - 2}")
            pods.append(b.obj())
        existing = [(_pod(m, f"e{k}", app=("a", "b")[k % 2]).obj(), f"node-{(7 * k) % n}")
                    for k in range(6)]
        return nodes, pods, existing

    cases["N=13"] = lambda: (*mixed(13, 12), {"narrow": True})
    cases["N=8193"] = lambda: (*mixed(8193, 24), {"narrow": True})
    cases["N=16*512+7"] = lambda: (*mixed(16 * 512 + 7, 24), {"narrow": True})
    # N = 32: two nodes a CTA; the two big nodes are the last CTA's
    cases["winner in the last slice"] = lambda: (
        _scan_nodes(m, 32, big=(30, 31)),
        [_pod(m, f"p{j}").obj() for j in range(6)], [], {})
    cases["equal best scores in two slices"] = lambda: (
        _scan_nodes(m, 32, big=(5, 20)),
        [_pod(m, f"p{j}").obj() for j in range(4)], [], {})
    cases["-0.0 / +0.0 tie"] = lambda: (
        _scan_nodes(m, 32), [_pod(m, f"p{j}").obj() for j in range(3)], [],
        {"profile": "static scores", "edit": "signed zeros"})
    cases["nominated: another slice, and infeasible"] = lambda: (
        _scan_nodes(m, 32, big=(30, 31)),
        [_pod(m, "p0").nominated("node-3").obj(), _pod(m, "p1").obj(),
         _pod(m, "p2", cpu="8").nominated("node-4").obj()], [], {})
    cases["no feasible node"] = lambda: (
        _scan_nodes(m, 32), [_pod(m, "p0").obj(), _pod(m, "p1", cpu="100").obj(),
                             _pod(m, "p2").obj()], [], {})
    # zones z0 = nodes 0-15, z1 = 16-23, z2 = 24-31: running pods of app a
    # in z0 and z1 only, so z2 (CTAs 12-15) holds the minimum
    spread_nodes = lambda: [m.MakeNode(f"node-{i}").capacity({"cpu": "8", "memory": "32Gi"}).labels(
        {ZONE: "z0" if i < 16 else "z1" if i < 24 else "z2", HOST: f"node-{i}"}).obj()
        for i in range(32)]
    cases["hard spread, minimum in another slice's zone"] = lambda: (
        spread_nodes(),
        [_pod(m, f"p{j}").spread(1, ZONE, {"app": "a"}).obj() for j in range(4)],
        [(_pod(m, f"e{k}").obj(), f"node-{(0, 3, 17, 20)[k]}") for k in range(4)], {})
    cases["matched selectors counted in another slice's zone"] = lambda: (
        _scan_nodes(m, 32, zones=2),
        [_pod(m, "p0", app="w").pod_affinity(ZONE, {"app": "w"}).obj()]
        + [_pod(m, f"p{j}", app="w").obj() for j in range(1, 4)]
        + [_pod(m, f"q{j}", app="v").pod_affinity(ZONE, {"app": "w"}).obj()
           for j in range(4)], [], {})
    cases["required affinity bootstrapped by total == 0"] = lambda: (
        _scan_nodes(m, 32),
        [_pod(m, f"p{j}", app="solo").pod_affinity(ZONE, {"app": "solo"}).obj()
         for j in range(4)], [], {})
    cases["anti-affinity written by one pod and read by the next"] = lambda: (
        _scan_nodes(m, 32, big=(30,)),
        [_pod(m, f"p{j}", app="x").pod_affinity(HOST, {"app": "x"}, anti=True).obj()
         for j in range(4)], [], {})
    cases["host-port conflicts between consecutive pods"] = lambda: (
        _scan_nodes(m, 32, big=(30,)),
        [_pod(m, f"p{j}").host_port(8080).obj() for j in range(4)], [], {})
    cases["pad pods interleaved in order"] = lambda: (
        _scan_nodes(m, 32), [_pod(m, f"p{j}").obj() for j in range(9)], [],
        {"edit": "interleave pads"})
    cases["R=1"] = lambda: (
        _scan_nodes(m, 32), [_pod(m, f"p{j}", cpu="3").obj() for j in range(5)], [],
        {"keep_resources": 1})
    cases["R=8"] = lambda: (
        _scan_nodes(m, 32, extra=_EXTENDED),
        [_pod(m, f"p{j}", extra=_EXTENDED[: j % 5]).obj() for j in range(6)], [],
        {"resources": ("cpu", "memory", "pods", "ephemeral-storage") + _EXTENDED})
    return {t: f() for t, f in cases.items() if tags is None or t in tags}


_RESOURCE_FIELDS = ("node_allocatable", "node_requested", "pod_requested", "exist_requested")


def narrow_resources(snap, k: int):
    """The snapshot with its first k resources alone (either package's)."""
    return dataclasses.replace(snap, resource_names=snap.resource_names[:k], **{
        f: getattr(snap, f)[:, :k] for f in _RESOURCE_FIELDS})


def prepare(snap, opts: dict):
    """A case's encoded snapshot cut as its `opts` say (either package's)."""
    if opts.get("narrow"):
        snap = narrow_nodes(snap)
    if "keep_resources" in opts:
        snap = narrow_resources(snap, opts["keep_resources"])
    return snap


def narrow_nodes(snap):
    """The snapshot with its node fields cut from the padded N to the real
    nodes (either package's `ClusterSnapshot`)."""
    n = int(snap.num_nodes)
    return dataclasses.replace(snap, **{
        f.name: getattr(snap, f.name)[:n] for f in dataclasses.fields(snap)
        if f.name.startswith("node_")})


def scan_profile(config, name):
    """The scheduler configuration of a case's `profile` (either package's
    config module): None for the default; "static scores" keeps the
    default filters and scores with the static plugins alone."""
    if name is None:
        return None
    E = config.PluginEntry
    return config.SchedulerConfiguration(profiles=[config.Profile(plugins=config.Plugins(
        score=config.PluginSet(disabled=["*"], enabled=[E("TaintToleration", 1),
                                                        E("NodeAffinity", 1)])))])


def scan_inputs(snap, opts: dict, full: bool = False):
    """A case's `ScanInputs` from its (narrowed) port snapshot: K1's plain
    static base under the case's profile, packed, then its edit — "signed
    zeros": every feasible static-base entry -7 except -0.0 at node 9 and
    +0.0 at node 25 (a tie: the lower index wins); "interleave pads": the
    rank order with a pad pod after every valid one. `full`: the full
    outputs' inputs (the base without the fit test, the per-step
    attribution asked for)."""
    from .. import config
    from ..core.cycle import sampling_window
    from ..framework.interfaces import CycleContext
    from ..framework.runtime import Framework
    from ..ops import scan_commit as sc
    from ..ops import static_base as sb

    fw = Framework.from_config(scan_profile(config, opts.get("profile")))
    ctx = CycleContext(snap)
    base = sb.static_base_plain(sb.static_base_inputs(
        fw, ctx, fit=not full, sampling=sampling_window(snap, 0)))
    x = sc.scan_commit_inputs(fw, ctx, base, fw.extra_init(ctx), rejects=full)
    edit = opts.get("edit")
    if edit == "signed zeros":
        live = x.sbase > sc.NEG_INF / 2
        s = torch.where(live, torch.full_like(x.sbase, -7.0), x.sbase)
        s[:, 9] = torch.where(live[:, 9], -0.0, s[:, 9])
        s[:, 25] = torch.where(live[:, 25], 0.0, s[:, 25])
        x = dataclasses.replace(x, sbase=s)
    elif edit == "interleave pads":
        valid = x.pod_valid[x.order.long()]
        v, pads = x.order[valid], x.order[~valid]
        k = min(len(v), len(pads))
        mixed = torch.stack([v[:k], pads[:k]], 1).reshape(-1)
        x = dataclasses.replace(x, order=torch.cat([mixed, v[k:], pads[k:]]).contiguous())
    return x


def scan_cases(device="cpu", tags=None, full: bool = False) -> dict:
    """{tag: ScanInputs} of K13's edge cases (`scan_objects`), encoded and
    packed by the port on `device`, on the kernel's 16 CTAs (node n in CTA
    `scan_cta(n, N)`): N = 13 (three CTAs own no node), 8193 and 16 * 512 +
    7 (a ragged last slice, two nodes for one thread), the winner in the last
    CTA, equal best scores in two CTAs (the lower index wins), a -0.0 /
    +0.0 tie, a nominated node in another CTA than the argmax and a
    nominated node that is infeasible, a pod no node fits, a hard spread
    constraint whose minimum zone lies in other CTAs, matched selectors
    counted in a zone other CTAs read, required
    affinity bootstrapped by total == 0, anti-affinity written by one pod
    and read by the next, host-port conflicts between consecutive pods,
    pad pods interleaved in the rank order, R = 1 and R = 8; `full`: their
    full outputs' inputs (`scan_inputs`)."""
    from .. import models

    out = {}
    for tag, (nodes, pods, existing, opts) in scan_objects(models, tags).items():
        enc = models.SnapshotEncoder(device=device, **(
            {"resource_names": opts["resources"]} if "resources" in opts else {}))
        snap = enc.encode(nodes, pods, existing)
        out[tag] = scan_inputs(prepare(snap, opts), opts, full)
    return out


# ---- K6 `guard_sweep` -----------------------------------------------------

GUARD_TILE = 256  # ops/guard_sweep.TILE: the entries a CTA owns
GUARD_BOUNDARY = 1024  # the tile boundary "a pod run across a tile boundary" crosses
GUARD_TAGS = (
    "a pod run across a tile boundary", "a group longer than several tiles",
    "no padding", "all padding", "a pod with entries in every slot", "spread caps at 1",
    "L not a multiple of the tile", "no spread caps", "keys after the padding key",
    "config #4's shape")
# role bits (ops/guard_sweep.RB_*)
_MATCH, _ANTI, _BOOT, _GMATCH, _SPREAD, _PORT, _PV = 1, 2, 4, 8, 16, 32, 64
_ALL_ROLES = (_MATCH, _ANTI, _BOOT, _GMATCH, _SPREAD, _PORT, _PV, _MATCH)


def _guard_table(keys, roles, caps, rank, gk_invalid):
    """numpy (s_packed, perm, rank_bits, B, role_tab, caps, gk_invalid) of a
    slot-major participant table: keys [slots, B] (gk_invalid for
    padding), roles [slots], caps [slots, B] or None, rank [B] a
    permutation; sorted on key * 2^rank_bits + rank as the rounds engine
    sorts it."""
    slots, B = keys.shape
    rank_bits = int(B - 1).bit_length()
    packed = ((keys.astype(np.int64) << rank_bits) + rank[None, :]).reshape(-1)
    perm = np.argsort(packed, kind="stable")
    return (packed[perm], perm.astype(np.int64), rank_bits, B,
            np.asarray(roles, np.int32),
            None if caps is None else caps.reshape(-1).astype(np.int32), gk_invalid)


def _guard_keys(rng, slots, B, n_keys, pad_p, gk_invalid, lo=0):
    keys = rng.integers(lo, lo + n_keys, (slots, B))
    keys[rng.random((slots, B)) < pad_p] = gk_invalid
    return keys


def _guard_caps(rng, roles, B, lo=1, hi=4):
    return np.where(np.asarray(roles)[:, None] == _SPREAD,
                    rng.integers(lo, hi, (len(roles), B)), 2**30)


def guard_raw_cases() -> dict:
    """{tag: numpy args} of K6's edge cases (GUARD_TAGS), each a sorted
    table as the rounds engine gives K6 (`_guard_table`):
      - a pod run across a tile boundary: 1023 GMATCH entries of other
        pods open a group, then one pod's MATCH, ANTI, SPREAD (cap 1),
        PORT and PV at entries 1023-1027: its ANTI and SPREAD pass only if
        its own MATCH, in the previous tile, is not counted;
      - a group longer than several tiles: 3300 MATCH / SPREAD entries of
        one key starting mid-tile, spread caps up to 3500, so the arrival
        count carried across tiles decides;
      - no padding, all padding, a pod with entries in every slot (runs of
        8), spread caps at 1, L = 1665, no caps, keys above the padding
        key (the padding run in the middle of the table);
      - config #4's shape: 22 slots x 2048 claimants, 96% padding, groups
        of a few entries."""
    rng = np.random.default_rng(4406)
    inv = 1000
    out = {}

    # a pod run across a tile boundary
    B, roles = 600, (_MATCH, _ANTI, _BOOT, _GMATCH, _SPREAD, _PORT, _PV, _GMATCH)
    rank = rng.permutation(B)
    by_rank = np.argsort(rank)
    keys = _guard_keys(rng, len(roles), B, 2000, 0.4, inv, lo=1)
    keys[3, by_rank[:511]] = 0
    keys[7, by_rank[:511]] = 0
    keys[3, by_rank[511]] = 0
    x = by_rank[512]
    keys[:, x] = inv
    keys[[0, 1, 4, 5, 6], x] = 0
    tail = by_rank[513:560]
    keys[rng.integers(0, len(roles), tail.shape[0]), tail] = 0
    caps = _guard_caps(rng, roles, B)
    caps[4, x] = 1
    out["a pod run across a tile boundary"] = _guard_table(keys, roles, caps, rank, inv)

    # a group longer than several tiles, starting mid-tile
    B, roles = 1100, (_MATCH, _SPREAD, _ANTI, _PORT, _MATCH, _PV)
    keys = _guard_keys(rng, len(roles), B, 3000, 0.5, inv)
    keys[keys == 5] = 6
    keys[[0, 1, 4], :] = 5
    caps = _guard_caps(rng, roles, B, 1, 3500)
    out["a group longer than several tiles"] = _guard_table(
        keys, roles, caps, rng.permutation(B), inv)

    B, roles = 300, _ALL_ROLES[:7]
    out["no padding"] = _guard_table(_guard_keys(rng, len(roles), B, 500, 0.0, inv), roles,
                                     _guard_caps(rng, roles, B), rng.permutation(B), inv)
    B, roles = 200, _ALL_ROLES[:5]
    out["all padding"] = _guard_table(np.full((len(roles), B), inv), roles,
                                      _guard_caps(rng, roles, B), rng.permutation(B), inv)

    B, roles = 160, _ALL_ROLES
    keys = _guard_keys(rng, len(roles), B, 100, 0.3, inv)
    keys[:, rng.choice(B, 12, replace=False)] = 3
    out["a pod with entries in every slot"] = _guard_table(
        keys, roles, _guard_caps(rng, roles, B), rng.permutation(B), inv)

    B, roles = 400, (_MATCH, _SPREAD, _SPREAD, _MATCH, _ANTI, _SPREAD)
    out["spread caps at 1"] = _guard_table(
        _guard_keys(rng, len(roles), B, 400, 0.2, inv), roles,
        _guard_caps(rng, roles, B, 1, 2), rng.permutation(B), inv)

    B, roles = 333, (_PORT, _PV, _MATCH, _SPREAD, _ANTI)
    out["L not a multiple of the tile"] = _guard_table(
        _guard_keys(rng, len(roles), B, 300, 0.3, inv), roles, _guard_caps(rng, roles, B),
        rng.permutation(B), inv)

    B, roles = 256, _ALL_ROLES
    out["no spread caps"] = _guard_table(_guard_keys(rng, len(roles), B, 300, 0.3, inv),
                                         roles, None, rng.permutation(B), inv)

    B, roles = 256, _ALL_ROLES
    out["keys after the padding key"] = _guard_table(
        _guard_keys(rng, len(roles), B, 400, 0.3, 200), roles, _guard_caps(rng, roles, B),
        rng.permutation(B), 200)

    # config #4's shape: anti and bootstrap terms, spread, matchers over
    # (selector, domain) groups, ports and PVs; most slots padding
    B = 2048
    roles = ((_ANTI,) * 2 + (_BOOT,) * 2 + (_SPREAD,) * 2 + (_MATCH,) * 8 + (_GMATCH,) * 4
             + (_PORT,) * 2 + (_PV,) * 2)
    keys = _guard_keys(rng, len(roles), B, 6000, 0.96, 10**6)
    out["config #4's shape"] = _guard_table(keys, roles, _guard_caps(rng, roles, B, 1, 6),
                                            rng.permutation(B), 10**6)
    assert tuple(out) == GUARD_TAGS
    return out


def guard_cases(device="cpu") -> dict:
    """{tag: args of `guard_sweep_plain` / `guard_sweep_cuda`} of K6's edge
    cases (`guard_raw_cases`) as tensors on `device`."""
    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {tag: (t(sp), t(perm), rb, B, t(roles), t(caps), inv)
            for tag, (sp, perm, rb, B, roles, caps, inv) in guard_raw_cases().items()}


# ---- K12 `pv_fold` --------------------------------------------------------

FOLD_CLUSTER = 16  # ops/pv_fold.CLUSTER: the cluster's CTAs
FOLD_TAGS = (
    "no claimant", "more claimants than a CTA's threads", "a contended batch",
    "SDR pods whose greedy choice dead-ends", "one PV, claimants in two CTAs",
    "V = 97")
_GIB = 2**30
FOLD_PVS = {"V = 97": 97}  # cases whose PV axis is cut to the real PVs


def narrow_pvs(snap, V: int):
    """The snapshot with its PV fields cut from the padded V to the first V
    (either package's `ClusterSnapshot`; the padding PVs are unavailable)."""
    return dataclasses.replace(snap, **{
        f.name: getattr(snap, f.name)[:V] for f in dataclasses.fields(snap)
        if f.name.startswith("pv_")})


def fold_cta(row: int, cluster: int = FOLD_CLUSTER) -> int:
    """The CTA of the fold's cluster that lists pod row `row` (blocks of 32
    rows dealt round-robin)."""
    return row // 32 % cluster


def _host_term(api, node):
    return (api.NodeSelectorTerm((api.NodeSelectorRequirement(HOST, "In", (node,)),)),)


def fold_objects(m, api) -> dict:
    """{tag: (nodes, pods, encode kwargs)} of K12's edge cases (FOLD_TAGS),
    made with a models module (`MakeNode`, `MakePod`) and its api module of
    either package. PVs pinned to a node by hostname, others without
    nodeAffinity (the global list), one WaitForFirstConsumer class
    without a provisioner; pod k is created at time k, so its rank is k
    unless the case says otherwise."""
    local = api.StorageClass("local", api.VOLUME_BINDING_WAIT, provisioner=False)

    def nodes(n):
        return [m.MakeNode(f"n{i}").capacity({"cpu": "64"}).labels({HOST: f"n{i}"}).obj()
                for i in range(n)]

    def pinned(name, node, gib=10):
        return api.PersistentVolume(name, capacity=gib * _GIB, storage_class="local",
                                    node_affinity=_host_term(api, node))

    def free(name, gib=10):
        return api.PersistentVolume(name, capacity=gib * _GIB, storage_class="local")

    def claimants(sizes_of, created=None):
        """one pod a claim-size tuple, its PVCs named after it"""
        pods, pvcs = [], []
        for k, sizes in enumerate(sizes_of):
            pod = m.MakePod(f"p{k}").req({"cpu": "1"}).created(
                float(k if created is None else created[k]))
            for j, z in enumerate(sizes):
                pvcs.append(api.PersistentVolumeClaim(f"c{k}-{j}", storage_class="local",
                                                      request=z * _GIB))
                pod = pod.volume(f"c{k}-{j}")
            pods.append(pod.obj())
        return pods, pvcs

    out = {}
    pods, pvcs = claimants([(5,)] * 24)
    pvs = [free(f"g{v}") for v in range(3)] + [pinned(f"pv{i}", f"n{i}") for i in range(4)]
    out["no claimant"] = (nodes(4), pods, dict(pvcs=pvcs, pvs=pvs, storage_classes=[local]))

    # 4400 claimants (275 a CTA of 16, 550 of 8, on 256 threads), 5
    # global PVs ahead of 3 per node: every claimant contends for the
    # global ones, 8-9 passes
    pods, pvcs = claimants([(5,)] * 4400)
    pvs = [free(f"g{v}") for v in range(5)]
    pvs += [pinned(f"pv{i}-{k}", f"n{i}") for i in range(64) for k in range(3)]
    out["more claimants than a CTA's threads"] = (
        nodes(64), pods, dict(pvcs=pvcs, pvs=pvs, storage_classes=[local]))

    # 12 claimants over 3 nodes of 2 PVs each and one global PV: passes
    # hand the PVs out one rank at a time
    pods, pvcs = claimants([(5,)] * 12)
    pvs = [free("g0")] + [pinned(f"pv{i}-{k}", f"n{i}") for i in range(3) for k in range(2)]
    out["a contended batch"] = (nodes(3), pods, dict(pvcs=pvcs, pvs=pvs,
                                                    storage_classes=[local]))

    # three slots of 1, 5 and 8 GiB over node PVs of 10, 6 and 2 GiB: the
    # lowest usable PV for the 1 GiB slot (the 10 GiB one) leaves nothing
    # for the 8 GiB slot, so the SDR-safe choice takes the 2 GiB PV; two
    # such pods a node, and single-volume pods beside them
    pods, pvcs = claimants([(1, 5, 8)] * 8 + [(5,)] * 4)
    pvs = [pinned(f"pv{i}-{c}", f"n{i}", c) for i in range(4) for c in (10, 6, 2)]
    out["SDR pods whose greedy choice dead-ends"] = (
        nodes(4), pods, dict(pvcs=pvcs, pvs=pvs, storage_classes=[local]))

    # 40 pods (rows 0 and 39 in CTAs 0 and 1) and 50 PVs (V pads to 52:
    # PV 45's winner entry in CTA 11 of 16, 6 of 8), PV 45 the one both can
    # take; row 39 ranks first
    created = [float(k + 1) for k in range(40)]
    created[39] = 0.0
    pods, pvcs = claimants([(5,)] * 40, created)
    pvs = [pinned(f"pv{v}", f"n{1 + v % 3}") for v in range(45)]
    pvs += [pinned("pv45", "n0")] + [pinned(f"pv{v}", f"n{1 + v % 3}") for v in range(46, 50)]
    out["one PV, claimants in two CTAs"] = (nodes(4), pods, dict(pvcs=pvcs, pvs=pvs,
                                                                storage_classes=[local]))

    # V = 97 (FOLD_PVS cuts the encoder's padding of the PV axis): pinned
    # PVs over 20 nodes and 7 global ones, single- and two-volume pods
    rng = np.random.default_rng(97)
    pvs = [free(f"g{v}", int(rng.integers(2, 12))) for v in range(7)]
    pvs += [pinned(f"pv{v}", f"n{int(rng.integers(0, 20))}", int(rng.integers(2, 12)))
            for v in range(90)]
    sizes = [tuple(int(z) for z in rng.integers(1, 10, int(rng.integers(1, 3))))
             for _ in range(150)]
    pods, pvcs = claimants(sizes)
    out["V = 97"] = (nodes(20), pods, dict(pvcs=pvcs, pvs=pvs, storage_classes=[local]))
    assert tuple(out) == FOLD_TAGS
    return out


def fold_draws(tag: str, P: int, V: int, n_nodes: int, pod_valid) -> list[dict]:
    """numpy (claimed, accepted, node_of) draws of a K12 case: three seeded
    draws (no PV claimed before, a quarter, a half), with the case's own
    claimants and nodes where it names them."""
    rng = np.random.default_rng(FOLD_TAGS.index(tag) + 120)
    valid = np.asarray(pod_valid)
    out = []
    for share in (0.0, 0.25, 0.5):
        claimed = rng.random(V) < share
        accepted = valid & (rng.random(P) < 0.9)
        node_of = rng.integers(0, n_nodes, P).astype(np.int32)
        if tag == "no claimant":
            accepted[:] = False
        elif tag == "more claimants than a CTA's threads":
            accepted = valid.copy()
        elif tag == "a contended batch":
            claimed[:] = False
            accepted = valid.copy()
            node_of = (np.arange(P) % 3).astype(np.int32)
        elif tag == "SDR pods whose greedy choice dead-ends":
            accepted = valid.copy()
            node_of = (np.arange(P) % 4).astype(np.int32)
        elif tag == "one PV, claimants in two CTAs":
            claimed[:] = False
            accepted = np.zeros(P, bool)
            accepted[[0, 39]] = True
            node_of[:] = 0
        out.append({"claimed": claimed, "accepted": accepted, "node_of": node_of})
    return out


def fold_cases(device="cpu") -> dict:
    """{"tag, draw d": args of `pv_fold_plain` / `pv_fold_cuda`} of K12's
    edge cases (`fold_objects`, `fold_draws`), encoded by the port on
    `device`; the rank is the snapshot's pod order, as the rounds engine
    passes it."""
    from .. import models
    from ..framework.interfaces import CycleContext

    out = {}
    for tag, (nodes, pods, kw) in fold_objects(models, models.api).items():
        snap = models.SnapshotEncoder(device=device).encode(nodes, pods, **kw)
        if tag in FOLD_PVS:
            snap = narrow_pvs(snap, FOLD_PVS[tag])
        tables = CycleContext(snap).volume_tables
        rank = snap.pod_order.to(torch.int32)
        for d, draw in enumerate(fold_draws(tag, snap.P, snap.pv_avail.shape[0],
                                            len(nodes), snap.pod_valid.cpu())):
            t = {k: torch.from_numpy(v).to(device) for k, v in draw.items()}
            out[f"{tag}, draw {d}"] = (snap, tables, t["claimed"], t["accepted"],
                                       t["node_of"], rank)
    return out


# ---- K14 `dyn_mask`, K15 `dyn_score` --------------------------------------

DYN_TAGS = (
    "zero allocatable", "an exact fit at the slack", "full nodes", "R = 1", "R = 8",
    "Q = 0", "pad port slots, a pod with 3 ports", "every row NEG_INF", "B = 1",
    "B = 13, N = 13", "N = 8199", "an empty term program", "a lone BalancedAllocation",
    "weights other than 1, a plane first", "R = 1, both resource scores",
    "BalancedAllocation over one of four resources")
_NEG_INF = -1e9
_DEFAULT_W = (1.0, 1.0, 0.0, 0.0)  # cpu and memory of four resources


def _slack32(alloc):
    """f32 fma(alloc, 1e-5, 1e-5) (exact f64 product, one rounding)."""
    eps = np.float64(np.float32(1e-5))
    return (alloc.astype(np.float64) * eps + eps).astype(np.float32)


def _dyn_raw(rng, B, N, R, *, n_mplanes=2, n_splanes=2, ports=None, Q=0, MP=2,
             terms=None, act=True, neg_p=0.2):
    """numpy inputs of one round's two stages: requests in encoder-like
    units, a static base with NEG_INF rows and entries (and a -0.0 and a
    +0.0 row), bool and f32 planes, and the term program (default: the fit
    score and BalancedAllocation over the first two resources, then the
    planes at weight 1)."""
    units = np.array([_UNITS[r % len(_UNITS)] for r in range(R)])
    alloc = (rng.integers(1, 64, (N, R)) * units).astype(np.float32)
    nreq = (rng.integers(0, 48, (N, R)) * units).astype(np.float32)
    preq = (rng.integers(0, 12, (B, R)) * units).astype(np.float32)
    vsbase = (rng.random((B, N)) * 300.0).astype(np.float32)
    vsbase[rng.random((B, N)) < neg_p] = _NEG_INF
    vsbase[rng.random(B) < 0.1] = _NEG_INF
    if B > 2:
        vsbase[1], vsbase[2] = -0.0, 0.0
    w = tuple(1.0 if r < 2 else 0.0 for r in range(R))
    if terms is None:
        terms = [("fit", 1.0, w, False), ("balanced", 1.0, w)] + [
            ("plane", 1.0, i) for i in range(n_splanes)]
    ids = claimed = None
    if ports:
        ids = np.where(rng.random((B, MP)) < 0.3, rng.integers(0, max(Q, 1), (B, MP)), -1)
        claimed = rng.random((N, Q)) < 0.4
    return {
        "vsbase": vsbase, "act": (rng.random(B) < 0.85) if act else None,
        "preq": preq, "alloc": alloc, "nreq": nreq, "fit": True,
        "ids": None if ids is None else ids.astype(np.int32), "claimed": claimed,
        "mplanes": [rng.random((B, N)) < 0.9 for _ in range(n_mplanes)],
        "splanes": [(rng.random((B, N)) * 100.0).astype(np.float32)
                    for _ in range(n_splanes)],
        "terms": terms,
    }


def dyn_raw_cases() -> dict:
    """{tag: numpy inputs} of K14's and K15's edge cases (DYN_TAGS):
      - allocatable 0 in some resources (the used fraction is 1, the room
        the slack less the requested);
      - requests exactly at the room (fit) and one ulp above it (no fit);
      - full nodes: requested above allocatable (fractions clamped to 1),
        MostAllocated;
      - R = 1 (every weight 1: rounded `x * 100` adds, the squares fused)
        and R = 8 (six of eight resources scored, four for the balance);
      - Q = 0; pad port slots between real ones and a pod with 3 ports;
      - every static row NEG_INF; B = 1; B = N = 13 and N = 8199 (the
        guarded path, a partial tile); no mask part and no score term;
      - BalancedAllocation as the one term (a lone product fused into the
        base add) and its anchor;
      - weights 3, 2, 5 and 1 (the "weighted" profile's), a plane first at
        weight 2 (a held product), BalancedAllocation meeting it;
      - ROADMAP C7's input (its own draw of seed 1411): R = 1 scored by the
        fit score and BalancedAllocation (folded to the constant 100, the
        fit's product fused into it), then a plane; and BalancedAllocation
        over one of four resources (not folded: a masked mean and
        variance) beside the fit score over two."""
    rng = np.random.default_rng(1411)
    out = {}

    x = _dyn_raw(rng, 64, 96, 4)
    x["alloc"][rng.random((96, 4)) < 0.3] = 0.0
    out["zero allocatable"] = x

    x = _dyn_raw(rng, 48, 64, 4)
    x["nreq"] = np.minimum(x["nreq"], x["alloc"])
    room = (x["alloc"] - x["nreq"]) + _slack32(x["alloc"])
    x["preq"] = room[rng.integers(0, 64, 48)]
    half = np.arange(48) % 2 == 1
    x["preq"][half] = np.nextafter(x["preq"][half], np.float32(np.inf))
    out["an exact fit at the slack"] = x

    x = _dyn_raw(rng, 40, 72, 4, terms=[("fit", 1.0, _DEFAULT_W, True),
                                        ("balanced", 1.0, _DEFAULT_W), ("plane", 1.0, 0)],
                 n_splanes=1)
    x["nreq"] = x["nreq"] + x["alloc"] * np.float32(1.5)
    out["full nodes"] = x

    out["R = 1"] = _dyn_raw(rng, 40, 64, 1, terms=[("fit", 1.0, (1.0,), False),
                                                   ("plane", 1.0, 0)], n_splanes=1)
    w8 = (1.0, 1.0, 0.0, 1.0, 1.0, 0.0, 1.0, 1.0)
    b8 = (1.0, 0.0, 1.0, 0.0, 1.0, 0.0, 1.0, 0.0)
    out["R = 8"] = _dyn_raw(rng, 40, 64, 8, terms=[("fit", 1.0, w8, True),
                                                   ("balanced", 1.0, b8), ("plane", 1.0, 0)],
                            n_splanes=1)

    x = _dyn_raw(rng, 32, 64, 4, ports=True, Q=0, MP=2)
    x["ids"][:] = -1
    out["Q = 0"] = x

    x = _dyn_raw(rng, 64, 80, 4, ports=True, Q=5, MP=4)
    x["ids"][::3] = [-1, 3, -1, 1]
    x["ids"][1::7] = [4, 0, 2, -1]
    out["pad port slots, a pod with 3 ports"] = x

    x = _dyn_raw(rng, 32, 64, 4)
    x["vsbase"][:] = _NEG_INF
    out["every row NEG_INF"] = x

    out["B = 1"] = _dyn_raw(rng, 1, 128, 4, ports=True, Q=3)
    out["B = 13, N = 13"] = _dyn_raw(rng, 13, 13, 4, ports=True, Q=4, MP=3)
    out["N = 8199"] = _dyn_raw(rng, 5, 8199, 4, ports=True, Q=2)

    x = _dyn_raw(rng, 32, 64, 4, n_mplanes=0, n_splanes=0, terms=[], act=False)
    x["fit"] = False
    out["an empty term program"] = x

    out["a lone BalancedAllocation"] = _dyn_raw(
        rng, 48, 64, 4, terms=[("balanced", 1.0, _DEFAULT_W)], n_splanes=0)

    three = (1.0, 1.0, 1.0, 0.0)
    out["weights other than 1, a plane first"] = _dyn_raw(
        rng, 48, 64, 4, n_splanes=3,
        terms=[("plane", 2.0, 0), ("balanced", 3.0, three), ("plane", 2.0, 1),
               ("fit", 5.0, three, False), ("plane", 3.0, 2), ("plane", 1.0, 1)])

    out["R = 1, both resource scores"] = _dyn_raw(
        np.random.default_rng(1411), 40, 64, 1, n_splanes=1,
        terms=[("fit", 1.0, (1.0,), False), ("balanced", 1.0, (1.0,)), ("plane", 1.0, 0)])
    out["BalancedAllocation over one of four resources"] = _dyn_raw(
        rng, 48, 64, 4, n_splanes=1,
        terms=[("balanced", 1.0, (1.0, 0.0, 0.0, 0.0)), ("plane", 1.0, 0),
               ("fit", 1.0, _DEFAULT_W, False)])
    assert tuple(out) == DYN_TAGS
    return out


def dyn_inputs(raw: dict, device) -> dict:
    """The port's arguments of one raw case on `device`: `mask` for
    `dyn_mask_*` (vsbase, parts, act_v), `score` for `dyn_score_*` (vsbase,
    terms) and `anchor` (None, the resource terms on one zero-request row,
    or None when the program has none)."""
    from ..ops import dyn_round as dr

    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)

    vsbase, preq, alloc, nreq = (t(raw[k]) for k in ("vsbase", "preq", "alloc", "nreq"))
    parts = [t(m) for m in raw["mplanes"]]
    if raw["fit"]:
        parts.append(dr.FitMask(preq, alloc, nreq))
    if raw["ids"] is not None:
        parts.append(dr.PortMask(t(raw["ids"]), t(raw["claimed"])))
    planes = [t(p) for p in raw["splanes"]]
    zero = torch.zeros((1, alloc.shape[1]), dtype=torch.float32, device=device)

    def terms(pod):
        out = []
        for term in raw["terms"]:
            kind, w = term[0], term[1]
            if kind == "fit":
                out.append((dr.FitScore(pod, alloc, nreq, term[2], term[3]), w))
            elif kind == "balanced":
                out.append((dr.BalancedScore(pod, alloc, nreq, term[2]), w))
            elif pod is preq:
                out.append((planes[term[2]], w))
        return tuple(out)

    anchor = terms(zero)
    return {"mask": (vsbase, tuple(parts), t(raw["act"])), "score": (vsbase, terms(preq)),
            "anchor": (None, anchor) if anchor else None}


def dyn_cases(device="cpu") -> dict:
    """{tag: `dyn_inputs`} of K14's and K15's edge cases (`dyn_raw_cases`)."""
    return {tag: dyn_inputs(raw, device) for tag, raw in dyn_raw_cases().items()}


# ---- K11 `pv_choice` --------------------------------------------------------

PV_CHOICE_CAP = 32  # csrc/pv_choice.cu kCap: list entries held in registers
PV_CHOICE_TAGS = (
    "a node list longer than the register cap", "global PVs merged with the node's list",
    "MVol = 1", "MVol = 8", "every PV claimed", "inactive rows with slots",
    "node_of out of range", "slots that ride dynamic provisioning",
    "capacities at the + 1e-3 edge")
PV_CHOICE_VOL = {"MVol = 1": 1}  # cases whose slot axis is cut to its first slots
_ZONE = "topology.kubernetes.io/zone"


def narrow_vol_slots(snap, k: int):
    """The snapshot with its pod volume slots cut to the first k (either
    package's `ClusterSnapshot`)."""
    return dataclasses.replace(snap, **{
        f.name: getattr(snap, f.name)[:, :k] for f in dataclasses.fields(snap)
        if f.name.startswith("pod_vol_")})


def pv_choice_objects(m, api) -> dict:
    """{tag: (nodes, pods, encode kwargs)} of K11's edge cases
    (PV_CHOICE_TAGS), made with a models module and its api module of
    either package. Nodes labelled by hostname (and zone: node i in zone
    i % 3); PVs pinned to a node by hostname, or without nodeAffinity (the
    global list); one WaitForFirstConsumer class without a provisioner
    unless the case says otherwise; pod k created at time k."""
    local = api.StorageClass("local", api.VOLUME_BINDING_WAIT, provisioner=False)

    def nodes(n):
        return [m.MakeNode(f"n{i}").capacity({"cpu": "64"})
                .labels({HOST: f"n{i}", _ZONE: f"z{i % 3}"}).obj() for i in range(n)]

    def pinned(name, node, gib=10.0, cls="local"):
        return api.PersistentVolume(name, capacity=gib * _GIB, storage_class=cls,
                                    node_affinity=_host_term(api, node))

    def free(name, gib=10.0, cls="local"):
        return api.PersistentVolume(name, capacity=gib * _GIB, storage_class=cls)

    def claimants(sizes_of, cls="local"):
        """one pod a claim-size tuple (GiB; a (class, GiB) pair picks the
        class), its PVCs named after it"""
        pods, pvcs = [], []
        for k, sizes in enumerate(sizes_of):
            pod = m.MakePod(f"p{k}").req({"cpu": "1"}).created(float(k))
            for j, z in enumerate(sizes):
                c, z = z if isinstance(z, tuple) else (cls, z)
                pvcs.append(api.PersistentVolumeClaim(f"c{k}-{j}", storage_class=c,
                                                      request=z * _GIB))
                pod = pod.volume(f"c{k}-{j}")
            pods.append(pod.obj())
        return pods, pvcs

    rng = np.random.default_rng(1102)
    out = {}
    # node 0 lists 40 PVs (over the 32 a word holds), nodes 1-3 a few;
    # single-, two- and three-volume pods
    pvs = [pinned(f"a{v}", "n0", float(rng.integers(2, 12))) for v in range(40)]
    pvs += [pinned(f"b{v}", f"n{1 + v % 3}", float(rng.integers(2, 12))) for v in range(9)]
    pods, pvcs = claimants([tuple(int(z) for z in rng.integers(1, 10, 1 + k % 3))
                            for k in range(60)])
    out["a node list longer than the register cap"] = (
        nodes(4), pods, dict(pvcs=pvcs, pvs=pvs, storage_classes=[local]))

    # PVs without nodeAffinity between the pinned ones in index order
    pvs = []
    for v in range(24):
        pvs.append(free(f"g{v}", float(rng.integers(2, 12))) if v % 3 == 1 else
                   pinned(f"pv{v}", f"n{v % 6}", float(rng.integers(2, 12))))
    pods, pvcs = claimants([tuple(int(z) for z in rng.integers(1, 10, 1 + k % 2))
                            for k in range(40)])
    out["global PVs merged with the node's list"] = (
        nodes(6), pods, dict(pvcs=pvcs, pvs=pvs, storage_classes=[local]))

    # single-volume pods, the slot axis cut to 1 (PV_CHOICE_VOL)
    pvs = [pinned(f"pv{v}", f"n{v % 5}", float(rng.integers(2, 12))) for v in range(20)]
    pvs += [free("g0", 6.0)]
    pods, pvcs = claimants([(int(rng.integers(1, 10)),) for _ in range(30)])
    out["MVol = 1"] = (nodes(5), pods, dict(pvcs=pvcs, pvs=pvs, storage_classes=[local]))

    # eight slots: the capped subsets and the dominance groups
    pvs = [pinned(f"pv{i}-{v}", f"n{i}", c) for i in range(3)
           for v, c in enumerate((10, 10, 10, 2, 2, 2, 2, 2, 2, 6))]
    pods, pvcs = claimants([(1, 8, 8, 8, 1, 1, 1, 1), (8, 8, 8, 1, 1, 1, 1, 1),
                            (1, 5, 8, 1, 1, 1, 1), (2, 2)] * 3)
    out["MVol = 8"] = (nodes(3), pods, dict(pvcs=pvcs, pvs=pvs, storage_classes=[local]))

    pvs = [pinned(f"pv{v}", f"n{v % 4}") for v in range(12)] + [free("g0")]
    pods, pvcs = claimants([(5,), (5, 5)] * 10)
    out["every PV claimed"] = (nodes(4), pods, dict(pvcs=pvcs, pvs=pvs,
                                                    storage_classes=[local]))
    out["inactive rows with slots"] = (nodes(4), pods, dict(pvcs=pvcs, pvs=pvs,
                                                            storage_classes=[local]))
    out["node_of out of range"] = (nodes(4), pods, dict(pvcs=pvcs, pvs=pvs,
                                                        storage_classes=[local]))

    # a provisioning class allowed in zones z0 and z1: its slots ride
    # dynamic provisioning there (the SDR choice's needy set and its -1),
    # beside static PVs of the class and local ones
    zonal = (api.NodeSelectorTerm((api.NodeSelectorRequirement(_ZONE, "In", ("z0", "z1")),)),)
    prov = api.StorageClass("prov", api.VOLUME_BINDING_WAIT, allowed_topologies=zonal)
    pvs = [pinned(f"pv{v}", f"n{v % 6}", 4.0 + v % 3, "prov" if v % 2 else "local")
           for v in range(18)]
    pods, pvcs = claimants([(("prov", 5), 3), (("prov", 3), ("prov", 3)), (3, 5, ("prov", 2)),
                            (("prov", 4),)] * 6)
    out["slots that ride dynamic provisioning"] = (
        nodes(6), pods, dict(pvcs=pvcs, pvs=pvs, storage_classes=[local, prov]))

    # capacities of a few bytes: f32 pv_cap + 1e-3 against the request, at
    # the edge (equal), one step over it and under it
    one = 1.0 / _GIB  # bytes, in the GiB unit of `pinned`
    pvs = [pinned(f"pv{v}", f"n{v % 3}", (1.0 + v % 3) * one) for v in range(9)]
    sizes = [float(np.float32(np.float32(1 + k % 3) + np.float32(1e-3))) for k in range(9)]
    sizes += [float(np.nextafter(np.float32(z), np.float32(np.inf))) for z in sizes[:3]]
    sizes += [float(np.nextafter(np.float32(z), np.float32(0))) for z in sizes[:3]]
    pods, pvcs = claimants([(z * one,) for z in sizes] + [(z * one, z * one) for z in sizes[:6]])
    out["capacities at the + 1e-3 edge"] = (nodes(3), pods, dict(pvcs=pvcs, pvs=pvs,
                                                                 storage_classes=[local]))
    assert tuple(out) == PV_CHOICE_TAGS
    return out


def pv_choice_draws(tag: str, P: int, V: int, n_nodes: int, pod_valid) -> list[dict]:
    """numpy (claimed, node_of, active) draws of a K11 case: three seeded
    draws (no PV claimed before, a quarter, a half), with the case's own
    bitmap, nodes or active rows where it names them."""
    rng = np.random.default_rng(PV_CHOICE_TAGS.index(tag) + 1100)
    valid = np.asarray(pod_valid)
    out = []
    for d, share in enumerate((0.0, 0.25, 0.5)):
        claimed = rng.random(V) < share
        node_of = rng.integers(0, n_nodes, P).astype(np.int32)
        active = valid & (rng.random(P) < 0.9)
        if tag == "a node list longer than the register cap":
            node_of[rng.random(P) < 0.6] = 0
        elif tag == "every PV claimed":
            claimed[:] = True
            if d == 1:  # all but one
                claimed[rng.integers(0, V)] = False
        elif tag == "inactive rows with slots":
            active = valid & (np.arange(P) % 2 == d % 2)
        elif tag == "node_of out of range":
            node_of[::3] = -1 - d
            node_of[1::3] = n_nodes + 64 + 100 * d  # past the padded node axis
        out.append({"claimed": claimed, "node_of": node_of, "active": active})
    return out


def pv_choice_cases(device="cpu") -> dict:
    """{"tag, draw d": args of `pv_choice_plain` / `pv_choice_cuda`} of
    K11's edge cases (`pv_choice_objects`, `pv_choice_draws`), encoded by
    the port on `device`."""
    from .. import models
    from ..framework.interfaces import CycleContext

    out = {}
    for tag, (nodes, pods, kw) in pv_choice_objects(models, models.api).items():
        snap = models.SnapshotEncoder(device=device).encode(nodes, pods, **kw)
        if tag in PV_CHOICE_VOL:
            snap = narrow_vol_slots(snap, PV_CHOICE_VOL[tag])
        tables = CycleContext(snap).volume_tables
        for d, draw in enumerate(pv_choice_draws(tag, snap.P, snap.pv_avail.shape[0],
                                                 len(nodes), snap.pod_valid.cpu())):
            t = {k: torch.from_numpy(v).to(device) for k, v in draw.items()}
            out[f"{tag}, draw {d}"] = (snap, tables, t["claimed"], t["node_of"], t["active"])
    return out


# ---- K8 `preempt_whatif` ----------------------------------------------------

WHATIF_TAGS = (
    "MPN = 72", "nodes with no domain for a key", "candidates with no terms",
    "host ports with winner_conf set", "affinity without spread", "spread without affinity",
    "a ScheduleAnyway spread term", "counts at the 0.5 thresholds", "the bootstrap rule")
WHATIF_OWN_CAP = 16  # csrc/preempt_whatif.cu kOwnCap: owned anti terms a node keeps


def whatif_objects(m) -> dict:
    """{tag: (nodes, pending, existing)} of K8's edge cases (WHATIF_TAGS),
    made with a models module of either package. Full nodes of 4 cores
    (labelled by hostname, zone z{i % 3} unless the case drops it) hold
    low-priority running pods of apps a-c; the pending pods ask for a
    core at priority 100, so each needs victims, and carry the case's
    terms, drawn from a seed."""
    rng = np.random.default_rng(808)
    apps = ("a", "b", "c")

    def nodes(n, no_zone=()):
        return [m.MakeNode(f"n{i}").capacity({"cpu": "4"}).labels(
            {HOST: f"n{i}"} if i in no_zone else {HOST: f"n{i}", _ZONE: f"z{i % 3}"}).obj()
            for i in range(n)]

    def running(n_nodes, per_node, owners=0.0, ports=0.0, extra=None, key=HOST):
        """per_node pods a node (a dict: by node, None the rest) filling its
        4 cores; with probability
        `owners` a pod owns an anti term (`key`) against a random app, with
        `ports` it holds host port 8080 or 8081"""
        out = []
        for i in range(n_nodes):
            n_here = per_node.get(i, per_node[None]) if isinstance(per_node, dict) else per_node
            for j in range(n_here):
                p = (m.MakePod(f"r{i}-{j}").req({"cpu": f"{4000 // n_here}m"})
                     .labels({"app": apps[int(rng.integers(0, 3))]})
                     .priority(int(rng.integers(0, 6))).created(float(j)))
                if rng.random() < owners:
                    p = p.pod_affinity(key, {"app": apps[int(rng.integers(0, 3))]}, anti=True)
                if rng.random() < ports:
                    p = p.host_port(8080 + int(rng.integers(0, 2)))
                if extra is not None:
                    p = extra(p, i, j)
                out.append((p.obj(), f"n{i}"))
        return out

    def pending(n, terms, cpu="1", prio=100, label=True):
        out = []
        for k in range(n):
            p = m.MakePod(f"q{k}").req({"cpu": cpu}).priority(prio).created(100.0 + k)
            if label:
                p = p.labels({"app": apps[int(rng.integers(0, 3))]})
            out.append(terms(p, k).obj())
        return out

    def anti_aff_spread(p, k, key=_ZONE):
        a = apps[int(rng.integers(0, 3))]
        if k % 3 == 0:
            p = p.pod_affinity(HOST if k % 2 else key, {"app": a}, anti=True)
        if k % 3 == 1:
            p = p.pod_affinity(key, {"app": a})
        if k % 2 == 0:
            p = p.spread(1 + k % 2, key, {"app": apps[int(rng.integers(0, 3))]})
        return p

    out = {}
    # node 0: 70 running pods (MPN 72: three verdict words), 30 of them
    # owning an anti term (over the kept 16); the preemptors' terms match
    # the crowded node's victims past slot 63
    out["MPN = 72"] = (nodes(4), pending(12, lambda p, k: anti_aff_spread(p, k, HOST)),
                       running(4, {0: 70, None: 4}, owners=0.45))
    out["nodes with no domain for a key"] = (
        nodes(6, no_zone=(1, 4)), pending(12, anti_aff_spread),
        running(6, 4, owners=0.2))
    # no terms; running owners' anti terms select the preemptors' apps
    out["candidates with no terms"] = (nodes(5), pending(10, lambda p, k: p),
                                       running(5, 4, owners=0.5))
    # winners with ports 8080/8081 placed this cycle on nodes 4-5 (2 free
    # cores each); preemptors asking for the same ports; victims with ports
    ns = nodes(6)
    ex = running(4, 4, ports=0.4) + [
        (m.MakePod(f"s{i}").req({"cpu": "2"}).labels({"app": "a"}).priority(0).obj(), f"n{i}")
        for i in (4, 5)]
    win = [m.MakePod(f"w{i}").req({"cpu": "1"}).host_port(8080 + i).priority(500)
           .created(float(i)).obj() for i in range(2)]
    pre = pending(8, lambda p, k: p.host_port(8080 + k % 2) if k % 4 else p, cpu="3")
    out["host ports with winner_conf set"] = (ns, win + pre, ex)
    out["affinity without spread"] = (
        nodes(6), pending(12, lambda p, k: p.pod_affinity(
            HOST if k % 2 else _ZONE, {"app": apps[k % 3]}, anti=k % 3 != 1)),
        running(6, 4, owners=0.3))
    out["spread without affinity"] = (
        nodes(6, no_zone=(5,)), pending(12, lambda p, k: p.spread(
            1 + k % 3, _ZONE if k % 2 else HOST, {"app": apps[k % 3]})),
        running(6, 4))
    out["a ScheduleAnyway spread term"] = (
        nodes(6), pending(12, lambda p, k: p.spread(
            1, _ZONE, {"app": apps[k % 3]}, when_unsatisfiable="ScheduleAnyway").spread(
            2, HOST, {"app": apps[(k + 1) % 3]})),
        running(6, 4))
    # every node holds 2 app-a pods: anti-affinity to app a by hostname
    # clears exactly when both are evicted (count - evicted = 0); zone
    # counts 4 / 4 / 4 of app b and maxSkew 1 (after + 1 - min = 1)
    ex = running(6, 4, extra=lambda p, i, j: p.labels({"app": "a" if j < 2 else "b"}))
    out["counts at the 0.5 thresholds"] = (
        nodes(6), pending(12, lambda p, k: p.pod_affinity(HOST, {"app": "a"}, anti=True)
                          if k % 2 else p.spread(1, _ZONE, {"app": "b"}), label=False), ex)
    # required affinity to the preemptors' own app, whose only pods are
    # low-priority victims on node 0 (the bootstrap once all are evicted)
    ex = running(4, 4, extra=lambda p, i, j: p.labels({"app": "solo"}) if i == 0 and j < 2
                 else p)
    out["the bootstrap rule"] = (
        nodes(4), pending(8, lambda p, k: p.labels({"app": "solo"}).pod_affinity(
            HOST if k % 2 else _ZONE, {"app": "solo"}), label=False), ex)
    assert tuple(out) == WHATIF_TAGS
    return out


def whatif_inputs_of(tag: str):
    """(snapshot, decision, the `WhatIfInputs` of its preemption pass) of
    one K8 case, on the CPU: the port's rounds cycle, then preemption with
    the plain stages, the what-if's inputs recorded."""
    from .. import models
    from ..core.cycle import build_cycle_fn, build_preemption_fn
    from ..ops import preemption

    nodes, pods, existing = whatif_objects(models)[tag]
    snap = models.SnapshotEncoder(device="cpu").encode(nodes, pods, existing)
    d = build_cycle_fn(commit_mode="rounds", device="cpu")(snap)
    seen = []

    def whatif(x):
        seen.append(x)
        return preemption.nonresource_ok_plain(x)

    r = build_preemption_fn(device="cpu", prefilter_fn=preemption.prefilter_plain,
                            whatif_fn=whatif, claim_fn=preemption.claim_loop_plain)(snap, d)
    return snap, d, r, seen[0]


def whatif_cases(device="cpu") -> dict:
    """{tag: `WhatIfInputs`} of K8's edge cases (`whatif_objects`), recorded
    on the CPU (`whatif_inputs_of`) and moved to `device`."""
    out = {}
    for tag in WHATIF_TAGS:
        x = whatif_inputs_of(tag)[3]
        out[tag] = dataclasses.replace(x, **{
            f.name: getattr(x, f.name).to(device) for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)})
    return out


# ---- K7 `preempt_prefilter` -----------------------------------------------

PREFILTER_TAGS = (
    "drawn", "no victim below the priority", "every candidate infeasible",
    "cand_ok false on half", "the only fit on the last node, N = 8199",
    "the only fit on the last node, N = 13", "an exact fit at equality",
    "negative free room", "R = 1", "R = 8", "MPN = 1", "MPN = 16", "C = 1",
    "C = 256, N = 8192", "node_valid false on the only fit",
    "prefix rooms out of order", "tables from L2: MPN = 64, R = 8",
)
_BIG_I32 = 2**31 - 1


def _prefilter_raw(rng, *, C=256, N=2048, MPN=8, R=4, gate_p=0.003, ok_p=0.9,
                   valid_p=0.97, room=(0, 3), need=(1, 5)) -> dict:
    """K7's inputs as numpy arrays: per node 0..MPN victims in ascending
    priority (0..49, empty slots BIG_I32) freeing 1-3 whole units a
    resource (the prefix sums exact), free room of `room` units; candidates
    at priority 20..59 needing `need` units, the gate open with gate_p."""
    units = np.array([_UNITS[r % len(_UNITS)] for r in range(R)], np.float64)
    cnt = rng.integers(0, MPN + 1, N)
    valid = np.arange(MPN)[None, :] < cnt[:, None]
    vprio = np.sort(rng.integers(0, 50, (N, MPN)), axis=1)
    freed = np.where(valid[..., None], rng.integers(1, 4, (N, MPN, R)) * units, 0.0)
    return {
        "prio": rng.integers(20, 60, C).astype(np.int32),
        "req": (rng.integers(need[0], need[1], (C, R)) * units).astype(np.float32),
        "cand_ok": rng.random(C) < ok_p,
        "vict_prio": np.where(valid, vprio, _BIG_I32).astype(np.int32),
        "prefix_freed": np.concatenate([np.zeros((N, 1, R)), np.cumsum(freed, axis=1)],
                                       axis=1).astype(np.float32),
        "free0": (rng.integers(room[0], room[1], (N, R)) * units).astype(np.float32),
        "gate": rng.random((C, N)) < gate_p,
        "node_valid": rng.random(N) < valid_p,
    }


def _only_node(x: dict, node: int, fits: bool = True) -> dict:
    """x with the gate open on `node` alone; with `fits`, that node holds
    MPN victims at priority 0 and enough room for every request at k = 1."""
    x = dict(x)
    gate = np.zeros_like(x["gate"])
    gate[:, node] = True
    x["gate"] = gate
    if fits:
        MPN = x["vict_prio"].shape[1]
        x["vict_prio"] = x["vict_prio"].copy()
        x["vict_prio"][node] = 0
        x["free0"] = x["free0"].copy()
        x["free0"][node] = x["req"].max(axis=0)
        x["node_valid"] = x["node_valid"].copy()
        x["node_valid"][node] = True
        x["cand_ok"] = np.ones_like(x["cand_ok"])
        assert MPN >= 1
    return x


def prefilter_raw_cases() -> dict:
    """{tag: numpy inputs} of K7's edge cases (PREFILTER_TAGS), each a draw
    of one seeded generator: no victim below any candidate's priority;
    requests no node can meet; cand_ok false on every other candidate; the
    only fitting node the last of an N that is not a multiple of the CTA's
    128 nodes (8199, and 13: one partial tile); requests equal to free room
    plus a prefix exactly (a fit) beside ones a ulp above (none); free room
    below zero, so that only longer prefixes fit; one and eight resources;
    one and sixteen victim slots; one candidate (a chunk of 32 mostly
    empty) and 256 at config #4's N; the only fit on a node that is not
    valid; prefix rooms that are not monotone in k (the walk must try them
    in order); and 64 slots of eight resources, whose tables do not fit in
    a CTA's shared memory (the kernel reads them from L2)."""
    rng = np.random.default_rng(7707)
    out = {"drawn": _prefilter_raw(rng, gate_p=0.3)}
    x = _prefilter_raw(rng)
    x["prio"] = np.zeros_like(x["prio"])
    out["no victim below the priority"] = x
    out["every candidate infeasible"] = _prefilter_raw(rng, need=(40, 60), gate_p=0.9)
    x = _prefilter_raw(rng, gate_p=0.9)
    x["cand_ok"] = np.arange(x["cand_ok"].shape[0]) % 2 == 1
    out["cand_ok false on half"] = x
    for n in (8199, 13):
        out[f"the only fit on the last node, N = {n}"] = _only_node(
            _prefilter_raw(rng, N=n, C=40), n - 1)
    # node 5 alone: requests equal to its free room plus prefix 2 (every
    # victim below the priorities), half of them one ulp above
    x = _only_node(_prefilter_raw(rng, C=64, MPN=4), 5, fits=False)
    x["vict_prio"][5] = [1, 2, 3, 4]
    x["node_valid"][5] = True
    x["cand_ok"][:] = True
    exact = x["free0"][5] + x["prefix_freed"][5, 2]
    req = np.broadcast_to(exact, x["req"].shape).copy()
    req[1::2] = np.nextafter(req[1::2], np.float32(np.inf))
    x["req"] = req.astype(np.float32)
    x["prefix_freed"][5, 3:] = 0.0  # longer prefixes free nothing more
    out["an exact fit at equality"] = x
    out["negative free room"] = _prefilter_raw(rng, room=(-6, -2), need=(1, 3))
    out["R = 1"] = _prefilter_raw(rng, R=1)
    out["R = 8"] = _prefilter_raw(rng, R=8)
    out["MPN = 1"] = _prefilter_raw(rng, MPN=1)
    out["MPN = 16"] = _prefilter_raw(rng, MPN=16, C=64)
    out["C = 1"] = _prefilter_raw(rng, C=1)
    out["C = 256, N = 8192"] = _prefilter_raw(rng, N=8192, gate_p=0.0008)
    x = _only_node(_prefilter_raw(rng, C=40), 77)
    x["node_valid"][77] = False
    out["node_valid false on the only fit"] = x
    x = _prefilter_raw(rng, room=(-3, 0))
    units = np.array([_UNITS[r % len(_UNITS)] for r in range(4)], np.float32)
    pf = rng.integers(0, 6, x["prefix_freed"].shape).astype(np.float32) * units
    pf[:, 0] = 0.0
    x["prefix_freed"] = pf
    out["prefix rooms out of order"] = x
    out["tables from L2: MPN = 64, R = 8"] = _prefilter_raw(rng, C=40, N=1024, MPN=64, R=8)
    assert tuple(out) == PREFILTER_TAGS
    return out


PREFILTER_ARGS = ("prio", "req", "cand_ok", "vict_prio", "prefix_freed", "free0", "gate",
                  "node_valid")


def prefilter_args(raw: dict, device) -> tuple:
    """One case's numpy inputs as K7's argument tuple on `device`."""
    return tuple(torch.from_numpy(np.ascontiguousarray(raw[k])).to(device)
                 for k in PREFILTER_ARGS)


def prefilter_cases(device="cpu") -> dict:
    """{tag: K7's argument tuple} of `prefilter_raw_cases` on `device`."""
    return {t: prefilter_args(x, device) for t, x in prefilter_raw_cases().items()}


# ---- K16 `static_rejects`, K17 `dyn_rejects` --------------------------------

STATIC_REJECT_TAGS = (
    "default filters, a mask operand", "rows all false", "rows all true",
    "seeded rows", "every node rejected by the first filter", "F = 1",
    "filters in another order", "N = 13, scalar path", "N = 8, one partial tile",
    "misaligned rows, scalar path", "P = 2049 x N = 64")
DYN_REJECT_TAGS = (
    "every part kind, F = 9", "rows all false", "rows all true",
    "every node rejected by the first part", "F = 1", "a start mask all false",
    "a plane alone", "a FitMask alone", "a PortMask alone", "Q = 0",
    "parts in another column order", "B = 13, N = 13", "N = 8199, a partial tile",
    "misaligned planes, scalar path")
_VB_COLUMN = 6  # VolumeBinding's index among the default filters


def static_reject_cases(device="cpu") -> dict:
    """{tag: (StaticBaseInputs, rows bool [P] or None)} of K16's edge cases
    (STATIC_REJECT_TAGS), from `k1_objects` under the default filters
    (F = 9: NodeResourcesFit, with no static mask, between NodePorts and
    VolumeBinding, whose mask operand is a seeded plane here), without fit
    and sampling; each case changes one thing."""
    from .. import models
    from ..framework.interfaces import CycleContext
    from ..framework.runtime import Framework
    from ..ops import static_base as sb

    nodes, pods, existing = k1_objects(models)
    snap = models.SnapshotEncoder(device=device).encode(nodes, pods, existing)
    x = sb.static_base_inputs(Framework.from_config(), CycleContext(snap))
    P, N = x.shape
    rng = np.random.default_rng(1416)
    x = dataclasses.replace(
        x, flags=x.flags | sb.F_MASK, columns=x.columns[:5] + (_VB_COLUMN,),
        mask=torch.from_numpy(rng.random((P, N)) < 0.8).to(device))
    assert x.n_filters == 9 and x.columns == (0, 1, 2, 3, 4, _VB_COLUMN)

    def rows(a):
        return torch.from_numpy(np.asarray(a, bool)).to(device)

    out = {"default filters, a mask operand": (x, None),
           "rows all false": (x, rows(np.zeros(P))),
           "rows all true": (x, rows(np.ones(P))),
           "seeded rows": (x, rows(rng.random(P) < 0.5)),
           "every node rejected by the first filter": (
               dataclasses.replace(x, node_unsched=torch.ones_like(x.node_unsched)), None),
           "F = 1": (dataclasses.replace(x, flags=sb.F_TAINT, n_filters=1,
                                         columns=(-1, -1, 0, -1, -1, -1)), None),
           "filters in another order": (dataclasses.replace(
               x, n_filters=7, columns=(5, 3, 6, 0, 2, 1)), rows(rng.random(P) < 0.7)),
           "N = 13, scalar path": (_narrow(x, 13), None),
           "N = 8, one partial tile": (_narrow(x, 8), None),
           "misaligned rows, scalar path": (_misaligned(x), None),
           "P = 2049 x N = 64": (_tile_pods(_narrow(x, 64), 2049), None)}
    assert tuple(out) == STATIC_REJECT_TAGS
    return out


def dyn_reject_raw_cases() -> dict:
    """{tag: numpy inputs} of K17's edge cases (DYN_REJECT_TAGS): `_dyn_raw`
    rows (its static base as the start mask, its mask planes, FitMask and
    PortMask operands) with each part's column: by default ports at 4, fit
    at 5 and the planes at 7 and 8 of F = 9 (the default filters' order,
    VolumeBinding's 6 without a part), `rows` its act flags."""
    rng = np.random.default_rng(1417)
    base = dict(ports=True, Q=5, MP=3)
    cols = {"port": 4, "fit": 5, "planes": (7, 8), "F": 9}
    out = {}

    def case(x, **kw):
        return dict(x, cols=dict(cols, **kw))

    x = _dyn_raw(rng, 72, 96, 4, **base)
    out["every part kind, F = 9"] = case(x)
    y = dict(x, act=np.zeros(72, bool))
    out["rows all false"] = case(y)
    out["rows all true"] = case(dict(x, act=None))
    y = dict(x, mplanes=[np.zeros_like(x["mplanes"][0])] + x["mplanes"][1:])
    out["every node rejected by the first part"] = case(y, planes=(0, 8))
    y = _dyn_raw(rng, 40, 64, 4, n_mplanes=0)
    out["F = 1"] = case(y, fit=0, F=1, planes=())
    y = dict(x, vsbase=np.full_like(x["vsbase"], _NEG_INF))
    out["a start mask all false"] = case(y)
    y = _dyn_raw(rng, 40, 64, 4, n_mplanes=1)
    out["a plane alone"] = case(dict(y, fit=False), planes=(2,), F=3)
    y = _dyn_raw(rng, 40, 64, 4, n_mplanes=0)
    out["a FitMask alone"] = case(y, fit=1, F=3, planes=())
    y = _dyn_raw(rng, 40, 64, 4, n_mplanes=0, **base)
    out["a PortMask alone"] = case(dict(y, fit=False), port=0, F=2, planes=())
    y = _dyn_raw(rng, 40, 64, 4, ports=True, Q=0, MP=2)
    y["ids"][:] = -1
    out["Q = 0"] = case(y)
    out["parts in another column order"] = case(x, port=3, fit=0, planes=(2, 1), F=4)
    out["B = 13, N = 13"] = case(_dyn_raw(rng, 13, 13, 4, ports=True, Q=4, MP=3))
    out["N = 8199, a partial tile"] = case(_dyn_raw(rng, 5, 8199, 4, ports=True, Q=2))
    out["misaligned planes, scalar path"] = case(dict(x, misaligned=True))
    assert tuple(out) == DYN_REJECT_TAGS
    return out


def dyn_reject_inputs(raw: dict, device) -> tuple:
    """(start, parts, F, rows) of `dyn_rejects_*` for one raw case:
    start = its static base > NEG_INF / 2, each part with its column."""
    from ..ops import dyn_round as dr

    def t(a):
        if a is None:
            return None
        v = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        if raw.get("misaligned"):  # one element past an allocation's start
            buf = torch.empty((v.numel() + 1,), dtype=v.dtype, device=device)
            w = buf[1:].view(v.shape)
            w.copy_(v)
            return w
        return v

    c = raw["cols"]
    parts = [(col, t(m)) for col, m in zip(c["planes"], raw["mplanes"])]
    if raw["fit"]:
        parts.append((c["fit"], dr.FitMask(*(t(raw[k]) for k in ("preq", "alloc", "nreq")))))
    if raw["ids"] is not None:
        parts.append((c["port"], dr.PortMask(t(raw["ids"]), t(raw["claimed"]))))
    return t(raw["vsbase"] > _NEG_INF * 0.5), tuple(parts), c["F"], t(raw["act"])


def dyn_reject_cases(device="cpu") -> dict:
    """{tag: `dyn_reject_inputs`} of K17's edge cases."""
    return {tag: dyn_reject_inputs(raw, device) for tag, raw in dyn_reject_raw_cases().items()}
