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
an N that is not a multiple of 4, a misaligned row and P = 65537."""

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
