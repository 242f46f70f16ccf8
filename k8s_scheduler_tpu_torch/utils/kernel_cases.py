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
