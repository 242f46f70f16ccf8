"""The scan engine's parts against the reference's.

- `ops/commit.py greedy_commit` / `unwind_assignments` against
  `k8s_scheduler_tpu/ops/commit.py` (jitted) on seeded random static
  tables with a resource-only `dyn_fn`: nominated nodes (feasible and
  not), invalid pods, exact score ties within a row and across a whole row,
  non-dyadic requests that make the unwind's subtraction order visible.
- Every per-pod hook — the resource scores on one pod's [R] request, the
  inter-pod affinity and spread masks and scores, `affinity_update`, and
  the framework's `dyn` / `extra_update` — against the reference's (jitted)
  on config #3- and #4-shaped synthetic workloads and duplicate term slots,
  at several scan steps with the state advanced step by step.
- `scan_commit_plain(scan_commit_inputs(...))` (the run K13 is held
  against on the card) equal to `greedy_commit` with the framework's hooks
  on the reference's static mask and score; K1's +-1e6 clip is the
  identity there; the packed operands (selector and domain lists, flags,
  score terms) say what the snapshot and framework say.

Tolerance: none — masks, assignments, requested resources, scores and
states are bit-equal."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k8s_scheduler_tpu.framework.interfaces as ref_ifc
import k8s_scheduler_tpu.framework.runtime as ref_runtime
import k8s_scheduler_tpu.models as ref_models
import k8s_scheduler_tpu.ops.commit as ref_commit
import k8s_scheduler_tpu.ops.interpod as ref_ip
import k8s_scheduler_tpu.ops.resources as ref_res
import k8s_scheduler_tpu.utils.synth as ref_synth
from k8s_scheduler_tpu_torch.config import Profile, SchedulerConfiguration
from k8s_scheduler_tpu_torch.core.cycle import sampling_mask, sampling_window
from k8s_scheduler_tpu_torch.framework.interfaces import CycleContext, PluginBase
from k8s_scheduler_tpu_torch.framework.runtime import Framework
from k8s_scheduler_tpu_torch.ops import commit, kernel_build
from k8s_scheduler_tpu_torch.ops import interpod as ip
from k8s_scheduler_tpu_torch.ops import resources as res
from k8s_scheduler_tpu_torch.ops import scan_commit as sc
from k8s_scheduler_tpu_torch.ops import static_base as sb
from k8s_scheduler_tpu_torch.utils import kernel_cases
from test_torch_interpod import _eq, _port_state, _state_eq, carry, case
from test_torch_encoding import fixture
from torch_one_thread import one_torch_thread  # noqa: F401

I32 = torch.int32


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# greedy_commit / unwind_assignments on random tables
# ---------------------------------------------------------------------------

TABLE_CASES = ["random", "nominated", "invalid", "ties", "row_ties", "tight"]


def _tables(name: str):
    rng = np.random.default_rng(sum(map(ord, name)))
    P, N, R = 28, 9, 2
    alloc = np.stack([rng.choice([4000.0, 8000.0, 16000.0], N),
                      rng.choice([8.0, 16.0, 32.0], N) * 2**30], 1).astype(np.float32)
    node_req = (alloc * rng.random((N, R)) * 0.5).astype(np.float32)
    req = np.stack([rng.uniform(100, 3000, P),
                    rng.uniform(0.2, 3.0, P) * 2**30], 1).astype(np.float32)
    if name == "tight":  # few pods fit: capacity decides, many unplaced
        req *= np.float32(4.0)
    mask = rng.random((P, N)) < 0.75
    score = rng.normal(0, 20, (P, N)).astype(np.float32)
    if name == "ties":
        score = (rng.integers(0, 3, (P, N)) * 25).astype(np.float32)
    if name == "row_ties":
        score = np.repeat(rng.integers(0, 3, (P, 1)), N, 1).astype(np.float32)
        mask[:] = True
    valid = np.ones(P, bool)
    if name == "invalid":
        valid = rng.random(P) < 0.6
    nominated = np.full(P, -1, np.int32)
    if name == "nominated":
        pick = rng.random(P) < 0.5
        nominated[pick] = rng.integers(0, N, int(pick.sum()))
    order = rng.permutation(P).astype(np.int32)
    zero_dyn = name in ("ties", "row_ties")
    return (order, mask, score, req, valid, nominated, alloc, node_req), zero_dyn


def _ref_commit(args, zero_dyn):
    w = jnp.asarray([1.0, 1.0], jnp.float32)

    def run(order, mask, score, req, valid, nominated, alloc, node_req):
        def dyn_fn(p, nr, ext, row):
            fit = ref_res.fit_mask_single(req[p], alloc, nr)
            if zero_dyn:
                return fit, jnp.zeros(nr.shape[0], jnp.float32)
            return fit, ref_res.least_requested_score(req[p], alloc, nr, w)

        return ref_commit.greedy_commit(
            order=order, static_mask=mask, static_score=score, pod_requested=req,
            pod_valid=valid, pod_nominated=nominated, node_allocatable=alloc,
            node_requested=node_req, dyn_fn=dyn_fn)

    return jax.jit(run)(*args)


def _port_commit(args, zero_dyn):
    order, mask, score, req, valid, nominated, alloc, node_req = map(_t, args)

    def dyn_fn(p, nr, ext, row):
        rq = ip.take_row(req, p)
        fit = res.fit_mask_single(rq, alloc, nr)
        if zero_dyn:
            return fit, torch.zeros(nr.shape[0])
        return fit, res.least_requested_score(rq, alloc, nr, (1.0, 1.0))

    return commit.greedy_commit(
        order=order, static_mask=mask, static_score=score, pod_requested=req,
        pod_valid=valid, pod_nominated=nominated, node_requested=node_req,
        dyn_fn=dyn_fn)


@pytest.mark.parametrize("name", TABLE_CASES)
def test_greedy_commit_bit_equal_to_reference(name):
    args, zero_dyn = _tables(name)
    want = _ref_commit(args, zero_dyn)
    got = _port_commit(args, zero_dyn)
    _eq(got.assignment, want.assignment, "assignment")
    _eq(got.node_requested, want.node_requested, "node_requested")
    a = got.assignment.numpy()
    valid, nominated = args[4], args[5]
    assert (a >= 0).any() and (a[~valid] == -1).all()
    if name == "tight":
        assert (a[valid] == -1).sum() > 5
    if name == "nominated":
        honoured = (nominated >= 0) & (a == nominated)
        assert honoured.any() and ((nominated >= 0) & (a >= 0) & ~honoured).any()
    if name == "row_ties":
        # every node ties: the first rank takes the lowest-index node it fits
        order, _, _, req, _, _, alloc, node_req = args
        p0 = order[0]
        fits = (req[p0][None, :] <= (alloc - node_req) + alloc * 1e-5 + 1e-5).all(1)
        assert a[p0] == int(np.argmax(fits)) and fits.any()


@pytest.mark.parametrize("name", TABLE_CASES)
def test_unwind_assignments_bit_equal_to_reference(name):
    args, zero_dyn = _tables(name)
    want = _ref_commit(args, zero_dyn)
    got = _port_commit(args, zero_dyn)
    drop = np.random.default_rng(7).random(args[0].shape[0]) < 0.5
    want_u = jax.jit(ref_commit.unwind_assignments)(want, drop, args[3])
    got_u = commit.unwind_assignments(got, _t(drop), _t(args[3]))
    _eq(got_u.assignment, want_u.assignment, "assignment")
    _eq(got_u.node_requested, want_u.node_requested, "node_requested")
    a = got.assignment.numpy()
    per_node = np.bincount(a[drop & (a >= 0)], minlength=1)
    if name != "tight":  # several subtractions on one node: order matters
        assert per_node.max() >= 2


def test_unwind_with_nothing_to_drop_is_the_identity():
    args, _ = _tables("random")
    got = _port_commit(args, False)
    out = commit.unwind_assignments(got, torch.zeros(args[0].shape[0], dtype=torch.bool),
                                    _t(args[3]))
    assert torch.equal(out.assignment, got.assignment)
    assert torch.equal(out.node_requested, got.node_requested)


# ---------------------------------------------------------------------------
# the per-pod hooks, step by step
# ---------------------------------------------------------------------------

HOOK_FIXTURES = ["cfg3", "cfg4", "duplicates", "existing"]


def _steps(c, n=6):
    """The first n valid pods in rank order, each with a node to commit to
    and whether it commits (seeded)."""
    rank = np.asarray(c.ref.pod_order)
    valid = np.asarray(c.ref.pod_valid)
    pods = [int(p) for p in np.argsort(rank, kind="stable") if valid[p]][:n]
    rng = np.random.default_rng(len(pods))
    nodes = rng.integers(0, int(c.ref.num_nodes), len(pods)).astype(np.int32)
    committed = rng.random(len(pods)) < 0.8
    return list(zip(pods, nodes.tolist(), committed.tolist()))


def _i32(v):
    return torch.tensor(v, dtype=I32)


@pytest.mark.parametrize("name", HOOK_FIXTURES)
def test_affinity_and_spread_hooks_step_by_step(name):
    c = case(name)
    ref_state, port_state = c.state_ref, _port_state(c.state_ref)
    dyn_mask = jax.jit(ref_ip.affinity_dyn_mask)
    dyn_score = jax.jit(ref_ip.affinity_dyn_score)
    s_mask = jax.jit(ref_ip.spread_dyn_mask)
    s_score = jax.jit(ref_ip.spread_dyn_score)
    update = jax.jit(ref_ip.affinity_update)
    n_nonzero = 0
    for p, node, ok in _steps(c):
        pj, pt = jnp.int32(p), _i32(p)
        feas = c.feasible[p]
        if c.ref.has_inter_pod_affinity:
            _eq(ip.affinity_dyn_mask(c.port, port_state, c.m_pending, pt),
                dyn_mask(c.ref, ref_state, c.m_pending_ref, pj), f"affinity mask p{p}")
            got = ip.affinity_dyn_score(c.port, port_state, c.m_pending, pt, _t(feas))
            _eq(got, dyn_score(c.ref, ref_state, c.m_pending_ref, pj, feas),
                f"affinity score p{p}")
            n_nonzero += int((got != 0).sum())
        if c.ref.has_topology_spread:
            _eq(ip.spread_dyn_mask(c.port, port_state, pt),
                s_mask(c.ref, ref_state, pj), f"spread mask p{p}")
            _eq(ip.spread_dyn_score(c.port, port_state, pt, _t(feas)),
                s_score(c.ref, ref_state, pj, feas), f"spread score p{p}")
        ref_state = update(c.ref, ref_state, c.m_pending_ref, pj, jnp.int32(node),
                           jnp.bool_(ok))
        port_state = ip.affinity_update(c.port, port_state, c.m_pending, pt, _i32(node),
                                        torch.tensor(ok))
        _state_eq(port_state, ref_state)
    if name == "duplicates":
        assert n_nonzero > 0  # the preferred terms score


@pytest.mark.parametrize("name", HOOK_FIXTURES)
def test_resource_hooks_on_one_pod(name):
    """fit_mask_single and the three resource scores on one pod's [R]
    request, jitted as one step of the reference's scan computes them."""
    c = case(name)
    rng = np.random.default_rng(11)
    alloc = np.asarray(c.ref.node_allocatable)
    w = np.zeros(alloc.shape[1], np.float32)
    w[:2] = 1.0
    for p, _, _ in _steps(c):
        nr = (alloc * rng.random(alloc.shape) * 0.9).astype(np.float32)
        req = np.asarray(c.ref.pod_requested)[p]
        for ref_fn, port_fn in ((ref_res.least_requested_score, res.least_requested_score),
                                (ref_res.most_requested_score, res.most_requested_score),
                                (ref_res.balanced_allocation_score,
                                 res.balanced_allocation_score)):
            want = jax.jit(ref_fn)(req, alloc, nr, w)
            _eq(port_fn(_t(req), _t(alloc), _t(nr), tuple(w.tolist())), want, ref_fn.__name__)
        _eq(res.fit_mask_single(_t(req), _t(alloc), _t(nr)),
            jax.jit(ref_res.fit_mask_single)(req, alloc, nr), "fit_mask_single")


def _ref_ctx(snap, fw):
    ctx = ref_ifc.CycleContext(snap)
    ctx.matched_pending  # materialised at the trace's own scope, as the cycle does
    fw.extra_init(ctx)  # names the owner of the shared affinity state
    return ctx


def _port_extra(ext):
    out = {}
    for k, v in ext.items():
        if isinstance(v, ref_ip.AffinityState):
            out[k] = _port_state(v)
        else:
            out[k] = _t(v)
    return out


def _extra_eq(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], ref_ip.AffinityState):
            _state_eq(got[k], want[k])
        else:
            _eq(got[k], want[k], k)


_THREE = ("cpu", "memory", "ephemeral-storage")
RESOURCE_PROFILES = {
    "three_resources": _THREE,
    "four_resources": _THREE + ("pods",),
    "three_weighted": _THREE,
    "three_no_balanced": _THREE,
}


def _profile(config, name):
    """A scheduler profile (either package's config module) that moves the
    dynamic score sum: other weights, a missing first term, a lone term,
    the MostAllocated strategy on one resource, resource scores averaged
    over three or all four resources (a weight sum whose reciprocal is
    inexact, a weight vector of ones)."""
    E = config.PluginEntry
    if name == "default":
        return None
    if name.endswith("weighted"):
        score = config.PluginSet(enabled=[
            E("NodeResourcesBalancedAllocation", 3), E("InterPodAffinity", 2),
            E("NodeResourcesFit", 5), E("PodTopologySpread", 1)])
    elif name.endswith("no_balanced"):
        score = config.PluginSet(disabled=["NodeResourcesBalancedAllocation"])
    elif name == "balanced_only":
        score = config.PluginSet(disabled=["*"],
                                 enabled=[E("NodeResourcesBalancedAllocation", 1)])
    elif name == "balanced_static":  # the one dynamic score, static ones on
        score = config.PluginSet(disabled=["NodeResourcesFit", "InterPodAffinity",
                                           "PodTopologySpread"])
    elif name == "fit_three_static":  # the fit score over three resources alone
        score = config.PluginSet(disabled=["NodeResourcesBalancedAllocation",
                                           "InterPodAffinity", "PodTopologySpread"])
    else:
        score = config.PluginSet()
    args = ({"NodeResourcesFit": {"scoring_strategy": "MostAllocated",
                                  "score_resources": ("cpu",)}}
            if name == "most_cpu" else {})
    if name in RESOURCE_PROFILES:  # constant means over 3 or 4 resources
        a = {"score_resources": RESOURCE_PROFILES[name]}
        args = {"NodeResourcesFit": a, "NodeResourcesBalancedAllocation": a}
    if name == "fit_three_static":
        args = {"NodeResourcesFit": {"score_resources": _THREE}}
    return config.SchedulerConfiguration(profiles=[config.Profile(
        plugins=config.Plugins(score=score), plugin_config=args)])


def _c7_objects(m):
    """ROADMAP C7's scan input: 40 nodes of 3, 6, 7 or 12 cores and 120
    pending pods of seeded millicore requests (usage fractions whose
    products with 100 round), running pods on every node."""
    rng = np.random.default_rng(1411)
    nodes = [m.MakeNode(f"n{i}").capacity({"cpu": f"{int(rng.choice([3, 6, 7, 12]))}"}).obj()
             for i in range(40)]
    pods = [m.MakePod(f"p{j}").req({"cpu": f"{int(rng.integers(50, 1900))}m"})
            .created(float(j)).obj() for j in range(120)]
    running = [(m.MakePod(f"r{i}").req({"cpu": f"{int(rng.integers(100, 2500))}m"}).obj(),
                f"n{i % 40}") for i in range(60)]
    return nodes, pods, running, []


class _Plain:
    """A hook case for a fixture without affinity (no mid-cycle state)."""

    def __init__(self, name):
        if name == "c7":
            nodes, pods, existing, groups = _c7_objects(ref_models)
        else:
            nodes, pods, existing, groups = fixture(name, ref_models, ref_synth)
        self.ref = ref_models.SnapshotEncoder().encode(nodes, pods, existing, groups)
        if name == "c7":  # cpu alone: R = 1
            self.ref = kernel_cases.narrow_resources(self.ref, 1)
        self.port = carry(self.ref)
        self.feasible = np.random.default_rng(3).random((self.ref.P, self.ref.N)) < 0.8


DYN_CASES = [(f, "default") for f in HOOK_FIXTURES + ["cfg2", "mixed"]] + [
    (f, prof) for f in ("duplicates", "cfg2")
    for prof in ("weighted", "no_balanced", "balanced_only", "balanced_static",
                 "most_cpu")] + [
    ("c1", prof) for prof in RESOURCE_PROFILES] + [
    ("c7", prof) for prof in ("default", "weighted", "no_balanced", "balanced_only",
                                   "most_cpu")]


@pytest.mark.parametrize("name,profile", DYN_CASES)
def test_framework_dyn_and_extra_update_step_by_step(name, profile):
    """The framework's per-pod composition: every dynamic filter ANDed onto
    the static row, each filter's first rejections counted, the weighted
    dynamic scores summed as the reference's compiled step sums them, and
    each plugin's state folded, at successive steps, under profiles that
    move the sum."""
    import k8s_scheduler_tpu.config as ref_config
    import k8s_scheduler_tpu_torch.config as port_config

    c = _Plain(name) if name in ("cfg2", "mixed", "c1", "c7") else case(name)
    ref_fw = ref_runtime.Framework.from_config(_profile(ref_config, profile))
    fw = Framework.from_config(_profile(port_config, profile))

    def ref_dyn(snap, p, nr, ext, row):
        return ref_fw.dyn(_ref_ctx(snap, ref_fw), p, nr, ext, row)

    def ref_update(snap, ext, p, node, ok):
        return ref_fw.extra_update(_ref_ctx(snap, ref_fw), ext, p, node, ok)

    ref_dyn, ref_update = jax.jit(ref_dyn), jax.jit(ref_update)
    ref_ext = jax.jit(lambda s: ref_fw.extra_init(_ref_ctx(s, ref_fw)))(c.ref)
    ctx = CycleContext(c.port)
    ext = fw.extra_init(ctx)
    _extra_eq(ext, ref_ext)
    nr = np.asarray(c.ref.node_requested)
    req = np.asarray(c.ref.pod_requested)
    for p, node, ok in _steps(c, 8):
        row = c.feasible[p]
        want_m, want_s, want_r = ref_dyn(c.ref, jnp.int32(p), nr, ref_ext, row)
        got_m, got_s, got_r = fw.dyn(ctx, _i32(p), _t(nr), ext, _t(row))
        _eq(got_r, want_r, f"rejects p{p}")
        if isinstance(got_s, commit.Product):  # one bare product, rounded alone
            got_s = got_s.x * got_s.c
        _eq(got_m, want_m, f"mask p{p}")
        _eq(got_s, want_s, f"score p{p}")
        feasible = np.flatnonzero(np.asarray(want_m))
        if len(feasible):  # commit where the scan could
            node = int(feasible[node % len(feasible)])
        ref_ext = ref_update(c.ref, ref_ext, jnp.int32(p), jnp.int32(node), jnp.bool_(ok))
        ext = fw.extra_update(ctx, ext, _i32(p), _i32(node), torch.tensor(ok))
        _extra_eq(ext, ref_ext)
        if ok:
            nr = nr.copy()
            nr[node] = nr[node] + req[p]
    if name == "mixed":
        assert ext["NodePorts"].any()


@pytest.mark.parametrize("name", ["cfg2", "duplicates"])
def test_lone_balanced_score_adds_to_the_static_score(name):
    """A profile whose one dynamic score is BalancedAllocation (a bare
    product) while the static scores stay on: the step's `static + dyn`,
    jitted as one program as in the reference's scan, fuses the product
    into the static add (`commit.add_static`)."""
    import k8s_scheduler_tpu.config as ref_config
    import k8s_scheduler_tpu_torch.config as port_config

    c = _Plain(name) if name == "cfg2" else case(name)
    ref_fw = ref_runtime.Framework.from_config(_profile(ref_config, "balanced_static"))
    fw = Framework.from_config(_profile(port_config, "balanced_static"))

    def ref_step(snap, p, nr, ext, row, sscore_row):
        m, dyn, _ = ref_fw.dyn(_ref_ctx(snap, ref_fw), p, nr, ext, row)
        return jnp.where(m, sscore_row + dyn, -1e9)

    ref_step = jax.jit(ref_step)
    ref_ext = jax.jit(lambda s: ref_fw.extra_init(_ref_ctx(s, ref_fw)))(c.ref)
    ctx = CycleContext(c.port)
    ext = fw.extra_init(ctx)
    _, sscore = fw.static_lean(ctx)
    assert (sscore != 0).any()
    nr = np.asarray(c.ref.node_requested)
    for p, _, _ in _steps(c, 8):
        row = c.feasible[p]
        want = ref_step(c.ref, jnp.int32(p), nr, ref_ext, row, sscore[p].numpy())
        m, dyn, _ = fw.dyn(ctx, _i32(p), _t(nr), ext, _t(row))
        assert isinstance(dyn, commit.Product)
        _eq(torch.where(m, commit.add_static(sscore[p], dyn), -1e9), want, f"score p{p}")


@pytest.mark.parametrize("profile", ["default", "weighted", "no_balanced"])
def test_one_resource_scan_matches_reference(profile):
    """ROADMAP C7's scan half: its cpu-only input (`_c7_objects`, R = 1)
    through `greedy_commit` with the framework's hooks, in both
    packages: the placements, the requested resources and every step's
    score row (the reference's through `dyn_aux`) bit for bit."""
    import k8s_scheduler_tpu.config as ref_config
    import k8s_scheduler_tpu_torch.config as port_config

    c = _Plain("c7")
    ref_fw = ref_runtime.Framework.from_config(_profile(ref_config, profile))
    fw = Framework.from_config(_profile(port_config, profile))
    snap = c.port
    ctx = CycleContext(snap)
    smask, sscore = fw.static_lean(ctx)
    smask = smask & sampling_mask(snap, 0)
    order = torch.argsort(snap.pod_order, stable=True).to(I32)
    rows = {}

    def dyn_fn(p, nr, ext, row):
        m, d, _ = fw.dyn(ctx, p, nr, ext, row)
        rows[int(p)] = torch.where(m & row, commit.add_static(sscore[int(p)], d),
                                   commit.NEG_INF)
        return m, d

    got = commit.greedy_commit(
        order=order, static_mask=smask, static_score=sscore,
        pod_requested=snap.pod_requested, pod_valid=snap.pod_valid,
        pod_nominated=snap.pod_nominated, node_requested=snap.node_requested,
        dyn_fn=dyn_fn, extra=fw.extra_init(ctx),
        update_fn=lambda ext, p, node, ok: fw.extra_update(ctx, ext, p, node, ok))

    def ref_run(s, smask, sscore, order):
        rc = _ref_ctx(s, ref_fw)

        def ref_dyn(p, nr, ext, row):
            m, d, _ = ref_fw.dyn(rc, p, nr, ext, row)
            return m, d, jnp.where(m & row, sscore[p] + d, commit.NEG_INF)

        return ref_commit.greedy_commit(
            order=order, static_mask=smask, static_score=sscore,
            pod_requested=s.pod_requested, pod_valid=s.pod_valid,
            pod_nominated=s.pod_nominated, node_allocatable=s.node_allocatable,
            node_requested=s.node_requested, dyn_fn=ref_dyn, extra=ref_fw.extra_init(rc),
            update_fn=lambda ext, p, node, ok: ref_fw.extra_update(rc, ext, p, node, ok))

    want = jax.jit(ref_run)(c.ref, smask.numpy(), sscore.numpy(), order.numpy())
    _eq(got.assignment, want.assignment, "assignment")
    _eq(got.node_requested, want.node_requested, "node_requested")
    aux = np.asarray(want.dyn_aux)
    assert len(rows) > 0
    for p, row in rows.items():
        _eq(row, aux[p], f"score row of pod {p}")


# ---------------------------------------------------------------------------
# the packed contract of K13
# ---------------------------------------------------------------------------

PACK_FIXTURES = ["cfg1", "cfg2", "cfg5", "mixed", "nominated", "cfg3", "cfg4"]


def _port_snapshot(name):
    nodes, pods, existing, groups = fixture(name, ref_models, ref_synth)
    return carry(ref_models.SnapshotEncoder().encode(nodes, pods, existing, groups))


def _direct_commit(fw, snap):
    """greedy_commit with the framework's hooks over the reference cycle's
    own static mask and score (static_lean & sampling)."""
    ctx = CycleContext(snap)
    smask, sscore = fw.static_lean(ctx)
    smask = smask & sampling_mask(snap, 0)
    return commit.greedy_commit(
        order=torch.argsort(snap.pod_order, stable=True).to(I32), static_mask=smask,
        static_score=sscore, pod_requested=snap.pod_requested, pod_valid=snap.pod_valid,
        pod_nominated=snap.pod_nominated, node_requested=snap.node_requested,
        dyn_fn=lambda p, nr, ext, row: fw.dyn(ctx, p, nr, ext, row),
        extra=fw.extra_init(ctx),
        update_fn=lambda ext, p, node, ok: fw.extra_update(ctx, ext, p, node, ok),
    ), smask, sscore


def _packed(fw, snap):
    ctx = CycleContext(snap)
    x_sb = sb.static_base_inputs(fw, ctx, fit=True, sampling=sampling_window(snap, 0))
    return sc.scan_commit_inputs(fw, ctx, sb.static_base_plain(x_sb), fw.extra_init(ctx))


@pytest.mark.parametrize("name", PACK_FIXTURES)
def test_scan_commit_plain_equals_greedy_commit_with_the_hooks(name):
    fw = Framework.from_config()
    snap = _port_snapshot(name)
    want, _, _ = _direct_commit(fw, snap)
    kernel_build.reset_launch_counts()
    got = sc.scan_commit(_packed(fw, snap))  # CPU tensors: the plain version
    assert all(v == 0 for v in kernel_build.launch_counts.values())
    assert torch.equal(got.assignment, want.assignment)
    assert torch.equal(got.node_requested, want.node_requested)
    assert torch.equal(got.ports, want.extra["NodePorts"])
    state = next((v for v in want.extra.values() if isinstance(v, ip.AffinityState)), None)
    if state is not None:
        for f in ("counts", "total", "anti_presence", "pref_sym"):
            assert torch.equal(getattr(got.state, f), getattr(state, f)), f
    assert (got.assignment >= 0).any()


@pytest.mark.parametrize("name", PACK_FIXTURES)
def test_static_base_clip_is_the_identity(name):
    """K1 clips the static score to +-1e6 and the reference's scan does not:
    on the default plugins' static scores the clip never bites, so the scan
    reads the same static score from K1's base."""
    fw = Framework.from_config()
    snap = _port_snapshot(name)
    ctx = CycleContext(snap)
    smask, sscore = fw.static_lean(ctx)
    smask = smask & sampling_mask(snap, 0)
    x = sb.static_base_inputs(fw, ctx, fit=True, sampling=sampling_window(snap, 0))
    sbase = sb.static_base_plain(x)
    live = sbase > sb.NEG_INF / 2
    assert float(sscore[smask].abs().max()) < 1e6
    assert torch.equal(sbase[live], sscore[live])
    # K1's fit test (cycle-start state) only removes what the scan's first
    # fit test removes
    fit0 = res.fit_mask(snap.pod_requested, snap.node_allocatable, snap.node_requested)
    assert torch.equal(live, smask & fit0)


def test_packed_operands_follow_the_snapshot():
    fw = Framework.from_config()
    snap = _port_snapshot("cfg4")
    x = _packed(fw, snap)
    assert x.flags == (sc.F_PORTS | sc.F_FIT | sc.F_AFFINITY | sc.F_SPREAD
                       | sc.F_PORT_STATE | sc.F_STATE | sc.F_TABLES)
    assert x.terms == ((sc.T_BALANCED, 1.0), (sc.T_AFFINITY, 1.0), (sc.T_FIT, 1.0),
                       (sc.T_SPREAD, 2.0))
    assert x.fit_w100[:2] == (100.0, 100.0) and x.fit_rwsum == 0.5
    assert x.bal_cols[:2] == (True, True) and not any(x.bal_cols[2:]) and x.bal_rn == 0.5
    mp = CycleContext(snap).matched_pending
    rebuilt = torch.zeros_like(mp.T)
    for p in range(snap.P):
        sel = x.sel_list[int(x.sel_ptr[p]):int(x.sel_ptr[p + 1])].long()
        assert torch.equal(sel, torch.sort(sel).values)
        rebuilt[p, sel] = True
    assert torch.equal(rebuilt, mp.T) and int(x.sel_ptr[-1]) == int(mp.sum())
    for k in range(snap.node_domains.shape[1]):
        doms = x.dom_list[int(x.dom_ptr[k]):int(x.dom_ptr[k + 1])].long()
        want = torch.nonzero((snap.domain_key == k) & (snap.domain_node_count > 0))[:, 0]
        assert torch.equal(doms, want)
    sel = snap.pod_aff_terms[..., 0]
    want_self = (sel >= 0) & mp.T.gather(1, sel.clamp(min=0).long())
    assert torch.equal(x.aff_self, want_self) and x.aff_self.any()
    assert sc.exact_range_bound(x) < sc.EXACT_F32
    assert torch.equal(x.order, torch.argsort(snap.pod_order, stable=True).to(I32))


@pytest.mark.parametrize("profile", ["three_resources", "four_resources"])
def test_packing_of_resource_means(profile):
    """K13's constants for resource scores averaged over three or four
    resources: the f32 reciprocals of the weight sum and of the resource
    count, and the bits that say the weights are all 1 and every resource
    is averaged (snapshot resources: cpu, memory, pods, ephemeral-storage)."""
    import k8s_scheduler_tpu_torch.config as port_config

    x = _packed(Framework.from_config(_profile(port_config, profile)), _port_snapshot("cfg4"))
    four = profile == "four_resources"
    assert x.fit_rwsum == x.bal_rn == float(np.float32(1) / np.float32(4 if four else 3))
    assert x.fit_w100 == (100.0, 100.0, 100.0 if four else 0.0, 100.0)
    assert x.bal_cols == (True, True, four, True)
    assert bool(x.flags & sc.F_FIT_ONES) == four == bool(x.flags & sc.F_BAL_ALL)


def test_packing_follows_the_profile():
    """MostAllocated sets the strategy bit; a profile without the affinity
    plugins packs no affinity terms; a plugin with per-pod hooks the kernel
    does not implement is refused."""
    snap = _port_snapshot("cfg4")
    most = SchedulerConfiguration(profiles=[Profile(plugin_config={
        "NodeResourcesFit": {"scoring_strategy": "MostAllocated"}})])
    x = _packed(Framework.from_config(most), snap)
    assert x.flags & sc.F_MOST
    fw = Framework.from_config()
    fw.filters = [f for f in fw.filters
                  if f.name not in ("InterPodAffinity", "PodTopologySpread")]
    fw.scores = [(s, w) for s, w in fw.scores
                 if s.name not in ("InterPodAffinity", "PodTopologySpread")]
    x = _packed(fw, snap)
    assert not x.flags & (sc.F_AFFINITY | sc.F_SPREAD | sc.F_STATE)
    assert [t for t, _ in x.terms] == [sc.T_BALANCED, sc.T_FIT]

    class Custom(PluginBase):
        name = "Custom"

        def dyn_mask(self, ctx, p, node_requested, extra):
            return None

    fw.filters.append(Custom())
    with pytest.raises(NotImplementedError, match="Custom"):
        _packed(fw, snap)


def test_cuda_wrapper_refuses_what_the_kernel_cannot_take():
    """The wrapper's limits hold before anything is launched (and without a
    card: the check precedes the build), each named in its error."""
    fw = Framework.from_config()
    x = _packed(fw, _port_snapshot("cfg3"))
    big = dataclasses.replace(x, tsc=torch.zeros((x.shape[0], sc.MAX_CONSTRAINTS + 1, 3),
                                                 dtype=I32))
    with pytest.raises(ValueError, match="limits"):
        sc.scan_commit_cuda(big)
    heavy = dataclasses.replace(x, pref_w=torch.full_like(x.pref_w, 2.0**20))
    with pytest.raises(ValueError, match="2\\^24"):
        sc.scan_commit_cuda(heavy)
    # the cluster's limits: 1024 nodes a CTA of 16 (8192 on the portable 8),
    # and a CTA's shared memory (the selector totals are replicated in it)
    wide = dataclasses.replace(x, sbase=torch.zeros((x.shape[0], sc.MAX_NODES + 1)))
    with pytest.raises(ValueError, match=f"at most {sc.MAX_NODES} on a cluster of 16"):
        sc.scan_commit_cuda(wide)
    with pytest.raises(ValueError, match=f"at most {sc.MAX_NODES_PORTABLE} on a cluster of 8"):
        sc.scan_commit_cuda(dataclasses.replace(
            x, sbase=torch.zeros((x.shape[0], sc.MAX_NODES_PORTABLE + 1))), cluster=8)
    many = dataclasses.replace(x, state=ip.AffinityState(
        torch.zeros((60000, 1)), torch.zeros(60000), x.state.anti_presence, x.state.pref_sym))
    with pytest.raises(ValueError, match=f"at most {sc.SMEM_LIMIT}"):
        sc.scan_commit_cuda(many)
