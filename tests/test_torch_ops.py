"""Each ported `ops/` and framework function against its reference, on a
snapshot carried across with `snapshot_from_numpy` (identical inputs).

The reference runs jitted, as it does in the cycle: XLA's compiled
arithmetic (fused multiply-adds, reassociated constants) is what the port
reproduces, weights closed over as constants where the cycle builds them
so. Every output, f32 scores included, is compared bit for bit."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k8s_scheduler_tpu.core.cycle as ref_cycle
import k8s_scheduler_tpu.framework.interfaces as ref_if
import k8s_scheduler_tpu.framework.runtime as ref_rt
import k8s_scheduler_tpu.ops.argsel as ref_argsel
import k8s_scheduler_tpu.ops.images as ref_images
import k8s_scheduler_tpu.ops.interpod as ref_interpod
import k8s_scheduler_tpu.ops.labels as ref_labels
import k8s_scheduler_tpu.ops.ports as ref_ports
import k8s_scheduler_tpu.ops.resources as ref_res
import k8s_scheduler_tpu.ops.rounds as ref_rounds
import k8s_scheduler_tpu.ops.taints as ref_taints
from k8s_scheduler_tpu_torch.core import cycle as port_cycle
from k8s_scheduler_tpu_torch.framework.interfaces import CycleContext
from k8s_scheduler_tpu_torch.framework.runtime import Framework
from k8s_scheduler_tpu_torch.models.encoding import AUX_FIELDS, snapshot_from_numpy
from k8s_scheduler_tpu_torch.ops import (
    argsel,
    capacity,
    claim_pass,
    guard_sweep,
    images,
    interpod,
    labels,
    ports,
    resources,
    rounds,
    taints,
)
from test_torch_commit import RESOURCE_PROFILES, _profile, sampling_mask
from test_torch_encoding import fixture, reference_snapshot
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", params=["mixed", "cfg2"])
def snaps(request):
    ref = reference_snapshot(request.param)
    port = snapshot_from_numpy(
        ref.array_fields(), {k: getattr(ref, k) for k in AUX_FIELDS}, device="cpu"
    )
    return ref, port


def _ref(fn, snap):
    return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(snap))


def _ref2(fn, snap, vsbase):
    """`fn(snap, vsbase)` jitted, vsbase an argument as the round passes it."""
    return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(snap, vsbase.numpy()))


def _valid_row(port):
    """A static base of zeros on the valid nodes, NEG_INF elsewhere."""
    row = torch.where(port.node_valid, 0.0, rounds.NEG_INF).to(torch.float32)
    return row[None, :].expand(port.P, port.N).contiguous()


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_exact(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def assert_scores(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["taint_tables", "taint_filter", "taint_score"])
def test_taints(snaps, case):
    ref, port = snaps
    if case == "taint_tables":
        want = _ref(ref_taints.toleration_tables, ref)
        got = taints.toleration_tables(port)
        assert_exact(got[0], want[0])
        assert_scores(got[1], want[1])
    elif case == "taint_filter":
        assert_exact(taints.taint_filter_mask(port),
                     _ref(ref_taints.taint_filter_mask, ref))
    else:
        assert_scores(taints.taint_score(port), _ref(ref_taints.taint_score, ref))


def test_pair_lookup(snaps):
    ref, port = snaps
    table = np.arange(12, dtype=np.float32).reshape(3, 4)
    rows = np.array([0, 2, 1, 5, -1], np.int32)
    cols = np.array([3, 0, 1, 2, 7, -2], np.int32)
    want = np.asarray(jax.jit(ref_taints._pair_lookup)(table, rows, cols))
    got = taints._pair_lookup(torch.from_numpy(table), torch.from_numpy(rows),
                              torch.from_numpy(cols))
    assert_exact(got, want)


@pytest.mark.parametrize("case", [
    "expr_node_mask", "requirement_mask", "pod_requirement_mask",
    "preferred_score", "take_rows",
])
def test_labels(snaps, case):
    ref, port = snaps
    em = labels.expr_node_mask(port)
    ref_em = _ref(ref_labels.expr_node_mask, ref)
    if case == "expr_node_mask":
        assert_exact(em, ref_em)
    elif case == "requirement_mask":
        assert_exact(labels.requirement_mask(port.rq_exprs, em),
                     jax.jit(ref_labels.requirement_mask)(ref.rq_exprs, ref_em))
    elif case == "pod_requirement_mask":
        assert_exact(labels.pod_requirement_mask(port, em),
                     jax.jit(ref_labels.pod_requirement_mask)(ref, ref_em))
    elif case == "preferred_score":
        assert_scores(labels.preferred_score(port, em),
                      jax.jit(ref_labels.preferred_score)(ref, ref_em))
    else:
        table = np.random.default_rng(0).random((5, 7)).astype(np.float32)
        ids = np.array([4, -1, 0, 2, 2, -1], np.int32)
        assert_scores(labels.take_rows(torch.from_numpy(table),
                                       torch.from_numpy(ids), 0.0),
                      jax.jit(ref_labels.take_rows, static_argnums=2)(table, ids, 0.0))
        bt = table > 0.5
        assert_exact(labels.take_rows(torch.from_numpy(bt), torch.from_numpy(ids), True),
                     jax.jit(ref_labels.take_rows, static_argnums=2)(bt, ids, True))


def test_expr_match_every_operator():
    """Gt/Lt on numeric and non-numeric labels, NotIn/DoesNotExist on
    absent keys, FIELD_IN, padding and OP_IMPOSSIBLE rows."""
    ex_key = np.array([1, 1, 2, 2, 3, 3, 0, 0, -1], np.int32)
    ex_op = np.array([0, 1, 2, 3, 4, 5, 6, 7, -1], np.int32)
    ex_vals = np.array([[10, 11], [10, -1], [-1, -1], [-1, -1], [-1, -1],
                        [-1, -1], [0, 2], [-1, -1], [-1, -1]], np.int32)
    ex_num = np.array([0, 0, 0, 0, 5.0, 5.0, 0, 0, 0], np.float32)
    keys = np.array([[1, 3, -1], [2, 3, -1], [1, 2, 3], [-1, -1, -1]], np.int32)
    vals = np.array([[10, 20, -1], [11, 21, -1], [12, 13, 22], [-1, -1, -1]], np.int32)
    num = np.array([[np.nan, 7.0, np.nan], [np.nan, 3.0, np.nan],
                    [np.nan, np.nan, np.nan], [np.nan] * 3], np.float32)
    idx = np.arange(4, dtype=np.int32)
    want = np.asarray(jax.jit(ref_labels.expr_match)(
        ex_key, ex_op, ex_vals, ex_num, keys, vals, num, idx))
    t = torch.from_numpy
    got = labels.expr_match(t(ex_key), t(ex_op), t(ex_vals), t(ex_num),
                            t(keys), t(vals), t(num), t(idx))
    assert_exact(got, want)


def test_images_and_ports(snaps):
    ref, port = snaps
    assert_scores(images.image_locality_score(port),
                  _ref(ref_images.image_locality_score, ref))
    assert_exact(
        ports.ports_conflict_mask(port.pod_ports, port.node_used_ports),
        jax.jit(ref_ports.ports_conflict_mask)(ref.pod_ports, ref.node_used_ports),
    )


def test_interpod_selectors(snaps):
    ref, port = snaps
    assert_exact(interpod.matched_pending(port), _ref(ref_interpod.matched_pending, ref))
    want = _ref(ref_interpod.selector_activity, ref)
    got = interpod.selector_activity(port)
    assert_exact(got[0], want[0])
    assert_exact(got[1], want[1])


def _resource_inputs(kind):
    rng = np.random.default_rng(7)
    P, N = 48, 64
    if kind == "dyadic":  # synth-like: exact fractions
        alloc = np.stack([rng.choice([4000, 8000, 16000], N),
                          rng.choice([16, 32, 64], N) * 2.0**30,
                          np.full(N, 110.0), np.zeros(N)], 1)
        nreq = np.stack([rng.integers(0, 20, N) * 250.0,
                         rng.integers(0, 40, N) * 2.0**28,
                         rng.integers(0, 20, N) * 1.0, np.zeros(N)], 1)
        preq = np.stack([rng.integers(1, 16, P) * 250.0,
                         rng.integers(1, 16, P) * 2.0**28,
                         np.ones(P), np.zeros(P)], 1)
    else:  # arbitrary f32 quantities
        alloc = rng.random((N, 4)) * 1e4
        nreq = rng.random((N, 4)) * 5e3
        preq = rng.random((P, 4)) * 3e3
    return [x.astype(np.float32) for x in (preq, alloc, nreq)]


@pytest.mark.parametrize("kind", ["dyadic", "arbitrary"])
@pytest.mark.parametrize("fn", [
    "least_requested_score", "balanced_allocation_score", "most_requested_score",
])
def test_resource_scores(kind, fn):
    preq, alloc, nreq = _resource_inputs(kind)
    w = np.array([1, 1, 0, 0], np.float32)
    want = jax.jit(getattr(ref_res, fn))(preq[:, None, :], alloc, nreq, w)
    t = torch.from_numpy
    got = getattr(resources, fn)(t(preq)[:, None, :], t(alloc), t(nreq), tuple(w.tolist()))
    assert_scores(got, want)
    # zero-pod anchor form ([N] per node)
    want0 = jax.jit(getattr(ref_res, fn))(np.zeros((1, 1), np.float32), alloc, nreq, w)
    got0 = getattr(resources, fn)(torch.zeros((1, 1)), t(alloc), t(nreq), tuple(w.tolist()))
    assert_scores(got0, want0)


@pytest.mark.parametrize("kind", ["dyadic", "arbitrary"])
@pytest.mark.parametrize("w", [(1, 1, 0, 1), (1, 1, 1, 1), (1, 0, 1, 0)])
@pytest.mark.parametrize("fn", [
    "least_requested_score", "balanced_allocation_score", "most_requested_score",
])
def test_resource_scores_constant_weights(kind, w, fn):
    """The weights as the cycle builds them, constants of the compiled
    program: XLA multiplies by the f32 reciprocal of the weight sum and of
    the resource count, and folds a weight vector of ones (ROADMAP C1)."""
    preq, alloc, nreq = _resource_inputs(kind)
    wc = np.array(w, np.float32)
    ref_fn = jax.jit(lambda a, b, c: getattr(ref_res, fn)(a, b, c, wc))
    t = torch.from_numpy
    got = getattr(resources, fn)(t(preq)[:, None, :], t(alloc), t(nreq), tuple(wc.tolist()))
    assert_scores(got, ref_fn(preq[:, None, :], alloc, nreq))


@pytest.mark.parametrize("profile", list(RESOURCE_PROFILES))
def test_dyn_batched_resource_means(profile):
    """`dyn_batched` and `score_anchor` under a profile that averages the
    resource scores over three or four resources, on ROADMAP C1's seeded
    input: bit-equal, where dividing by the weight sum was up to 2 ulp off."""
    import k8s_scheduler_tpu.config as ref_config
    import k8s_scheduler_tpu.models as ref_models
    import k8s_scheduler_tpu.utils.synth as ref_synth
    import k8s_scheduler_tpu_torch.config as port_config

    nodes, pods, existing, groups = fixture("c1", ref_models, ref_synth)
    ref = ref_models.SnapshotEncoder().encode(nodes, pods, existing, groups)
    port = snapshot_from_numpy(
        ref.array_fields(), {k: getattr(ref, k) for k in AUX_FIELDS}, device="cpu"
    )
    rfw = ref_rt.Framework.from_config(_profile(ref_config, profile))
    pfw = Framework.from_config(_profile(port_config, profile))

    def ref_dyn(s, vsbase):
        c = ref_if.CycleContext(s)
        m, sc, _ = rfw.dyn_batched(c, s.node_requested, rfw.extra_init(c),
                                   vsbase > rounds.NEG_INF * 0.5)
        return m, vsbase + sc, rfw.score_anchor(c, s.node_requested)

    vsbase = _valid_row(port)
    wm, wb, wa = _ref2(ref_dyn, ref, vsbase)
    ctx = CycleContext(port)
    gm, gb = pfw.dyn_batched(ctx, port.node_requested, pfw.extra_init(ctx), vsbase)
    assert_exact(gm, wm)
    assert_scores(gb, wb)  # a lone product fused into the add, as jit does
    assert_scores(pfw.score_anchor(ctx, port.node_requested), wa)


@pytest.mark.parametrize("kind", ["dyadic", "arbitrary"])
def test_fit_masks(kind):
    preq, alloc, nreq = _resource_inputs(kind)
    t = torch.from_numpy
    assert_exact(resources.fit_mask(t(preq), t(alloc), t(nreq)),
                 jax.jit(ref_res.fit_mask)(preq, alloc, nreq))
    for p in range(4):
        assert_exact(resources.fit_mask_single(t(preq[p]), t(alloc), t(nreq)),
                     jax.jit(ref_res.fit_mask_single)(preq[p], alloc, nreq))


def test_argsel():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, (50, 33)).astype(np.float32)  # many ties
    for axis in (0, 1, -1):
        assert_exact(argsel.argmax_first(torch.from_numpy(x), dim=axis),
                     jax.jit(ref_argsel.argmax_first, static_argnums=1)(x, axis))
    assert argsel.index_dtype(100) == torch.int16
    assert argsel.index_dtype(2**15) == torch.int32
    assert ref_argsel.index_dtype(100) == jnp.int16


def test_tie_break_wraps_like_u32():
    gid = np.array([0, 1, 7, 9999, 2**20 + 3, 2**31 - 1], np.int32)
    want = np.asarray(jax.jit(ref_rounds._tie_break, static_argnums=1)(gid, 300))
    assert_exact(claim_pass.tie_break(torch.from_numpy(gid), 300), want)


def test_rounds_helpers():
    rng = np.random.default_rng(5)
    m = rng.random((9, 40)) < 0.3
    active = rng.random(9) < 0.6
    want = jax.jit(ref_rounds._matched_active, static_argnums=2)(m, active, 4)
    got = rounds._matched_active(torch.from_numpy(m), torch.from_numpy(active), 4)
    assert_exact(got[0], want[0])
    assert_exact(got[1], want[1])
    keys = np.sort(rng.integers(0, 5, 60)).astype(np.int32)
    pods = rng.integers(0, 20, 60).astype(np.int32)
    cols = {"a": rng.integers(0, 2, 60).astype(np.int32),
            "b": rng.integers(0, 2, 60).astype(np.int32)}
    want = jax.jit(ref_rounds._seg_scan_tables)(keys, pods, cols)
    got = guard_sweep.seg_scan_tables(torch.from_numpy(keys), torch.from_numpy(pods),
                                  {k: torch.from_numpy(v) for k, v in cols.items()})
    for k in cols:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for P in (8, 256, 1000, 10000, 16384):
        assert rounds.compact_window(P) == ref_rounds.compact_window(P)


def test_index_add_exact():
    rng = np.random.default_rng(2)
    target = (rng.integers(0, 50, (6, 3)) * 250.0).astype(np.float32)
    idx = rng.integers(0, 6, 40).astype(np.int32)
    rows = (rng.integers(1, 16, (40, 3)) * 250.0).astype(np.float32)
    want = np.asarray(jnp.asarray(target).at[idx].add(rows))
    got = capacity.index_add_exact(torch.from_numpy(target), torch.from_numpy(idx),
                                 torch.from_numpy(rows))
    assert_exact(got, want)


@pytest.mark.parametrize("pct", [0, 30, 100])
def test_sampling_mask(pct):
    ref = reference_snapshot("cfg2")  # 100 nodes: the floor makes 0 == all
    for r in (ref, _wide_reference()):
        port = snapshot_from_numpy(
            r.array_fields(), {k: getattr(r, k) for k in AUX_FIELDS}, device="cpu"
        )
        want = jax.jit(ref_cycle.sampling_mask, static_argnums=1)(r, pct)
        assert_exact(sampling_mask(port, pct), want)


def _wide_reference():
    import k8s_scheduler_tpu.models as rm
    import k8s_scheduler_tpu.utils.synth as rs

    return rm.SnapshotEncoder().encode(rs.make_cluster(260), rs.make_pods(70, seed=9))


def test_framework_static_and_dynamic(snaps):
    ref, port = snaps
    rfw = ref_rt.Framework.from_config()
    pfw = Framework.from_config()
    ctx = CycleContext(port)
    want_mask, want_score = _ref(lambda s: rfw.static_lean(ref_if.CycleContext(s)), ref)
    got_mask, got_score = pfw.static_lean(ctx)
    assert_exact(got_mask, want_mask)
    assert_scores(got_score, want_score)

    extra = pfw.extra_init(ctx)
    assert sorted(extra) == ["NodePorts"]

    def ref_dyn(s, vsbase):
        c = ref_if.CycleContext(s)
        ext = rfw.extra_init(c)
        m, sc, _ = rfw.dyn_batched(c, s.node_requested, ext, vsbase > rounds.NEG_INF * 0.5)
        return m, vsbase + sc, rfw.score_anchor(c, s.node_requested)

    vsbase = _valid_row(port)
    wm, wb, wa = _ref2(ref_dyn, ref, vsbase)
    gm, gb = pfw.dyn_batched(ctx, port.node_requested, extra, vsbase)
    assert_exact(gm, wm)
    assert_scores(gb, wb)
    assert_scores(pfw.score_anchor(ctx, port.node_requested), wa)


def test_nodeports_state_update(snaps):
    ref, port = snaps
    rfw = ref_rt.Framework.from_config()
    pfw = Framework.from_config()
    rng = np.random.default_rng(11)
    accepted = rng.random(ref.P) < 0.5
    node_of = rng.integers(0, ref.N, ref.P).astype(np.int32)

    def ref_update(s):
        c = ref_if.CycleContext(s)
        return rfw.extra_update_batched(c, rfw.extra_init(c), accepted, node_of)

    want = _ref(ref_update, ref)
    ctx = CycleContext(port)
    got = pfw.extra_update_batched(ctx, pfw.extra_init(ctx),
                                   torch.from_numpy(accepted), torch.from_numpy(node_of))
    assert_exact(got["NodePorts"], want["NodePorts"])


@pytest.mark.parametrize("seed", range(4))
def test_expr_match_random_tables_match_reference(seed):
    """`labels.expr_match` (interned (key, value) lookups) against the
    reference's dense [Ex, X, ML, MV] comparison on random tables with every
    operator, duplicate keys on one subject, negative values, numeric and
    non-numeric labels, field matches and padding rows: bit-equal."""
    from k8s_scheduler_tpu_torch.ops import labels as port_labels

    rng = np.random.default_rng(seed)
    Ex, X, ML, MV = 300, 70, 6, 4
    keys = rng.integers(-1, 9, (X, ML)).astype(np.int32)
    vals = rng.integers(-1, 12, (X, ML)).astype(np.int32)
    nums = np.where(rng.random((X, ML)) < 0.6, rng.integers(-5, 20, (X, ML)),
                    np.nan).astype(np.float32)
    ex_key = rng.integers(-1, 10, Ex).astype(np.int32)
    ex_op = rng.integers(0, 8, Ex).astype(np.int32)
    ex_vals = rng.integers(-1, 13, (Ex, MV)).astype(np.int32)
    ex_num = rng.integers(-5, 20, Ex).astype(np.float32)
    subj = np.arange(X, dtype=np.int32)
    args = (ex_key, ex_op, ex_vals, ex_num, keys, vals, nums, subj)
    want = np.asarray(jax.jit(ref_labels.expr_match)(*[jnp.asarray(a) for a in args]))
    got = port_labels.expr_match(*[torch.from_numpy(a) for a in args]).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size
    got_pods = port_labels.expr_match(*[torch.from_numpy(a) for a in args[:6]]).numpy()
    want_pods = np.asarray(jax.jit(ref_labels.expr_match)(*[jnp.asarray(a) for a in args[:6]]))
    np.testing.assert_array_equal(got_pods, want_pods)
