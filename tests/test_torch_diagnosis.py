"""The port's full cycle outputs and diagnosis program against the
reference's (ROADMAP A9), every comparison exact (integers, floats by
their bits), inputs made with numpy from a seed or by the synth generators:

- `Framework.attribute_rejects` with None entries and `rows`;
  `Framework.static`'s (mask, score, rejects);
- K16's and K17's plain versions (`static_rejects_plain`,
  `dyn_rejects_plain`) on their seeded edge cases
  (`utils/kernel_cases.static_reject_cases`, `dyn_reject_cases`) against
  the reference's attribution over the same per-filter masks; K16's
  survivors plane against K1's mask without fit and sampling;
- `scan_commit_plain`'s full outputs (the per-step rejects) against the
  reference's `greedy_commit` with its framework's per-pod hooks on K13's
  edge cases;
- `build_cycle_fn(outputs="full")` in both engines against the
  reference's on every `CycleResult` field over all P rows (cfg1, config
  #4's mix at 48 nodes, a volumes fixture in the rounds engine, a sampled
  cluster of 300 nodes: the one mid-size case), and its decisions against
  the latency outputs';
- `build_diagnosis_fn` against the reference's on packed frames whose
  unplaced pods outnumber the window and the last window, clamped to end
  at P, overlaps the one before: 120 pods with affinity on 3 nodes, and
  config #4's mix with volumes at 24 nodes; `failed_scheduling_message`
  on its rows; each window's start mask, K16's survivors plane, against
  K1's mask without fit and sampling.

Each reference program is built and run once per module."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k8s_scheduler_tpu.config as ref_config
import k8s_scheduler_tpu.core.cycle as ref_cycle
import k8s_scheduler_tpu.core.events as ref_events
import k8s_scheduler_tpu.framework.runtime as ref_runtime
import k8s_scheduler_tpu.models as ref_models
import k8s_scheduler_tpu.ops.commit as ref_commit
import k8s_scheduler_tpu.utils.synth as ref_synth
import k8s_scheduler_tpu_torch.models as port_models
import k8s_scheduler_tpu_torch.utils.synth as port_synth
from k8s_scheduler_tpu.framework.interfaces import CycleContext as RefContext
from k8s_scheduler_tpu_torch import config as port_config
from k8s_scheduler_tpu_torch.core import cycle as port_cycle
from k8s_scheduler_tpu_torch.core.events import failed_scheduling_message
from k8s_scheduler_tpu_torch.framework.interfaces import CycleContext
from k8s_scheduler_tpu_torch.framework.runtime import Framework
from k8s_scheduler_tpu_torch.models.encoding import AUX_FIELDS, snapshot_from_numpy
from k8s_scheduler_tpu_torch.ops import dyn_round, scan_commit, static_base
from k8s_scheduler_tpu_torch.utils import kernel_cases
from test_torch_carry import _churn_pods
from test_torch_cycle import _sampled
from test_torch_encoding import fixture
from test_torch_volumes import PORT, REF, _cfg4_volumes, objects
from torch_one_thread import one_torch_thread  # noqa: F401

RESULT = ("assignment", "node_requested", "unschedulable", "gang_dropped", "reject_counts",
          "pv_claimed", "rounds_used", "accepted_per_round", "diag_per_round")
DECISION = ("assignment", "node_requested", "unschedulable", "gang_dropped", "placed_round")


def _np(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(got, want, msg) -> None:
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype and g.shape == w.shape, msg
    np.testing.assert_array_equal(g, w, err_msg=msg)


def _port(ref_snap):
    return snapshot_from_numpy(ref_snap.array_fields(),
                               {k: getattr(ref_snap, k) for k in AUX_FIELDS}, device="cpu")


_REF_FW = ref_runtime.Framework([], [])  # attribute_rejects reads no plugin


def _small_volumes(m):
    """config #4's workload with `config4_volumes`' draw at 24 nodes, 96
    running and 200 pending pods (most of them left unplaced)."""
    nodes, pods, pvcs, pvs, classes, groups, existing = _cfg4_volumes(m, 24, 96, 200)
    return nodes, pods, existing, groups, dict(pvcs=pvcs, pvs=pvs, storage_classes=classes)


# ---- the attribution chain ---------------------------------------------------


@pytest.mark.parametrize("rows", ["none", "seeded", "all false"])
def test_attribute_rejects_matches_reference(rows):
    rng = np.random.default_rng(1418)
    P, N = 24, 37
    base = rng.random((P, N)) < 0.9
    masks = [rng.random((P, N)) < 0.8 if k not in (1, 4) else None for k in range(6)]
    r = {"none": None, "seeded": rng.random(P) < 0.5, "all false": np.zeros(P, bool)}[rows]
    want = _REF_FW.attribute_rejects(
        jnp.asarray(base), [None if m is None else jnp.asarray(m) for m in masks],
        None if r is None else jnp.asarray(r))
    got = Framework([], []).attribute_rejects(
        torch.from_numpy(base), [None if m is None else torch.from_numpy(m) for m in masks],
        None if r is None else torch.from_numpy(r))
    _eq(got, want, "rejects")
    assert int(got.sum()) > 0 or rows == "all false"


@functools.lru_cache(maxsize=None)
def _static_snapshot(name):
    if name == "volumes":
        nodes, pods, existing, groups, vol = _small_volumes(REF)
        return ref_models.SnapshotEncoder().encode(nodes, pods, existing, groups, **vol)
    if name == "k1":
        return ref_models.SnapshotEncoder().encode(*kernel_cases.k1_objects(ref_models))
    nodes, pods, existing, groups = fixture(name, ref_models, ref_synth)
    return ref_models.SnapshotEncoder().encode(nodes, pods, existing, groups)


@pytest.mark.parametrize("name", ["k1", "cfg4", "volumes"])
def test_framework_static_matches_reference(name):
    """Every static filter's mask, the weighted static score and the
    first-rejector counts (K16's plain version here) of `Framework.static`."""
    ref_snap = _static_snapshot(name)
    ref_fw = ref_runtime.Framework.from_config()
    want = jax.jit(lambda s: ref_fw.static(RefContext(s)))(ref_snap)
    got = Framework.from_config().static(CycleContext(_port(ref_snap)))
    for g, w, what in zip(got, want, ("mask", "score", "rejects")):
        _eq(g, w, what)
    assert int(got[2].sum()) > 0


# the edge cases, built once a module (no test changes them)
_static_cases = functools.lru_cache(maxsize=None)(kernel_cases.static_reject_cases)
_dyn_cases = functools.lru_cache(maxsize=None)(kernel_cases.dyn_reject_cases)


def _ref_chain(base, per_filter, rows):
    return np.asarray(_REF_FW.attribute_rejects(
        jnp.asarray(base.numpy()),
        [None if m is None else jnp.asarray(m.numpy()) for m in per_filter],
        None if rows is None else jnp.asarray(rows.numpy())))


@pytest.mark.parametrize("tag", kernel_cases.STATIC_REJECT_TAGS)
def test_static_rejects_plain_matches_reference_chain(tag):
    """K16's plain version: each static filter's mask from the inputs'
    tables at its column (None where a filter has none), chained from
    node_valid by the reference's `attribute_rejects`."""
    x, rows = _static_cases()[tag]
    P, N = x.shape
    masks = static_base._filter_masks(x)
    per_filter = [None] * x.n_filters
    for (_, bit), col in zip(static_base.REJECT_TESTS, x.columns):
        if col >= 0 and bit in masks:
            per_filter[col] = masks[bit]
    want = _ref_chain(x.node_valid[None, :].expand(P, N), per_filter, rows)
    got = static_base.static_rejects_plain(x, rows)
    _eq(got, want, tag)
    if tag == "every node rejected by the first filter":
        assert (got[:, 1:] == 0).all() and (got[:, 0] == x.node_valid.sum()).all()


@pytest.mark.parametrize("tag", kernel_cases.STATIC_REJECT_TAGS)
def test_static_rejects_plain_survivors_match_static_base(tag):
    """K16's survivors plane in plain torch: the chain's remainder over every
    row, whatever `rows` says, equals K1's mask without fit and sampling
    (the diagnosis program's former start mask), and the counts are those
    without the plane."""
    x, rows = _static_cases()[tag]
    counts, surv = static_base.static_rejects_plain(x, rows, survivors=True)
    _eq(surv, static_base.static_base_plain(x) > static_base.NEG_INF / 2, tag)
    _eq(counts, static_base.static_rejects_plain(x, rows), tag)
    got = static_base.static_rejects(x, rows, True)
    _eq(got[0], counts, tag)
    _eq(got[1], surv, tag)


@pytest.mark.parametrize("tag", kernel_cases.DYN_REJECT_TAGS)
def test_dyn_rejects_plain_matches_reference_chain(tag):
    """K17's plain version: each dynamic part's mask (K14's plain part
    arithmetic) at its column, chained from the start mask by the
    reference's `attribute_rejects`."""
    start, parts, F, rows = _dyn_cases()[tag]
    per_filter = [None] * F
    for col, part in parts:
        per_filter[col] = dyn_round._plain_part(part)
    want = _ref_chain(start, per_filter, rows)
    got = dyn_round.dyn_rejects_plain(start, parts, F, rows)
    _eq(got, want, tag)
    if tag == "a start mask all false" or tag == "rows all false":
        assert not got.any()


# ---- the scan's per-step attribution ------------------------------------------

SCAN_TAGS = ("N=13", "no feasible node", "hard spread, minimum in another slice's zone",
             "anti-affinity written by one pod and read by the next",
             "host-port conflicts between consecutive pods", "pad pods interleaved in order")


@pytest.mark.parametrize("tag", SCAN_TAGS)
def test_scan_full_rejects_match_reference_greedy_commit(tag):
    """`scan_commit_plain` on a K13 edge case's full inputs: the decisions
    and the per-step rejects (`dyn_aux`, pad rows and interleaved pads
    included) of the reference's greedy_commit with its framework's hooks."""
    from test_torch_kernels_plain import _carry

    nodes, pods, existing, opts = kernel_cases.scan_objects(ref_models, (tag,))[tag]
    ref = kernel_cases.prepare(ref_models.SnapshotEncoder().encode(nodes, pods, existing),
                               opts)
    x = kernel_cases.scan_inputs(_carry(ref), opts, full=True)
    fw = ref_runtime.Framework.from_config(kernel_cases.scan_profile(ref_config,
                                                                    opts.get("profile")))

    def run(snap, order, sbase):
        ctx = RefContext(snap)
        ctx.matched_pending
        return ref_commit.greedy_commit(
            order=order, static_mask=sbase > scan_commit.NEG_INF / 2, static_score=sbase,
            pod_requested=snap.pod_requested, pod_valid=snap.pod_valid,
            pod_nominated=snap.pod_nominated, node_allocatable=snap.node_allocatable,
            node_requested=snap.node_requested,
            dyn_fn=lambda p, nr, ext, row: fw.dyn(ctx, p, nr, ext, row),
            extra=fw.extra_init(ctx),
            update_fn=lambda ext, p, node, ok: fw.extra_update(ctx, ext, p, node, ok))

    want = jax.jit(run)(ref, jnp.asarray(x.order.numpy()), jnp.asarray(x.sbase.numpy()))
    got = scan_commit.scan_commit_plain(x)
    _eq(got.assignment, want.assignment, "assignment")
    _eq(got.node_requested, want.node_requested, "node_requested")
    _eq(got.rejects, want.dyn_aux, "rejects")


# ---- the full cycle --------------------------------------------------------------


def _cycle_objects(name):
    if name == "sampled":
        return _sampled(ref_synth)
    if name == "volumes":
        return objects("contending", REF)
    return fixture(name, ref_models, ref_synth) + ({},)


CYCLE_CASES = [("rounds", "cfg1"), ("scan", "cfg1"), ("rounds", "cfg4"), ("scan", "cfg4"),
               ("rounds", "volumes"), ("rounds", "sampled"), ("scan", "sampled")]


@functools.lru_cache(maxsize=None)
def _full_cycle(engine, name):
    nodes, pods, existing, groups, *vol = _cycle_objects(name)
    vol = vol[0] if vol else {}
    ref_snap = ref_models.SnapshotEncoder().encode(nodes, pods, existing, groups, **vol)
    want = ref_cycle.build_cycle_fn(commit_mode=engine)(ref_snap)
    snap = _port(ref_snap)
    got = port_cycle.build_cycle_fn(commit_mode=engine, device="cpu")(snap)
    lean = port_cycle.build_cycle_fn(commit_mode=engine, outputs="latency",
                                     device="cpu")(snap)
    return want, got, lean


@pytest.mark.parametrize("engine,name", CYCLE_CASES)
def test_full_cycle_matches_reference(engine, name):
    want, got, lean = _full_cycle(engine, name)
    assert isinstance(got, port_cycle.CycleResult)
    for f in RESULT:
        _eq(getattr(got, f), getattr(want, f), f)
    assert int(got.reject_counts.sum()) > 0 or name == "cfg1"
    if engine == "rounds":  # acceptances before the gang unwind
        placed = int((got.assignment >= 0).sum() + got.gang_dropped.sum())
        assert int(got.accepted_per_round.sum()) == placed
        assert int(got.rounds_used) >= 1 and int(got.diag_per_round[0, 0]) >= placed


@pytest.mark.parametrize("engine,name", CYCLE_CASES)
def test_full_and_latency_outputs_decide_alike(engine, name):
    """The reference's tests/test_pipeline.py contract: the full outputs'
    decisions are the latency outputs'."""
    _, got, lean = _full_cycle(engine, name)
    assert isinstance(lean, port_cycle.CycleDecision)
    for f in DECISION:
        _eq(getattr(got, f), getattr(lean, f), f)


# ---- the diagnosis program --------------------------------------------------------


def _diagnosis_objects(name, m, synth):
    if name == "volumes":
        return _small_volumes(m)
    existing = [(p, f"node-{i % 3}") for i, p in enumerate(
        synth.make_pods(20, seed=2, name_prefix="run", affinity_fraction=0.2, num_apps=6))]
    return synth.make_cluster(3), _churn_pods(synth, 120, 1), existing, [], {}


@functools.lru_cache(maxsize=None)
def _diagnosis(name, window):
    """Both packages on one packed frame: the carry cycle from a fresh
    carry_init, then the diagnosis program fed its outputs."""
    nodes, pods, existing, groups, vol = _diagnosis_objects(name, REF, ref_synth)
    w, b, spec, _snap, _dirty = ref_models.SnapshotEncoder().encode_packed(
        nodes, pods, existing, groups, vol.get("pvcs", ()), vol.get("pvs", ()),
        vol.get("storage_classes", ()))
    stable = ref_cycle.build_stable_state_fn(spec)(w, b)
    carry = ref_cycle.build_carry_fns(spec)[0](w, b, stable)
    want_cycle = ref_cycle.build_packed_cycle_carry_fn(spec)(w, b, stable, carry)
    want = ref_cycle.build_diagnosis_fn(spec, window=window)(
        w, b, stable, want_cycle.assignment, want_cycle.node_requested, want_cycle.pv_claimed)
    nodes, pods, existing, groups, vol = _diagnosis_objects(name, PORT, port_synth)
    frame = port_models.SnapshotEncoder(device="cpu").encode_packed(
        nodes, pods, existing, groups, **vol)
    pstable = port_cycle.build_stable_state_fn(frame.spec, device="cpu")(frame.wbuf, frame.bbuf)
    carry = port_cycle.build_carry_fns(frame.spec, device="cpu")[0](
        frame.wbuf, frame.bbuf, pstable)
    cyc = port_cycle.build_packed_cycle_carry_fn(frame.spec, device="cpu")(
        frame.wbuf, frame.bbuf, pstable, carry)

    def run(**kernels):
        return port_cycle.build_diagnosis_fn(frame.spec, window=window, device="cpu",
                                             **kernels)(
            frame.wbuf, frame.bbuf, pstable, cyc.assignment, cyc.node_requested,
            cyc.pv_claimed)

    return want_cycle, want, cyc, run(), frame.snap, run


DIAGNOSIS = [("churn", 70), ("volumes", 140)]


@pytest.mark.parametrize("name,window", DIAGNOSIS)
def test_diagnosis_matches_reference(name, window):
    want_cycle, want, cyc, got, snap, _ = _diagnosis(name, window)
    _eq(cyc.assignment, want_cycle.assignment, "assignment")
    _eq(got, want, "rejects")
    unplaced = (snap.pod_valid & (cyc.assignment < 0)).numpy()
    n_un = int(unplaced.sum())
    windows = -(-n_un // window)
    assert windows >= 2 and windows * window > snap.P  # the last window is clamped: overlap
    g = got.numpy()
    assert (g[~unplaced] == 0).all() and (g[unplaced].sum(axis=1) > 0).all()


@pytest.mark.parametrize("name,window", DIAGNOSIS)
def test_failed_scheduling_message_matches_reference(name, window):
    _, want, cyc, got, snap, _ = _diagnosis(name, window)
    names = Framework.from_config().filter_names
    assert names == ref_runtime.Framework.from_config().filter_names
    rows = np.flatnonzero((snap.pod_valid & (cyc.assignment < 0)).numpy())
    n = int(snap.num_nodes)
    for p in rows:
        pairs_got = list(zip(names, got[p].tolist()))
        pairs_want = list(zip(names, np.asarray(want)[p].tolist()))
        assert failed_scheduling_message(n, pairs_got) == \
            ref_events.failed_scheduling_message(n, pairs_want)
    assert failed_scheduling_message(n, [(names[0], 0)]) == \
        ref_events.failed_scheduling_message(n, [(names[0], 0)])


@pytest.mark.parametrize("name,window", DIAGNOSIS)
def test_diagnosis_start_mask_is_the_static_survivors(name, window):
    """Each window's start mask is K16's survivors plane: on every window it
    equals K1's mask without fit and sampling (`static_base_plain(x) >
    NEG_INF / 2`, the start mask the program built before), and the program
    stays bit-equal to the reference's."""
    _, want, _, _, _, run = _diagnosis(name, window)
    windows = []

    def static_rejects(x, rows=None, survivors=False):
        assert survivors
        counts, surv = static_base.static_rejects_plain(x, rows, survivors)
        _eq(surv, static_base.static_base_plain(x) > static_base.NEG_INF / 2, "start mask")
        windows.append(int(rows.sum()))
        return counts, surv

    _eq(run(static_rejects_fn=static_rejects), want, "rejects")
    assert len(windows) >= 2 and all(n > 0 for n in windows)


def test_diagnosis_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        port_cycle.build_diagnosis_fn(None, extender_args=True, device="cpu")
    with pytest.raises(ValueError):
        port_cycle.build_cycle_fn(outputs="diagnosis", device="cpu")


def test_filter_names_follow_the_configuration():
    prof = port_config.SchedulerConfiguration(profiles=[port_config.Profile(
        plugins=port_config.Plugins(filter=port_config.PluginSet(
            disabled=["*"], enabled=[port_config.PluginEntry("NodePorts"),
                                     port_config.PluginEntry("NodeName")])))])
    assert Framework.from_config(prof).filter_names == ["NodePorts", "NodeName"]
