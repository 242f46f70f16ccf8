"""The reference's serving-pipeline contracts (tests/test_pipeline.py), run
against the port's `ServingPipeline` and `Scheduler` on the CPU.

- the slim decision fetch equals the full result, and cycle k+1 may not
  dispatch before cycle k's decisions were fetched;
- the decision slimming round-trips (i16 when N < 2^15, i32 above);
- a donated diagnosis consumes the slot's buffers and refuses a
  preemption consumer;
- the CPU arena guard: a deferred program dispatched on the raw host
  arena reads its own cycle's bytes after the next encode rewrote them;
- cycle k's binds fold into the cache before cycle k+1's encode;
- forced_sync binds exactly as the async path does;
- an expired dispatch deadline raises `DispatchDeadlineExceeded`, consumes
  the cycle, requeues its pods with backoff and steps the degradation
  ladder."""

from __future__ import annotations

import time

import numpy as np
import pytest

from k8s_scheduler_tpu_torch.config import SchedulerConfiguration
from k8s_scheduler_tpu_torch.core import (Scheduler, ServingPipeline,
                                          build_decision_slim_fn)
from k8s_scheduler_tpu_torch.core.cycle import (build_diagnosis_fn,
                                                build_packed_cycle_fn,
                                                build_stable_state_fn)
from k8s_scheduler_tpu_torch.core.degrade import RUNG_RETRACE
from k8s_scheduler_tpu_torch.core.pipeline import DispatchDeadlineExceeded
from k8s_scheduler_tpu_torch.models import MakeNode, MakePod, SnapshotEncoder
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = "cpu"


def _frame(pods=4, huge=False):
    nodes = [MakeNode(f"n{i}").capacity({"cpu": "4"}).obj() for i in range(3)]
    ps = [MakePod(f"p{i}").req({"cpu": "1"}).obj() for i in range(pods)]
    if huge:
        ps.append(MakePod("huge").req({"cpu": "64"}).obj())
    enc = SnapshotEncoder(device=CPU, pad_pods=8, pad_nodes=4)
    return enc, enc.encode_packed(nodes, ps)


def test_decision_slim_fetch_roundtrip():
    rng = np.random.default_rng(7)
    P, N = 64, 1000
    assignment = rng.integers(-1, N, size=P).astype(np.int32)
    unsched = rng.random(P) < 0.3
    dropped = rng.random(P) < 0.2
    a, flags = build_decision_slim_fn(N)(assignment, unsched, dropped)
    assert a.dtype == np.int16 and flags.dtype == np.uint8
    np.testing.assert_array_equal(a.astype(np.int32), assignment)
    np.testing.assert_array_equal((flags & 1) != 0, unsched)
    np.testing.assert_array_equal((flags & 2) != 0, dropped)
    a32, _ = build_decision_slim_fn(1 << 15)(assignment, unsched, dropped)
    assert a32.dtype == np.int32  # a node axis too wide for i16 keeps i32


def test_pipeline_ordering_guard_and_slim_matches_result():
    _, (w, b, spec, _snap, _dirty) = _frame()
    cyc = build_packed_cycle_fn(spec, commit_mode="scan", device=CPU)
    stable = build_stable_state_fn(spec, device=CPU)(w, b)
    pipe = ServingPipeline(cyc, device=CPU)
    h1 = pipe.dispatch(w, b, stable, device_put=False)
    with pytest.raises(RuntimeError, match="decisions were fetched"):
        pipe.dispatch(w, b, stable, device_put=False)
    assignment, unsched, dropped = h1.decisions()
    np.testing.assert_array_equal(assignment, h1.result.assignment.numpy())
    np.testing.assert_array_equal(unsched, h1.result.unschedulable.numpy())
    np.testing.assert_array_equal(dropped, h1.result.gang_dropped.numpy())
    assert 0 < pipe.stats["fetch_bytes"] < pipe.stats["fetch_bytes_full"]
    h2 = pipe.dispatch(w, b, stable, device_put=False)  # slot reuse
    np.testing.assert_array_equal(h2.decisions()[0], assignment)
    pipe2 = ServingPipeline(cyc, require_decision_fetch=False, device=CPU)
    pipe2.dispatch(w, b, stable, device_put=False)
    pipe2.dispatch(w, b, stable, device_put=False).decisions()


def test_donate_diagnosis_refuses_preemption_consumer():
    with pytest.raises(ValueError, match="donate_diagnosis"):
        ServingPipeline(lambda *a: None, diag_fn=lambda *a: None,
                        preempt_fn=lambda *a: None, donate_diagnosis=True)


def test_donated_diagnosis_consumes_slot_buffers():
    _, (w, b, spec, _snap, _dirty) = _frame(pods=3, huge=True)
    cyc = build_packed_cycle_fn(spec, commit_mode="scan", device=CPU)
    stable = build_stable_state_fn(spec, device=CPU)(w, b)
    pipe = ServingPipeline(cyc, diag_fn=build_diagnosis_fn(spec, donate=True, device=CPU),
                           donate_diagnosis=True, device=CPU)
    h = pipe.dispatch(w, b, stable, device_put=False)
    _, unsched, _ = h.decisions()
    assert unsched[3]  # 'huge' found no node
    rc = h.reject_counts()
    assert rc is not None and rc[3].sum() > 0  # attributed off-path
    assert h._wbuf is None  # buffers handed to the diagnosis program
    h2 = pipe.dispatch(w, b, stable, device_put=False)
    h2.decisions()
    np.testing.assert_array_equal(h2.reject_counts(), rc)


def test_cpu_arena_copy_guards_deferred_programs():
    """A dispatch fed the encoder's raw host arena (numpy) takes a copy
    before the cycle: the deferred diagnosis, forced after the next
    encode rewrote the arena in place, still reads its own cycle's
    bytes."""
    enc, (w, b, spec, _snap, _dirty) = _frame(pods=3, huge=True)
    cyc = build_packed_cycle_fn(spec, commit_mode="scan", outputs="latency", device=CPU)
    pipe = ServingPipeline(cyc, diag_fn=build_diagnosis_fn(spec, device=CPU), device=CPU)
    stable = build_stable_state_fn(spec, device=CPU)(w, b)
    hw, hb = enc.host_buffers()  # the arena itself, rewritten by encodes

    h1 = pipe.dispatch(hw, hb, stable, device_put=False)
    assert h1.decisions()[1][3]
    rc_ref = h1.reject_counts().copy()
    assert rc_ref[3].sum() > 0
    h2 = pipe.dispatch(hw, hb, stable, device_put=False)
    h2.decisions()
    hw[:] = 0  # the next encode's in-place rewrite, before the force
    hb[:] = 0
    np.testing.assert_array_equal(h2.reject_counts(), rc_ref)
    # device_put=True takes the slot's staging path: the same copy
    h3 = pipe.dispatch(*enc.host_buffers(), stable, device_put=True)
    assert h3._wbuf.data_ptr() != hw.ctypes.data


def _mini_cluster(s, n_pods, prefix):
    for i in range(n_pods):
        s.on_pod_add(MakePod(f"{prefix}{i}").req({"cpu": "1"}).created(float(i)).obj())


def test_binds_fold_before_next_cycle_encodes():
    s = Scheduler(device=CPU)
    seq: list[tuple] = []
    enc = s._encoder
    orig = enc.encode_packed

    def wrapped(nodes, pending, existing, *a, **k):
        seq.append(("encode", sorted(p.name for p, _ in existing)))
        return orig(nodes, pending, existing, *a, **k)

    enc.encode_packed = wrapped
    s.binder = lambda pod, node: seq.append(("bind", pod.name))
    for i in range(2):
        s.on_node_add(MakeNode(f"n{i}").capacity({"cpu": "4"}).obj())
    _mini_cluster(s, 3, "a")
    s.schedule_cycle()
    _mini_cluster(s, 2, "b")
    s.schedule_cycle()
    encodes = [e for e in seq if e[0] == "encode"]
    binds_c1 = {name for kind, name in seq[: seq.index(encodes[1])] if kind == "bind"}
    assert binds_c1, "cycle 1 bound nothing; fixture broken"
    assert binds_c1 <= set(encodes[1][1]), \
        "cycle 2 encoded before cycle 1's binds folded into the cache"


@pytest.mark.parametrize("mode", ["rounds", "scan"])
def test_forced_sync_produces_identical_bindings(mode):
    results = {}
    for sync in (False, True):
        s = Scheduler(SchedulerConfiguration(forced_sync=sync, commit_mode=mode), device=CPU)
        bound = []
        s.binder = lambda pod, node, bound=bound: bound.append((pod.name, node))
        for i in range(3):
            s.on_node_add(MakeNode(f"n{i}").capacity({"cpu": "4"}).obj())
        _mini_cluster(s, 5, "p")
        s.on_pod_add(MakePod("huge").req({"cpu": "64"}).obj())
        st = s.schedule_cycle()
        results[sync] = (bound, st.scheduled, st.unschedulable,
                         [e.message for e in s.events.events()])
        pipes = [v["fns"][6] for v in s._packed.values()]
        assert pipes and pipes[0].fetch_bytes_total > 0
        assert pipes[0].forced_sync is sync
    assert results[False] == results[True]


def test_expired_deadline_raises_and_steps_the_ladder():
    _, (w, b, spec, _snap, _dirty) = _frame()
    cyc = build_packed_cycle_fn(spec, commit_mode="scan", device=CPU)
    stable = build_stable_state_fn(spec, device=CPU)(w, b)
    pipe = ServingPipeline(cyc, dispatch_deadline_s=0.05, device=CPU)
    h = pipe.dispatch(w, b, stable, device_put=False)
    h._wait_slim = lambda: time.sleep(0.5)  # a wedged transfer
    with pytest.raises(DispatchDeadlineExceeded):
        h.decisions()
    assert h.fetched and pipe.inflight() == 0  # consumed: the guard released
    pipe.dispatch(w, b, stable, device_put=False).decisions()

    s = Scheduler(SchedulerConfiguration(dispatch_deadline_ms=50.0), device=CPU)
    for i in range(2):
        s.on_node_add(MakeNode(f"n{i}").capacity({"cpu": "4"}).obj())
    _mini_cluster(s, 3, "a")
    from k8s_scheduler_tpu_torch.core import pipeline as pl

    orig = pl.CycleHandle._wait_slim
    pl.CycleHandle._wait_slim = lambda self: time.sleep(0.5) or orig(self)
    try:
        st = s.schedule_cycle()
    finally:
        pl.CycleHandle._wait_slim = orig
    assert st.scheduled == 0 and st.bind_errors == 3
    assert s.ladder.rung == RUNG_RETRACE
    assert s.queue.pending_counts()["backoff"] == 3
    assert s.flight.last_record().counts["aborted"] == 1
    assert s.metrics.fetch_failures.labels("deadline").get() == 1
    assert any(e.reason == "FetchFailed" for e in s.events.events())
    assert not s._packed  # the retrace rung dropped the program sets


@pytest.mark.parametrize("pct", [0, 30, 100])
def test_device_sampling_mask_equals_the_host_window(pct):
    """The carry cycle's `sampling_mask` computes the node-sampling window
    on the device (no host sync on the decision path); it equals the
    window `sampling_window` gives K1 from host integers, on a cluster
    past the 100-node floor and over several cycle indices."""
    import torch

    from k8s_scheduler_tpu_torch.core.cycle import sampling_mask, sampling_window

    nodes = [MakeNode(f"n{i}").capacity({"cpu": "4"}).obj() for i in range(260)]
    pods = [MakePod(f"p{i}").req({"cpu": "1"}).priority(i % 3).obj() for i in range(40)]
    enc = SnapshotEncoder(device=CPU)
    for _ in range(3):  # the encoder bumps the cycle index per encode
        snap = enc.encode(nodes, pods)
        win = sampling_window(snap, pct)
        if win is None:
            want = torch.ones((snap.P, snap.N), dtype=torch.bool)
        else:
            off, k, mod = win
            col = torch.arange(snap.N, dtype=torch.int32)[None, :]
            want = ((col - off[:, None]) % mod) < k
            assert not bool(want.all())  # the window really cuts
        assert torch.equal(sampling_mask(snap, pct), want)


def test_resilient_retries_transport_flakes_and_fails_fast_on_a_wedge():
    from k8s_scheduler_tpu_torch.core import cycle as cy

    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise RuntimeError("connection reset by peer")
        return "ok"

    def wedged():
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    # the strike log is process-wide (flight records count it): restored
    before = dict(cy.RESILIENT_STRIKES)
    try:
        assert cy._Resilient(flaky, "flaky")() == "ok" and len(calls) == 2
        with pytest.raises(RuntimeError, match="illegal memory access"):
            cy._Resilient(wedged, "wedged")()
        assert len(calls) == 3  # no retry
        assert cy.RESILIENT_STRIKES[("flaky", "transport")] == 1
        assert cy.RESILIENT_STRIKES[("wedged", "backend_wedge")] == 1
    finally:
        cy.RESILIENT_STRIKES.clear()
        cy.RESILIENT_STRIKES.update(before)
    assert [cy.classify_failure(RuntimeError(m)) for m in (
        "read body: EOF", "unspecified launch failure", "shape mismatch")] == [
        "transport", "wedge", "other"]
