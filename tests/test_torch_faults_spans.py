"""The port's fault injection (`core/faults.py` and its hooks), crash black
box (`core/blackbox.py`) and pod-lifecycle tracing (`core/spans.py` and
its stamp sites) against the reference's.

- Faults: the reference's grammar cases, good and bad, parse to equal
  plans; for one seed both packages fire the same sequence; an injected
  `device_error` of each kind is classified by the port's
  `classify_failure` as the reference classifies its own; a `fetch_hang`
  is bounded by `dispatchDeadlineMs` and the ladder recovers; a
  `transport` fault (and a `corrupt` one) is absorbed with the decisions
  of the run without faults, and the two packages' Schedulers fire the
  same faults at the same cycles; `journal_enospc` degrades the journal
  to stateless, and the ladder's `stateless` rung seals and dumps a
  black-box bundle (a clean snapshot on a healthy journal).
- Black box: bundles, throttling, retention and `load_bundle`, the
  bundle's sections equal to the reference's.
- Spans: traceparent parse and format and `sampled(uid, rate)` equal the
  reference's over 10 000 uids; the ring's bounds; for one traced run
  through the front door (durable state, a fake clock, preemption), the
  span names, uids and attributes equal the reference's, times aside;
  tracing on and off leave decisions and events bit-identical; the chrome
  tracks and the OTLP JSON have the reference's shape."""

from __future__ import annotations

import dataclasses
import json
import os
import time
import types

import pytest

import k8s_scheduler_tpu.config as ref_config
import k8s_scheduler_tpu.core.blackbox as ref_blackbox
import k8s_scheduler_tpu.core.cycle as ref_cycle
import k8s_scheduler_tpu.core.faults as ref_faults
import k8s_scheduler_tpu.core.scheduler as ref_scheduler
import k8s_scheduler_tpu.core.spans as ref_spans
import k8s_scheduler_tpu.service.admission as ref_admission
import k8s_scheduler_tpu.state as ref_state
import k8s_scheduler_tpu_torch.config as port_config
import k8s_scheduler_tpu_torch.core.blackbox as blackbox
import k8s_scheduler_tpu_torch.core.cycle as port_cycle
import k8s_scheduler_tpu_torch.core.faults as faults
import k8s_scheduler_tpu_torch.core.scheduler as port_scheduler
import k8s_scheduler_tpu_torch.core.spans as spans
import k8s_scheduler_tpu_torch.service.admission as port_admission
import k8s_scheduler_tpu_torch.state as port_state
import k8s_scheduler_tpu_torch.utils.synth as port_synth
from k8s_scheduler_tpu_torch.core.degrade import RUNG_STATELESS
from test_torch_scheduler import _drive, drive
from test_torch_volumes import PORT, REF
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _disarm():
    """No fault plan, span sink or black box may leak across tests
    (arming is process-global in both packages)."""
    yield
    for mod in (faults, ref_faults, spans, ref_spans, blackbox, ref_blackbox):
        mod.disarm()


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self):
        return self.t


# ---- faults: the plan ------------------------------------------------------

GOOD_SPECS = [
    "seed=9; fetch_hang@cycle=40:ms=5000 ;device_error@cycle=5..9:kind=wedge:p=0.5:n=2,"
    "journal_enospc",
    "fetch_hang@cycle=40:ms=5000",
    "seed=7;fetch_delay@cycle=3..9:ms=50:p=0.5;device_error@cycle=12:kind=wedge:n=1",
    "device_error@cycle=5:kind=corrupt:n=1",
    "cache_torn@n=1;cache_enospc;clock_skew@cycle=2:ms=-30",
    "seed=7;device_error@cycle=2:kind=transport:n=1;fetch_delay@cycle=3:ms=20",
]
BAD_SPECS = ["nonsense@cycle=1", "fetch_hang@cycle", "fetch_hang@wat=3",
             "device_error@kind=sideways", "", "seed=4"]


def _plan_dict(p):
    return {"seed": p.seed, "rules": [dataclasses.asdict(r) for r in p.rules]}


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_fault_plans_parse_as_the_reference(spec):
    assert _plan_dict(faults.FaultPlan.parse(spec)) == _plan_dict(ref_faults.FaultPlan.parse(spec))
    assert faults.POINTS == ref_faults.POINTS


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_fault_specs_are_refused_as_the_reference(spec):
    with pytest.raises(ref_faults.FaultPlanError) as want:
        ref_faults.FaultPlan.parse(spec)
    with pytest.raises(faults.FaultPlanError) as got:
        faults.FaultPlan.parse(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", [3, 7, 11])
def test_fault_plans_fire_the_reference_sequence(seed):
    spec = (f"seed={seed};fetch_delay@cycle=1..40:p=0.4:ms=1;device_error@p=0.3:kind=corrupt;"
            "fetch_hang@cycle=5..30:p=0.5:n=4;journal_enospc@cycle=9")
    points = ("fetch_delay", "device_error", "fetch_hang", "journal_enospc", "clock_skew")

    def run(mod):
        p = mod.FaultPlan.parse(spec)
        fired = [(pt, cyc, p.fire(pt, cyc) is not None)
                 for cyc in range(1, 41) for pt in points]
        return fired, [{k: v for k, v in e.items() if k != "wall"} for e in p.log]

    got, want = run(faults), run(ref_faults)
    assert got == want
    assert 10 < sum(f for *_, f in got[0]) < len(got[0])


def test_unarmed_hooks_are_dead_branches():
    assert faults.ARMED is False
    assert faults.fire("fetch_hang") is None
    assert faults.skew_s() == 0.0 and faults.torn_store() is False
    faults.raise_enospc("cache_enospc")  # no plan: no raise


@pytest.mark.parametrize("kind", ["transport", "corrupt", "wedge"])
def test_injected_device_errors_classify_as_the_reference(kind):
    def classified(mod, cyc):
        mod.arm(mod.FaultPlan.parse(f"device_error@kind={kind}"))
        try:
            with pytest.raises(RuntimeError) as ei:
                mod.raise_device_error()
        finally:
            mod.disarm()
        return cyc.classify_failure(ei.value)

    assert classified(faults, port_cycle) == classified(ref_faults, ref_cycle) == kind


def test_resilient_absorbs_transport_and_corrupt_and_fails_fast_on_wedge(monkeypatch):
    monkeypatch.setattr(time, "sleep", lambda s: None)
    calls = []
    r = port_cycle._Resilient(lambda: calls.append(1) or 42, "probe")
    faults.arm(faults.FaultPlan.parse(
        "device_error@cycle=1:kind=transport:n=1;device_error@cycle=2:kind=corrupt:n=1;"
        "device_error@cycle=3:kind=wedge:n=1"))
    before = dict(port_cycle.RESILIENT_STRIKES)
    for cyc in (1, 2):
        faults.set_cycle(cyc)
        assert r() == 42
    faults.set_cycle(3)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        r()
    strikes = {k: v - before.get(k, 0) for k, v in port_cycle.RESILIENT_STRIKES.items()
               if k[0] == "probe"}
    assert strikes == {("probe", "transport"): 1, ("probe", "executable_cache"): 1,
                       ("probe", "backend_wedge"): 1}
    assert len(calls) == 2


# ---- faults through the Scheduler --------------------------------------------


def _no_strikes(cycles):
    """The cycle records without `retry_strikes_total`, a process-wide
    counter that absorbed faults move."""
    return [dict(c, record_counts=[{k: v for k, v in r.items() if k != "retry_strikes_total"}
                                   for r in c["record_counts"]]) for c in cycles]


def _with_faults(spec):
    def configure(cfg_mod, cfg):
        return dataclasses.replace(cfg, fault_spec=spec)
    return configure


def test_transport_and_corrupt_faults_are_absorbed_with_the_same_decisions():
    """One plan through both packages' Schedulers over the churn fixture:
    the port's decisions and events equal the reference's run without
    faults, and both packages fire the plan's faults at the same cycles."""
    spec = ("seed=7;device_error@cycle=2:kind=transport:n=1;"
            "device_error@cycle=3:kind=corrupt:n=1;fetch_delay@cycle=3:ms=1")
    logs = {}
    got = {}
    for side, mod in (("port", faults), ("ref", ref_faults)):
        keep = []
        got[side] = drive(side, "churn", configure=_with_faults(spec), keep=keep)
        logs[side] = [{k: v for k, v in e.items() if k != "wall"}
                      for e in mod.plan().log]
        mod.disarm()
        assert keep[0].ladder.rung == 0 and keep[0].ladder.degradations == 0
    want = _no_strikes(_drive("ref", "churn", "rounds"))
    assert _no_strikes(got["port"]) == want
    assert _no_strikes(got["ref"]) == want
    assert logs["port"] == logs["ref"]
    assert {(e["point"], e["cycle"]) for e in logs["port"]} >= {
        ("device_error", 2), ("device_error", 3), ("fetch_delay", 3)}


def _small_sched(spec="", deadline_ms=250.0, promote=2, binds=None, state=None, now=None):
    cfg = port_config.SchedulerConfiguration(
        dispatch_deadline_ms=deadline_ms, degrade_promote_cycles=promote, fault_spec=spec,
        pod_initial_backoff_seconds=0.01, pod_max_backoff_seconds=0.05,
        pad_existing=64, pad_pods_per_node=16, speculative_compile=False)
    sink = binds if binds is not None else []
    kw = {"now": now} if now is not None else {}
    return port_scheduler.Scheduler(config=cfg, binder=lambda p, n: sink.append(p.uid),
                                    state=state, device="cpu", **kw)


def test_fetch_hang_is_bounded_by_the_deadline_and_the_ladder_recovers():
    from k8s_scheduler_tpu_torch.cmd.httpserver import staleness_healthz

    binds: list[str] = []
    sched = _small_sched("fetch_hang@cycle=3:ms=3000:n=1", binds=binds)
    for nd in port_synth.make_cluster(4):
        sched.on_node_add(nd)
    healthz = staleness_healthz(None, None, 0.0, ladder=sched.ladder)
    added: set[str] = set()
    walls, rungs = {}, {}
    for i in range(1, 8):
        for p in port_synth.make_pods(3, seed=300 + i, name_prefix=f"a{i}-"):
            sched.on_pod_add(p)
            added.add(p.uid)
        t0 = time.perf_counter()
        sched.schedule_cycle()
        walls[i] = time.perf_counter() - t0
        rungs[i] = sched.ladder.rung
        if i == 3:
            ok, detail = healthz()
            assert ok and detail["degraded"] is True
            assert detail["degradation"]["name"] == "retrace"
        time.sleep(0.02)
    assert walls[3] < 2.5, walls  # the 3 s hang never reaches the loop
    assert rungs[3] == 1
    assert set(binds) == added and len(binds) == len(added)
    assert sched.ladder.rung == 0 and sched.ladder.degradations == 1
    assert sched.metrics.fetch_failures.labels("deadline").get() == 1.0
    ab = [r for r in sched.flight.snapshot() if r.counts.get("aborted")]
    assert len(ab) == 1 and ab[0].counts["rung"] == 1
    assert any(e.reason == "FetchFailed" for e in sched.events.events())


def test_clock_skew_shifts_the_cycle_clock():
    sched = _small_sched("clock_skew@cycle=2:ms=500:n=1", deadline_ms=0.0, now=FakeClock(10.0))
    for nd in port_synth.make_cluster(2):
        sched.on_node_add(nd)
    sched.on_pod_add(port_synth.make_pods(1, seed=5)[0])
    sched.schedule_cycle()
    sched.on_pod_add(port_synth.make_pods(1, seed=6, name_prefix="b")[0])
    assert faults.skew_s() == 0.0  # no rule for the ambient cycle 1
    st = sched.schedule_cycle()
    assert st.scheduled == 1
    assert [e["point"] for e in faults.plan().log] == ["clock_skew"]


def test_journal_enospc_degrades_to_stateless_and_the_rung_dumps_a_bundle(tmp_path):
    d = str(tmp_path / "state")
    st = port_state.DurableState(d, snapshot_interval_seconds=0)
    binds: list[str] = []
    sched = _small_sched("journal_enospc@cycle=3:n=1", deadline_ms=0.0, binds=binds, state=st)
    box = blackbox.arm(blackbox.BlackBox(os.path.join(d, "blackbox"), retention=4,
                                         recorder=sched.flight, observer=sched.observer,
                                         ladder=sched.ladder, fault_plan=sched._fault_plan,
                                         events=sched.events))
    for nd in port_synth.make_cluster(6):
        sched.on_node_add(nd)
    for i in range(1, 6):
        for p in port_synth.make_pods(3, seed=700 + i, name_prefix=f"en{i}-"):
            sched.on_pod_add(p)
        sched.schedule_cycle()
        if i == 3:
            with pytest.raises(port_state.StateError):
                st.journal.flush(timeout=5.0)  # the writer died on the fault
    assert st.journal.failed is not None
    assert sched.queue._journal is None and sched.cache._journal is None
    assert st.status()["sealed"] and len(binds) > 9  # serving went on stateless
    while sched.ladder.rung < RUNG_STATELESS:
        sched.ladder.degrade("forced")
    assert sched.ladder.floor == RUNG_STATELESS
    (name,) = box.status()["bundles"]
    bundle = blackbox.load_bundle(os.path.join(d, "blackbox", name))
    assert bundle["trigger"] == "stateless" and bundle["faults"]["fired"] == ["journal_enospc"]
    assert bundle["ladder"]["status"]["rung"] == RUNG_STATELESS
    assert bundle["flight"]["records"] and bundle["chrome_trace"]["traceEvents"]


def test_stateless_rung_seals_a_clean_snapshot_for_the_standby(tmp_path):
    d = str(tmp_path / "state")
    clock = FakeClock(5.0)
    sched = _small_sched(deadline_ms=0.0, state=port_state.DurableState(
        d, snapshot_interval_seconds=0), now=clock)
    box = blackbox.arm(blackbox.BlackBox(os.path.join(d, "blackbox"), ladder=sched.ladder))
    for nd in port_synth.make_cluster(3):
        sched.on_node_add(nd)
    for p in port_synth.make_pods(5, seed=8):
        sched.on_pod_add(p)
    sched.schedule_cycle()
    while sched.ladder.rung < RUNG_STATELESS:
        sched.ladder.degrade("forced")
    live = port_state.state_digest(sched.queue, sched.cache)
    sched.on_pod_add(port_synth.make_pods(1, seed=9, name_prefix="late")[0])  # unjournaled
    assert sched.state.status()["sealed"] and box.dumps == 1
    for mod, sched_mod in ((port_state, port_scheduler), (ref_state, ref_scheduler)):
        q, c = sched_mod.SchedulingQueue(), sched_mod.SchedulerCache()
        stats = mod.DurableState(d, snapshot_interval_seconds=0).restore_into(q, c)
        assert stats["clean_shutdown"] is True and stats["records_replayed"] == 0
        assert port_state.state_digest(q, c) == live


# ---- black box ---------------------------------------------------------------


def test_blackbox_bundles_throttle_retention_and_sections_equal_the_reference(tmp_path):
    from k8s_scheduler_tpu.core.degrade import DegradationLadder as RefLadder
    from k8s_scheduler_tpu.core.events import EventRecorder as RefEvents
    from k8s_scheduler_tpu.core.flight_recorder import FlightRecorder as RefRecorder
    from k8s_scheduler_tpu.core.observe import CycleObserver as RefObserver
    from k8s_scheduler_tpu_torch.core.degrade import DegradationLadder
    from k8s_scheduler_tpu_torch.core.events import EventRecorder
    from k8s_scheduler_tpu_torch.core.flight_recorder import FlightRecorder
    from k8s_scheduler_tpu_torch.core.observe import CycleObserver

    sections = {}
    for side, bb, sp, fr, ob, lad, ev, fmod in (
            ("port", blackbox, spans, FlightRecorder, CycleObserver, DegradationLadder,
             EventRecorder, faults),
            ("ref", ref_blackbox, ref_spans, RefRecorder, RefObserver, RefLadder, RefEvents,
             ref_faults)):
        rec = fr(capacity=8)
        r = rec.start()
        r.mark("dispatch_start", r.t_start + 0.001)
        r.mark("decision_end", r.t_start + 0.004)
        rec.commit(r)
        srec = sp.SpanRecorder(capacity=8)
        srec.record("dispatch", sp.TraceContext("a" * 32, "b" * 16), 1.0, 1.5, uid="u1", seq=0)
        plan = fmod.FaultPlan.parse("fetch_delay@cycle=1:ms=1")
        plan.fire("fetch_delay", 1)
        lad = lad(promote_after=2)
        lad.degrade("testing")
        box = bb.BlackBox(str(tmp_path / side), retention=2, config={"k": 1}, recorder=rec,
                          observer=ob(), spans_recorder=srec, ladder=lad, fault_plan=plan,
                          events=ev())
        bb.arm(box)
        paths = [bb.trigger("watchdog", "one"), bb.trigger("watchdog", "throttled"),
                 bb.trigger("stateless", "two"), bb.trigger("sigterm", "three"),
                 bb.trigger("sigterm", "four")]
        assert paths[1] is None and all(p for i, p in enumerate(paths) if i != 1)
        names = box.status()["bundles"]
        assert len(names) == 2 and names[-1].endswith("-sigterm.json")  # retention
        b = bb.load_bundle(paths[-1])
        assert b["trigger"] == "sigterm" and b["detail"] == "four"
        sections[side] = (sorted(b), sorted(b["flight"]), sorted(b["ladder"]),
                          sorted(b["faults"]), [n.split("-", 2)[2] for n in names])
        bb.disarm()
        assert bb.trigger("watchdog") is None
    assert sections["port"] == sections["ref"]


# ---- spans ----------------------------------------------------------------


def test_traceparent_and_sampling_equal_the_reference():
    tid, sid = "0af7651916cd43dd8448eb211c80319c", "b7ad6b7169203331"
    cases = [spans.format_traceparent(tid, sid), f"00-{tid}-{sid}-00", f"00-{'0' * 32}-{sid}-01",
             f"00-{tid}-{'0' * 16}-01", "00-short-b7ad6b7169203331-01", "", "garbage",
             f"  00-{tid.upper()}-{sid}-01  ", f"01-{tid}-{sid}-01"]
    for c in cases:
        assert spans.parse_traceparent(c) == ref_spans.parse_traceparent(c), c
    assert spans.format_traceparent(tid, sid) == ref_spans.format_traceparent(tid, sid)
    uids = [f"default/pod-{i}" for i in range(10_000)]
    for rate in (0.0, 1.0 / 64.0, 0.25, 0.5, 1.0):
        got = [spans.sampled(u, rate) for u in uids]
        assert got == [ref_spans.sampled(u, rate) for u in uids], rate
    assert 0 < sum(spans.sampled(u, 0.25) for u in uids) < 10_000
    assert spans.SPAN_NAMES == ref_spans.SPAN_NAMES


def test_span_ring_bounds_and_wrap():
    rec = spans.SpanRecorder(capacity=8)
    c = spans.TraceContext(spans.new_trace_id(), spans.new_span_id())
    for i in range(20):
        rec.record("dispatch", c, float(i), float(i) + 0.5, uid=f"u{i}")
    assert rec.count == 20
    assert [s.seq for s in rec.snapshot()] == list(range(12, 20))
    assert [s.seq for s in rec.snapshot(last=3)] == [17, 18, 19]
    assert rec.for_uid("u19")[0].seq == 19 and rec.for_uid("u0") == []
    json.dumps(rec.to_dicts(last=5))


def _same_spans(pkg_spans):
    """One span list for a package, fixed ids and times."""
    root = pkg_spans.TraceContext("a" * 32, "")
    child = pkg_spans.TraceContext("a" * 32, "c" * 16, tenant="t1")
    out = []
    for i, (name, ctx, attrs) in enumerate([
            ("submit.validate", root, {"uid": "u1"}),
            ("ack.barrier", child, {"uid": "u1", "flush_seq": 3, "durable": True, "frac": 0.5}),
            ("dispatch", child, {"uid": "u2", "seq": 7})]):
        out.append(pkg_spans.Span(ctx.trace_id, f"{i:016x}", ctx.span_id, name, 10.0 + i,
                                  10.5 + i, i, dict(attrs, **({"tenant": ctx.tenant}
                                                              if ctx.tenant else {}))))
    return out


def test_chrome_tracks_and_otlp_json_have_the_reference_shape():
    got = spans.to_otlp_json(_same_spans(spans), 9.0, 1000.0, service_name="t")
    want = ref_spans.to_otlp_json(_same_spans(ref_spans), 9.0, 1000.0, service_name="t")
    got["resourceSpans"][0]["scopeSpans"][0]["scope"]["name"] = "scope"
    want["resourceSpans"][0]["scopeSpans"][0]["scope"]["name"] = "scope"
    assert got == want
    assert spans.spans_to_chrome_events(_same_spans(spans), epoch=9.0) == \
        ref_spans.spans_to_chrome_events(_same_spans(ref_spans), epoch=9.0)
    assert [s.to_dict(epoch=9.0) for s in _same_spans(spans)] == \
        [s.to_dict(epoch=9.0) for s in _same_spans(ref_spans)]


def test_export_otlp_dir_sequence_and_rotation(tmp_path):
    d = str(tmp_path / "otlp")
    rec = spans.SpanRecorder(capacity=64)
    assert spans.export_otlp_dir(rec, d) is None
    c = spans.TraceContext(spans.new_trace_id(), spans.new_span_id())
    for i in range(40):
        rec.record("dispatch", c, float(i), float(i) + 0.1, uid=f"u{i}", seq=i)
    paths = [spans.export_otlp_dir(rec, d, max_bytes=1) for _ in range(3)]
    assert [os.path.basename(p) for p in paths] == [f"spans-{i:06d}.json" for i in range(3)]
    assert sorted(os.listdir(d)) == ["spans-000002.json"]  # rotated down to the newest
    with open(paths[-1]) as f:
        assert len(json.load(f)["resourceSpans"][0]["scopeSpans"][0]["spans"]) == 40


# a traced run through the front door: both packages, durable state, a
# fake clock, a preemption


def _traced_run(side, state_dir, tp, arm=True):
    """Nodes full of low-priority running pods, then two submissions
    (high-priority pods that preempt, and small pods) through the
    self-confirming front door, a cycle after each. Returns (scheduler,
    binds, evictions, spans as (name, attrs) in ring order)."""
    m = REF if side == "ref" else PORT
    core_sched = ref_scheduler if side == "ref" else port_scheduler
    cfg_mod = ref_config if side == "ref" else port_config
    adm_mod = ref_admission if side == "ref" else port_admission
    sp = ref_spans if side == "ref" else spans
    st_mod = ref_state if side == "ref" else port_state
    clock = FakeClock(100.0)
    binds, evictions = [], []
    kw = {"device": "cpu"} if side == "port" else {}
    sched = core_sched.Scheduler(
        cfg_mod.SchedulerConfiguration(pad_existing=64, pad_pods_per_node=16),
        binder=lambda p, n: binds.append((p.name, n)), now=clock,
        state=st_mod.DurableState(state_dir, snapshot_interval_seconds=0), **kw)

    def evict(p, n):
        evictions.append((p.name, n))
        sched.on_pod_delete(p.uid)

    sched.evictor = evict
    rec = sp.arm(rate=1.0) if arm else None
    adm = adm_mod.AdmissionController(sched, queue_depth=100)
    fd = adm_mod.self_confirming_front_door(
        types.SimpleNamespace(scheduler=sched, run_local_cycle=sched.schedule_cycle), adm)
    adm.node_churn(adds=[m.MakeNode(f"n{i}").capacity({"cpu": "4", "memory": "8Gi"}).obj()
                         for i in range(3)])
    for i in range(3):
        sched.on_pod_add(m.MakePod(f"low{i}").req({"cpu": "3"}).priority(0).obj(), f"n{i}")
    results = []
    for batch in ([m.MakePod(f"hi{i}").req({"cpu": "3"}).priority(100).created(float(i)).obj()
                   for i in range(2)],
                  [m.MakePod(f"small{i}").req({"cpu": "1"}).created(10.0 + i).obj()
                   for i in range(3)]):
        res = adm.submit(batch, traceparent=tp)
        results.append({k: v for k, v in dataclasses.asdict(res).items()})
        clock.t += 1.0
        fd._cycle_fn()
        fd._post_cycle()
    for _ in range(2):  # the preemptors bind once their victims are gone
        clock.t += 11.0
        fd._cycle_fn()
        fd._post_cycle()
    out = [(s.name, s.trace_id, s.parent, s.attrs) for s in rec.snapshot()] if arm else []
    sched.state.journal.flush()
    sched.state.journal.close()
    sp.disarm()
    sched._test_spans = rec
    sched._test_admission = adm
    return sched, binds, evictions, out, results


def test_traced_run_spans_equal_the_reference(tmp_path):
    tp = spans.format_traceparent("ab" * 16, "cd" * 8)
    _, pb, pe, got, pres = _traced_run("port", str(tmp_path / "p"), tp)
    _, rb, re_, want, rres = _traced_run("ref", str(tmp_path / "r"), tp)
    assert (pb, pe, pres) == (rb, re_, rres)
    assert got == want
    names = {n for n, *_ in got}
    assert {"submit.validate", "submit.journal", "ack.barrier", "dispatch", "decision.row",
            "apply.fold", "bind.confirm", "preempt.victim"} <= names
    assert {t for _n, t, _p, _a in got} == {"ab" * 16}
    assert pe and len(pb) == 5


def test_tracing_on_and_off_leave_decisions_and_events_bit_identical(tmp_path):
    tp = spans.format_traceparent("ab" * 16, "cd" * 8)
    on = _traced_run("port", str(tmp_path / "on"), tp)
    off = _traced_run("port", str(tmp_path / "off"), tp, arm=False)
    assert on[1:3] == off[1:3]
    ev = [[(e.reason, e.pod_name, e.message) for e in s.events.events()] for s in (on[0], off[0])]
    assert ev[0] == ev[1]
    assert on[0].queue.pending_counts() == off[0].queue.pending_counts()
    assert port_state.state_digest(on[0].queue, on[0].cache) == \
        port_state.state_digest(off[0].queue, off[0].cache)


def _get(url):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _timeless(v):
    """`v` without its clock-derived fields, recursively."""
    drop = ("t0_s", "t1_s", "dur_ms", "wall", "span_id", "t_s", "marks_s", "phases_ms",
            "anomalies")
    if isinstance(v, dict):
        return {k: _timeless(x) for k, x in v.items() if k not in drop}
    if isinstance(v, list):
        return [_timeless(x) for x in v]
    return v


def test_debug_traces_and_explain_merge_spans_as_the_reference(tmp_path):
    """/debug/traces with the span tracks merged and /debug/explain with
    the spans, their totals and the admission history, on both packages'
    servers over the traced run."""
    import k8s_scheduler_tpu.cmd.httpserver as ref_http
    import k8s_scheduler_tpu_torch.cmd.httpserver as port_http

    tp = spans.format_traceparent("ab" * 16, "cd" * 8)
    got = {}
    for side, http in (("port", port_http), ("ref", ref_http)):
        sched = _traced_run(side, str(tmp_path / side), tp)[0]
        server = http.start_http_server(
            sched.metrics, port=0, recorder=sched.flight, pod_timeline=sched.pod_timeline,
            observer=sched.observer, admission=sched._test_admission,
            spans_recorder=sched._test_spans)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            out = {}
            for pod in ("default/hi0", "default/small1"):
                st, _h, body = _get(f"{base}/debug/explain?pod={pod}")
                v = json.loads(body)
                v["span_totals_ms"] = sorted(v["span_totals_ms"])
                out[pod] = (st, _timeless(v))
            for q in ("pod=default/hi1", "trace=" + "ab" * 16, "last=8"):
                st, h, body = _get(f"{base}/debug/traces?{q}")
                ev = json.loads(body)["traceEvents"]
                out[q] = (st, h.get("Content-Disposition"), sorted(
                    (e["name"], e["args"].get("uid", "")) for e in ev
                    if e.get("cat") == "pod-trace"))
            got[side] = out
        finally:
            http.stop_http_server(server)
    assert got["port"] == got["ref"]
    assert got["port"]["default/hi0"][1]["trace_ids"] == ["ab" * 16]
    assert ("bind.confirm", "default/hi1") in got["port"]["pod=default/hi1"][2]
