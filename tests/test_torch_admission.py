"""The port's submission front door (`service/admission.py`), its HTTP path
(`POST /submit`, `/debug/state`) and its Scheduler hooks against the
reference's (tests/test_front_door.py's cases):

- one submit sequence (accept, shed on a full queue, invalid pods,
  duplicates, a degraded ladder and its half-open trickle, an SLO fast
  burn, draining) gives the reference's `SubmitResult` fields, shed
  reasons and retry-after hints, and the same admission metrics;
- an ack means the pod is journaled across a crash; a rejected
  submission is never journaled; an ack after the journal died is not
  durable; a resubmit after the bind is rejected; a delete frees the uid;
- the serve loop survives a cycle exception (and dumps a black-box
  bundle) and fails shut on a fatal exit; a drain cycles the active tier
  empty; the self-confirming front door confirms binds (no TTL re-bind);
- `POST /submit` answers 200, 429 with Retry-After, 400, 413 and 503 and
  echoes the traceparent, as the reference's server does; `/debug/state`
  and the admission's /healthz detail have the reference's shape;
- `tenants=` is refused by name (ROADMAP A12)."""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

import k8s_scheduler_tpu.cmd.httpserver as ref_http
import k8s_scheduler_tpu.config as ref_config
import k8s_scheduler_tpu.core.scheduler as ref_scheduler
import k8s_scheduler_tpu.service.admission as ref_admission
import k8s_scheduler_tpu.state as ref_state
import k8s_scheduler_tpu.state.codec as ref_codec
import k8s_scheduler_tpu.utils.synth as ref_synth
import k8s_scheduler_tpu_torch.cmd.httpserver as port_http
import k8s_scheduler_tpu_torch.config as port_config
import k8s_scheduler_tpu_torch.core.blackbox as blackbox
import k8s_scheduler_tpu_torch.core.scheduler as port_scheduler
import k8s_scheduler_tpu_torch.service.admission as port_admission
import k8s_scheduler_tpu_torch.state as port_state
import k8s_scheduler_tpu_torch.state.codec as port_codec
import k8s_scheduler_tpu_torch.utils.synth as port_synth
from k8s_scheduler_tpu_torch.service.admission import (AdmissionController,
                                                       FrontDoor, self_confirming_front_door)
from torch_one_thread import one_torch_thread  # noqa: F401


class Side:
    def __init__(self, sched_mod, cfg_mod, adm, state, synth, http, codec, kw):
        self.sched_mod, self.cfg_mod, self.adm, self.state = sched_mod, cfg_mod, adm, state
        self.synth, self.http, self.codec, self.kw = synth, http, codec, kw

    def sched(self, state=None, binds=None, **cfg):
        cfg.setdefault("pod_initial_backoff_seconds", 0.05)
        cfg.setdefault("pod_max_backoff_seconds", 0.2)
        cfg.setdefault("pad_existing", 64)
        cfg.setdefault("pad_pods_per_node", 16)
        binds = binds if binds is not None else {}
        s = self.sched_mod.Scheduler(
            config=self.cfg_mod.SchedulerConfiguration(**cfg),
            binder=lambda p, n: binds.__setitem__(p.uid, binds.get(p.uid, 0) + 1),
            state=state, **self.kw)
        return s, binds


PORT = Side(port_scheduler, port_config, port_admission, port_state, port_synth, port_http,
            port_codec, {"device": "cpu"})
REF = Side(ref_scheduler, ref_config, ref_admission, ref_state, ref_synth, ref_http,
           ref_codec, {})


def _restore_bare(side, d):
    q, c = side.sched_mod.SchedulingQueue(), side.sched_mod.SchedulerCache()
    st = side.state.DurableState(d, snapshot_interval_seconds=0)
    st.restore_into(q, c)
    st.journal.close()
    return q, c


# ---- admission semantics against the reference -----------------------------


def _submit_sequence(side: Side):
    """One sequence of submissions, no cycle: the results (every
    SubmitResult field) and the admission metrics."""
    sched, _ = side.sched(slo_p99_ms=1.0)
    adm = side.adm.AdmissionController(sched, queue_depth=6, retry_after_ms=123.0)
    mk = side.synth.make_pods
    out = []

    def sub(pods, tag):
        r = adm.submit(pods)
        out.append((tag, dataclasses.asdict(r), adm.overloaded(), adm.queue_depth()))

    sub(mk(4, seed=2, name_prefix="b-"), "accept")
    sub(mk(4, seed=3, name_prefix="c-"), "full")
    sub(mk(2, seed=30, name_prefix="c2-"), "fills")
    good = mk(2, seed=4, name_prefix="d-")
    bad = mk(1, seed=5, name_prefix="e-")[0]
    bad.metadata.uid = ""
    sub(good + [bad], "malformed")
    p = mk(1, seed=6, name_prefix="f-")[0]
    sub([p, p], "dup-in-request")
    sub(mk(1, seed=2, name_prefix="b-"), "already-pending")
    sched.on_pod_delete(mk(1, seed=2, name_prefix="b-")[0].uid)  # frees the uid
    sub(mk(1, seed=2, name_prefix="b-"), "re-created")
    adm2 = side.adm.AdmissionController(sched, queue_depth=256)
    sched.ladder.degrade("test: forced")
    r = adm2.submit(mk(40, seed=7, name_prefix="g-"))
    out.append(("ladder", dataclasses.asdict(r), adm2.overloaded()))
    sched.ladder.note_clean_cycle()
    for _ in range(64):
        sched.observer.slo.note(10.0)  # every cycle violates: a fast burn
    r = adm2.submit(mk(40, seed=9, name_prefix="i-"))
    out.append(("slo", dataclasses.asdict(r)))
    adm.close()
    r = adm.submit(mk(1, seed=10, name_prefix="j-"))
    out.append(("draining", dataclasses.asdict(r)))
    with pytest.raises(side.adm.AdmissionClosed):
        adm.node_churn(adds=side.synth.make_cluster(1))
    text = sched.metrics.expose().decode()
    metrics = sorted(ln for ln in text.splitlines()
                     if ln.startswith(("scheduler_admission", "scheduler_submit_ack_seconds_count"))
                     and "_created" not in ln)
    return out, metrics, adm.status(), adm.history_for(mk(1, seed=2, name_prefix="b-")[0].uid)


def test_submit_sequence_results_equal_the_reference():
    got, gm, gs, gh = _submit_sequence(PORT)
    want, wm, ws, wh = _submit_sequence(REF)
    assert got == want
    assert gm == wm
    assert gs == ws
    strip = [{k: v for k, v in e.items() if k != "wall"} for e in gh]
    assert strip == [{k: v for k, v in e.items() if k != "wall"} for e in wh]
    kinds = {t for t, r, *_ in got if r["shed"]}
    assert {"full", "ladder", "slo", "draining"} <= kinds


def test_tenants_are_refused_by_name():
    sched, _ = PORT.sched()
    with pytest.raises(NotImplementedError, match="A12"):
        AdmissionController(sched, tenants=object())


# ---- the durability contract ---------------------------------------------------


def test_ack_implies_journaled_across_a_crash(tmp_path):
    st = port_state.DurableState(str(tmp_path), snapshot_interval_seconds=0)
    sched, _ = PORT.sched(state=st)
    adm = AdmissionController(sched, queue_depth=100)
    assert adm.node_churn(adds=port_synth.make_cluster(4))
    pods = port_synth.make_pods(6, seed=11, name_prefix="k-")
    res = adm.submit(pods)
    assert res.ok and res.durable
    for side in (PORT, REF):  # no flush, no seal: read the directory back
        q, c = _restore_bare(side, str(tmp_path))
        assert {p.uid for p in pods} <= {p.uid for p in q.all_pending()}
        assert len(c.nodes()) == 4
    st.journal.close()


def test_rejected_submission_is_never_journaled(tmp_path):
    st = port_state.DurableState(str(tmp_path), snapshot_interval_seconds=0)
    sched, _ = PORT.sched(state=st)
    adm = AdmissionController(sched, queue_depth=4)
    assert adm.submit(port_synth.make_pods(3, seed=12, name_prefix="l-")).ok
    shed = port_synth.make_pods(4, seed=13, name_prefix="m-")
    assert adm.submit(shed).shed
    bad = port_synth.make_pods(1, seed=14, name_prefix="n-")[0]
    bad.metadata.uid = ""
    assert adm.submit([bad]).invalid
    st.journal.flush()
    q, _c = _restore_bare(PORT, str(tmp_path))
    restored = {p.uid for p in q.all_pending()}
    assert len(restored) == 3 and not ({p.uid for p in shed} & restored)
    assert [op for op, _t, _d in port_state.replay_dir(str(tmp_path))] == ["q.add"] * 3
    st.journal.close()


def test_ack_is_not_durable_after_the_journal_died(tmp_path):
    st = port_state.DurableState(str(tmp_path), snapshot_interval_seconds=0)
    sched, _ = PORT.sched(state=st)
    adm = AdmissionController(sched, queue_depth=100)
    assert adm.submit(port_synth.make_pods(1, seed=15, name_prefix="o-")).durable
    st.journal.failed = "ENOSPC (test)"
    res = adm.submit(port_synth.make_pods(1, seed=16, name_prefix="p-"))
    assert res.ok and not res.durable
    st.journal.failed = None
    st.journal.close()


# ---- serving ----------------------------------------------------------------


def test_resubmit_after_bind_is_rejected_and_submit_bind_is_recorded():
    sched, binds = PORT.sched()
    adm = AdmissionController(sched, queue_depth=100)
    adm.node_churn(adds=port_synth.make_cluster(2))
    p = port_synth.make_pods(1, seed=40, name_prefix="rb-")[0]
    assert adm.submit([p]).ok
    sched.schedule_cycle()
    assert binds.get(p.uid) == 1
    res = adm.submit([p])
    assert res.invalid and "already bound" in res.reason
    sched.schedule_cycle()
    assert binds.get(p.uid) == 1
    recs = [r for r in sched.flight.snapshot() if "submit_bind_ms" in r.phases]
    assert recs and recs[-1].phases["submit_bind_ms"] >= 0.0
    assert [e["kind"] for e in adm.history_for(p.uid)] == ["accepted", "bound", "invalid"]
    sched.on_pod_delete(p.uid)
    assert adm.submit([p]).ok
    text = sched.metrics.expose().decode()
    assert "scheduler_admission_queue_depth 1.0" in text


def test_serve_loop_survives_a_cycle_exception_and_dumps_a_bundle(tmp_path):
    sched, binds = PORT.sched()
    adm = AdmissionController(sched, queue_depth=100)
    adm.node_churn(adds=port_synth.make_cluster(2))
    box = blackbox.arm(blackbox.BlackBox(str(tmp_path / "bb"), ladder=sched.ladder))
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError("injected host bug")
        return sched.schedule_cycle()

    fd = FrontDoor(adm, cycle_fn=flaky)
    fd._failure_backoff = 0.01
    fd.start()
    try:
        assert adm.submit(port_synth.make_pods(2, seed=41, name_prefix="fl-")).ok
        deadline = time.monotonic() + 60
        while len(binds) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(binds) == 2 and fd.cycle_failures == 2
    finally:
        fd.stop(drain=False)
        blackbox.disarm()
    (name,) = box.status()["bundles"]  # the second failure is throttled
    assert blackbox.load_bundle(os.path.join(str(tmp_path / "bb"), name))["trigger"] == \
        "serve_loop"


def test_serve_loop_fails_shut_on_a_fatal_exit():
    sched, _ = PORT.sched()
    adm = AdmissionController(sched, queue_depth=100)

    def fatal():
        raise SystemExit(1)

    fd = FrontDoor(adm, cycle_fn=fatal)
    old = threading.excepthook
    threading.excepthook = lambda args: None
    fd.start()
    try:
        deadline = time.monotonic() + 10
        while not adm.closed and time.monotonic() < deadline:
            time.sleep(0.01)
        assert adm.closed
        res = adm.submit(port_synth.make_pods(1, seed=42, name_prefix="ft-"))
        assert res.reason == "draining" and res.shed == 1
    finally:
        fd.stop(drain=False)
        threading.excepthook = old


def test_drain_cycles_the_active_tier_empty_and_closes():
    sched, binds = PORT.sched()
    adm = AdmissionController(sched, queue_depth=100)
    adm.node_churn(adds=port_synth.make_cluster(4))
    fd = FrontDoor(adm)
    fd.start()
    assert adm.submit(port_synth.make_pods(4, seed=18, name_prefix="r-")).ok
    assert fd.stop()
    assert adm.closed and sched.queue.pending_counts()["active"] == 0
    assert len(binds) == 4
    assert adm.submit(port_synth.make_pods(1, seed=19, name_prefix="s-")).reason == "draining"


def test_self_confirming_front_door_confirms_binds(tmp_path):
    st = port_state.DurableState(str(tmp_path), snapshot_interval_seconds=0)
    sched, _ = PORT.sched(state=st)
    sched.cache._ttl = 0.05  # expiry chances galore
    adm = AdmissionController(sched, queue_depth=100)
    fd = self_confirming_front_door(sched, adm)
    counts: dict[str, int] = {}
    inner = sched.binder

    def counting(p, n):
        counts[p.uid] = counts.get(p.uid, 0) + 1
        inner(p, n)

    sched.binder = counting
    adm.node_churn(adds=port_synth.make_cluster(2))
    pods = port_synth.make_pods(3, seed=43, name_prefix="cf-")
    assert adm.submit(pods).ok
    for _ in range(6):
        fd.step()
        time.sleep(0.06)
    assert len(counts) == 3 and all(v == 1 for v in counts.values()), counts
    for p in pods:
        assert sched.cache.has_pod(p.uid) and not sched.cache.is_assumed(p.uid)
    st.journal.flush()
    q, c = _restore_bare(PORT, str(tmp_path))  # the confirmed binds are journaled
    assert c.counts()["bound"] == 3
    st.journal.close()


# ---- the HTTP path ---------------------------------------------------------


def _post(port, body: bytes, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/submit", data=body, method="POST",
                                 headers=headers or {})
    try:
        r = urllib.request.urlopen(req, timeout=10)
        return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _http_sequence(side: Side, d):
    """The reference's POST /submit sequence on one package's server:
    (status, Retry-After, traceparent echo, payload) per request, the
    /healthz admission detail's keys and /debug/state's keys."""
    st = side.state.DurableState(d, snapshot_interval_seconds=0)
    # the reference's persistent compile cache (its default under a state
    # directory) is not ported yet: both run without it
    sched, _ = side.sched(state=st, compile_cache_dir="off")
    adm = side.adm.AdmissionController(sched, queue_depth=6, retry_after_ms=500.0)
    healthz = side.http.staleness_healthz(None, sched.flight, 0.0, observer=sched.observer,
                                          ladder=sched.ladder, admission=adm)
    server = side.http.start_http_server(sched.metrics, port=0, healthz=healthz,
                                         admission=adm, state=st)
    port = server.server_address[1]
    out = []
    try:
        def body(pods):
            return json.dumps({"pods": [side.codec.pod_to_state(p) for p in pods]}).encode()

        tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
        for pods, hdr in ((side.synth.make_pods(6, seed=20, name_prefix="t-"), {"traceparent": tp}),
                          (side.synth.make_pods(5, seed=21, name_prefix="u-"), {}),
                          (side.synth.make_pods(1, seed=20, name_prefix="t-"), {})):
            s, h, payload = _post(port, body(pods), hdr)
            out.append((s, h.get("Retry-After"), h.get("traceparent"), payload))
        s, _h, payload = _post(port, b"{not json")
        out.append((s, sorted(payload)))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            detail = json.loads(r.read())
        out.append(("healthz", r.status, detail["degraded"], sorted(detail["admission"])))
        with socket.create_connection(("127.0.0.1", port), timeout=10) as sock:
            sock.sendall(b"POST /submit HTTP/1.1\r\nHost: t\r\n"
                         b"Content-Length: 10737418240\r\n\r\n")
            out.append(sock.recv(65536).split(b"\r\n", 1)[0])
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/state", timeout=10) as r:
            state = json.loads(r.read())
        out.append(("state", r.status, sorted(state), sorted(state["journal"]),
                    sorted(state["degradation"]), state["journal"]["appended"]))
        req = urllib.request.Request(f"http://127.0.0.1:{port}/metrics", data=b"x",
                                     method="POST")
        try:
            urllib.request.urlopen(req, timeout=10)
        except urllib.error.HTTPError as e:
            out.append(("metrics-post", e.code))
        adm.close()
        s, _h, payload = _post(port, body(side.synth.make_pods(1, seed=22, name_prefix="v-")))
        out.append((s, payload))
    finally:
        side.http.stop_http_server(server)
        st.journal.close()
    return out


def test_http_submit_and_debug_state_answer_as_the_reference(tmp_path):
    got = _http_sequence(PORT, str(tmp_path / "port"))
    want = _http_sequence(REF, str(tmp_path / "ref"))
    assert got == want
    assert [x[0] for x in got[:4]] == [200, 429, 400, 400]
    assert got[0][2] == "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    assert got[1][1] == "1" and got[-1][0] == 503 and b"413" in got[5]
