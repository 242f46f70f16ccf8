"""The port's process layer (`k8s_scheduler_tpu_torch/cmd/`) against the
reference's (`tests/test_cmd.py`): the health, metrics and debug HTTP
server, the Prometheus exposition, and the file-lease leader election.

Both packages' servers serve a Scheduler fed the same event sequence
(`test_torch_scheduler.drive`, the reference pipeline workload on the
carry path). Every route answers with the same status, and the same JSON
but for the fields that read a wall clock (the flight recorder and the
pod timelines stamp perf_counter / time.time; the observer's phase
statistics and anomaly detectors feed on those): `WALL_FIELDS` names
them. /metrics, parsed into (sample, labels) -> value, agrees on every
counter, every gauge but the wall-clock ones (`WALL_GAUGES`) and every
histogram and summary count, over the families both packages have (the
reference's families of modules the port does not have yet are
`UNPORTED_FAMILIES`)."""

from __future__ import annotations

import functools
import json
import multiprocessing
import os
import time
import urllib.error
import urllib.request

import pytest
from prometheus_client.parser import text_string_to_metric_families

import k8s_scheduler_tpu.cmd.httpserver as ref_http
from k8s_scheduler_tpu_torch.cmd.httpserver import (staleness_healthz, start_http_server,
                                                    stop_http_server)
from k8s_scheduler_tpu_torch.cmd.leaderelection import FileLease
from k8s_scheduler_tpu_torch.core.flight_recorder import FlightRecorder
from k8s_scheduler_tpu_torch.metrics import SchedulerMetrics
from test_torch_scheduler import ENCODER_PATH_COUNTS, drive
from torch_one_thread import one_torch_thread  # noqa: F401

# JSON fields whose values come from a wall clock, never compared
WALL_FIELDS = ("t_s", "wall", "wall_start", "t_start_s", "t_end_s", "marks_s", "phases_ms",
               "derived", "last_cycle_age_s", "phase_p50_ms", "phase_p99_ms", "slo",
               "anomalies", "ring_events")
# gauges that read a clock at scrape time or feed on wall-timed phases
WALL_GAUGES = ("scheduler_uptime_seconds", "scheduler_last_cycle_age_seconds",
               "scheduler_cycle_phase_p50_seconds", "scheduler_cycle_phase_p99_seconds",
               "scheduler_pipeline_overlap_ratio", "scheduler_slo_burn_rate",
               "scheduler_slo_error_budget_remaining", "scheduler_build_info")
# the reference's families these servers' schedulers do not feed alike
# (durable state, admission, spans) or of modules not ported yet (ROADMAP
# A12: tenancy); the multi-cycle families are compared
UNPORTED_FAMILIES = ("scheduler_admission", "scheduler_journal", "scheduler_snapshot",
                     "scheduler_submit", "scheduler_tenan",
                     "scheduler_trace_spans")


def _request(url, method="GET"):
    req = urllib.request.Request(url, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _strip(v):
    """`v` without the wall-clock fields, recursively."""
    if isinstance(v, dict):
        return {k: _strip(x) for k, x in v.items() if k not in WALL_FIELDS}
    if isinstance(v, list):
        return [_strip(x) for x in v]
    return v


# ---- both packages' servers over one scheduler sequence ---------------------


@functools.cache
def _served():
    """{side: (scheduler, the binds it made)} after the reference pipeline
    workload on the carry path."""
    out = {}
    for side in ("ref", "port"):
        keep: list = []
        cycles = drive(side, "pipeline_workload", "rounds", keep=keep)
        out[side] = (keep[0], sum(len(c["binds"]) for c in cycles))
    return out


@pytest.fixture(scope="module")
def servers():
    urls = {}
    started = []
    for side, (s, _) in _served().items():
        mod = ref_http if side == "ref" else None
        start = ref_http.start_http_server if side == "ref" else start_http_server
        health = (ref_http.staleness_healthz if side == "ref" else staleness_healthz)(
            None, s.flight, 0.0, s.observer, s.ladder)
        srv = start(s.metrics, port=0, healthz=health, recorder=s.flight,
                    pod_timeline=s.pod_timeline, observer=s.observer)
        started.append((mod, srv))
        urls[side] = f"http://127.0.0.1:{srv.server_address[1]}"
    yield urls
    for mod, srv in started:
        (ref_http.stop_http_server if mod else stop_http_server)(srv)


ROUTES = ["/healthz", "/readyz", "/livez", "/debug/flightrecorder?last=4",
          "/debug/flightrecorder?last=banana", "/debug/explain?pod=default/pre",
          "/debug/explain?pod=default/huge", "/debug/explain", "/debug/explain?pod=ghost",
          "/debug/pods/default/hi0", "/debug/pods/default/huge", "/debug/pods/ghost",
          "/debug/anomalies?last=8", "/debug/anomalies?tenant=t0",
          "/debug/state", "/debug/metrics/history", "/debug/dashboard", "/debug/alerts",
          "/nope", "/debug/traces?pod=ghost"]


@pytest.mark.parametrize("route", ROUTES)
def test_routes_answer_as_the_reference(servers, route):
    want = _request(servers["ref"] + route)
    got = _request(servers["port"] + route)
    assert got[0] == want[0], route
    if want[1].get("Content-Type", "").startswith("application/json"):
        assert got[1]["Content-Type"] == want[1]["Content-Type"]
        w, g = json.loads(want[2]), json.loads(got[2])
        if isinstance(w.get("cycles"), list):  # the encoder's path counters may differ
            for c in w["cycles"] + g["cycles"]:
                for k in ENCODER_PATH_COUNTS:
                    c["counts"].pop(k, None)
        assert _strip(g) == _strip(w), route
        assert set(g) == set(w), route
    else:
        assert got[2] == want[2], route


@pytest.mark.parametrize("route", ["/debug/traces?last=16", "/debug/trace?last=16",
                                   "/debug/traces?pod=default/pre", "/debug/traces?trace=x"])
def test_traces_answer_as_the_reference(servers, route):
    want = _request(servers["ref"] + route)
    got = _request(servers["port"] + route)
    assert got[0] == want[0] == 200
    for h in ("Content-Disposition", "Deprecation", "Link"):
        assert got[1].get(h) == want[1].get(h), h
    lanes = [sorted((e.get("name"), e.get("ph"), e.get("tid"))
                    for e in json.loads(b)["traceEvents"]) for b in (got[2], want[2])]
    assert lanes[0] == lanes[1]


@pytest.mark.parametrize("method", ["POST", "PUT", "DELETE", "PATCH", "HEAD"])
@pytest.mark.parametrize("route", ["/healthz", "/metrics", "/submit", "/nope"])
def test_methods_answer_as_the_reference(servers, method, route):
    want = _request(servers["ref"] + route, method)
    got = _request(servers["port"] + route, method)
    assert got[0] == want[0]
    assert got[1].get("Allow") == want[1].get("Allow")
    if method == "HEAD":  # headers alone
        assert got[2] == b"" == want[2]


def _samples(text: str) -> dict:
    out = {}
    for f in text_string_to_metric_families(text):
        for s in f.samples:
            out[(f.type, f.name, s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


def _comparable(key) -> bool:
    ftype, family, sample, _ = key
    if family.startswith(UNPORTED_FAMILIES) or sample.endswith("_created"):
        return False
    if ftype in ("counter",):
        return True
    if ftype == "gauge":
        return family not in WALL_GAUGES
    return sample.endswith("_count")  # histogram and summary counts


def test_metrics_match_the_reference(servers):
    want = _samples(_request(servers["ref"] + "/metrics")[2].decode())
    got = _samples(_request(servers["port"] + "/metrics")[2].decode())
    w = {k: v for k, v in want.items() if _comparable(k)}
    g = {k: v for k, v in got.items() if _comparable(k)}
    assert g == w
    assert {k[1] for k in got} <= {k[1] for k in want}
    # the bind counter counts the binds the API server saw
    _, n_binds = _served()["port"]
    scheduled = sum(v for k, v in got.items()
                    if k[2] == "scheduler_schedule_attempts_total"
                    and ("result", "scheduled") in k[3])
    assert scheduled == n_binds > 0


# ---- the reference's own cases (tests/test_cmd.py) --------------------------


def test_http_endpoints_serve_health_and_metrics():
    m = SchedulerMetrics()
    m.decisions.inc(42)
    server = start_http_server(m, port=0, healthz=lambda: (True, {"x": 1}))
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        st, _, body = _request(base + "/healthz")
        assert st == 200 and json.loads(body) == {"ok": True, "x": 1}
        st, headers, body = _request(base + "/metrics")
        assert st == 200 and headers["Content-Type"].startswith("text/plain; version=0.0.4")
        assert "scheduler_pod_node_decisions_total 42.0" in body.decode()
        assert _request(base + "/nope")[0] == 404
    finally:
        stop_http_server(server)


def test_debug_endpoints_serve_flightrecorder_trace_and_pods():
    fr = FlightRecorder(capacity=16)
    for i in range(4):
        rec = fr.start()
        rec.mark("dispatch_start", rec.t_start + 0.001)
        rec.mark("decision_end", rec.t_start + 0.004)
        rec.phases["encode_ms"] = 1.0
        rec.counts["pods"] = 3 + i
        fr.commit(rec)
    fr.pod_event("uid-1", "pod-1", "Queued")
    fr.pod_event("uid-1", "pod-1", "Bound", cycle=3, node="n1")
    timelines = {"uid-1": {"uid": "uid-1", "name": "pod-1", "state": "Bound"}}
    server = start_http_server(SchedulerMetrics(), port=0, recorder=fr,
                               pod_timeline=timelines.get)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        st, _, body = _request(f"{base}/debug/flightrecorder?last=2")
        payload = json.loads(body)
        assert st == 200 and [c["seq"] for c in payload["cycles"]] == [2, 3]
        assert payload["derived"]["cycles"] == 4.0
        st, headers, body = _request(f"{base}/debug/trace?last=4")
        assert st == 200 and "attachment" in headers["Content-Disposition"]
        assert headers["Deprecation"] == "true"
        assert any(e["ph"] == "X" and e["name"].startswith("device cycle")
                   for e in json.loads(body)["traceEvents"])
        st, _, body = _request(f"{base}/debug/pods/uid-1")
        assert st == 200 and json.loads(body)["state"] == "Bound"
        assert _request(f"{base}/debug/pods/ghost")[0] == 404
        assert _request(f"{base}/debug/flightrecorder?last=banana")[0] == 200
    finally:
        stop_http_server(server)


def test_healthz_staleness_503_when_cycles_stop():
    t = {"now": 0.0}
    fr = FlightRecorder(capacity=4, now=lambda: t["now"])
    health = staleness_healthz(lambda: {"bootId": "b"}, fr, 5.0)
    server = start_http_server(SchedulerMetrics(), port=0, healthz=health)
    url = f"http://127.0.0.1:{server.server_address[1]}/healthz"
    try:
        t["now"] = 1.0
        st, _, body = _request(url)
        assert st == 200 and json.loads(body)["last_cycle_age_s"] == 1.0
        t["now"] = 6.0
        st, _, body = _request(url)
        assert st == 503 and "no cycle completed" in json.loads(body)["reason"]
        rec = fr.start()
        rec.t_end = t["now"]
        fr.commit(rec)
        st, _, body = _request(url)
        assert st == 200 and json.loads(body)["cycles"] == 1
        t["now"] = 20.0
        assert _request(url)[0] == 503
        ok, detail = staleness_healthz(None, fr, 0.0)()
        assert ok and detail["last_cycle_age_s"] == 14.0
    finally:
        stop_http_server(server)


def test_stop_http_server_joins_the_serve_thread():
    server = start_http_server(SchedulerMetrics(), port=0)
    thread = server._serve_thread
    assert thread is not None and thread.is_alive()
    port = server.server_address[1]
    assert stop_http_server(server) is True
    assert not thread.is_alive() and server._serve_thread is None
    with pytest.raises((urllib.error.URLError, OSError)):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=0.5)
    assert stop_http_server(server) is True


def _hold_lease(path, hold_seconds, acquired):
    lease = FileLease(path, identity="other")
    assert lease.try_acquire()
    acquired.set()
    time.sleep(hold_seconds)
    lease.release()


def test_file_lease_single_holder(tmp_path):
    path = str(tmp_path / "lease")
    ctx = multiprocessing.get_context("spawn")
    acquired = ctx.Event()
    proc = ctx.Process(target=_hold_lease, args=(path, 1.5, acquired))
    proc.start()
    try:
        assert acquired.wait(60)
        mine = FileLease(path, identity="me")
        # the lock is held by the other process: try_acquire fails
        assert not mine.try_acquire()
        holder = mine.holder()
        assert holder and holder["holderIdentity"] == "other"
        # blocks until the holder releases, then wins
        assert mine.acquire(timeout=30)
        assert mine.is_leader()
        mine.release()
        assert not mine.is_leader()
    finally:
        proc.join(timeout=30)
    assert not proc.is_alive() and proc.exitcode == 0


def test_lease_intra_process_exclusion_and_holder_keeps_lock(tmp_path):
    path = str(tmp_path / "lease")
    leader = FileLease(path, identity="leader")
    standby = FileLease(path, identity="standby")
    assert leader.try_acquire()
    try:
        assert not standby.try_acquire()  # same-process exclusion
        # holder() reads must not release the kernel lock
        assert leader.holder()["holderIdentity"] == "leader"
        assert standby.holder()["holderIdentity"] == "leader"
        assert not standby.try_acquire()
        assert leader.is_leader()
    finally:
        leader.release()
    assert standby.try_acquire()
    standby.release()


def test_lease_heartbeat_renews(tmp_path):
    lease = FileLease(str(tmp_path / "lease"), identity="hb", renew_seconds=0.05)
    assert lease.try_acquire()
    try:
        first = lease.holder()["renewTime"]
        lease.start_renewing()
        time.sleep(0.3)
        assert lease.holder()["renewTime"] > first
    finally:
        lease.release()


def test_lease_describe_and_leader_gauges(tmp_path):
    path = str(tmp_path / "lease")
    leader = FileLease(path, identity="the-leader")
    standby = FileLease(path, identity="the-standby")
    assert leader.try_acquire()
    try:
        d = leader.describe()
        assert d["leader"] and d["holder"] == "the-leader"
        assert d["age_s"] >= 0.0 and d["path"] == path
        ds = standby.describe()
        assert not ds["leader"] and ds["holder"] == "the-leader"
        m = SchedulerMetrics()
        m.leader_state.set_function(lambda: 1.0 if leader.is_leader() else 0.0)
        m.leader_lease_age.set_function(leader.lease_age_seconds)
        text = m.expose().decode()
        assert "scheduler_leader_state 1.0" in text
        assert "scheduler_leader_lease_age_seconds" in text
        ms = SchedulerMetrics()
        ms.leader_state.set_function(lambda: 1.0 if standby.is_leader() else 0.0)
        assert "scheduler_leader_state 0.0" in ms.expose().decode()
    finally:
        leader.release()
    assert FileLease(str(tmp_path / "nope")).lease_age_seconds() == 0.0


def test_lease_release_joins_the_renewer(tmp_path):
    path = str(tmp_path / "lease")
    lease = FileLease(path, identity="joiner", renew_seconds=0.05)
    assert lease.try_acquire()
    lease.start_renewing()
    renewer = lease._renewer
    assert renewer is not None and renewer.is_alive()
    lease.release()
    assert not renewer.is_alive() and lease._renewer is None
    # no heartbeat after the release: the file stops changing
    before = os.stat(path).st_mtime_ns
    time.sleep(0.2)
    assert os.stat(path).st_mtime_ns == before
