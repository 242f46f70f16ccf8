"""Health, metrics and flight-recorder debug HTTP endpoints
(`k8s_scheduler_tpu/cmd/httpserver.py`).

Probes and dashboards expect /healthz and Prometheus /metrics; on top of
them the cycle flight recorder (core/flight_recorder.py) is exposed for
production debugging:

- `/healthz`, `/readyz`, `/livez` — the health closure's verdict (200 or
  503) and detail (`staleness_healthz`: the last cycle's age, the SLO burn
  status, the degradation rung);
- `/metrics` — the Prometheus text exposition of the `SchedulerMetrics`
  registry (`SchedulerMetrics.expose`);
- `/debug/flightrecorder?last=N` — the last N cycle records as JSON plus
  the derived window stats;
- `/debug/traces?last=N|pod=<uid>|trace=<id>` — a Chrome-trace/Perfetto
  JSON download of the pipeline's overlapped lanes; `pod=` slices to the
  cycles that touched that pod (joined through the pod timeline's
  per-attempt cycle seqs), `trace=` to the cycles stamped with that trace
  id. `/debug/trace` is the deprecated alias (same handler, `Deprecation`
  header);
- `/debug/explain?pod=<uid>` — the pod's state, its attempts, the
  first-rejecting plugin of each failed one, and the anomalies that
  overlapped its cycles;
- `/debug/pods/<uid>` — the per-pod scheduling timeline;
- `/debug/anomalies?last=N[&tenant=<id>]` — the cycle observer's typed
  anomaly ring with per-tenant counts and its status.

The reference's routes over sources this package does not have yet
(durable state's /debug/state, the metrics history's /debug/metrics/history
and /debug/dashboard, the alert rules' /debug/alerts, the admission front
door's POST /submit; ROADMAP A10b) answer as the reference's do when their
source is not configured: 404, and 405 for the POST.

Served with the stdlib http.server on a daemon thread that
`stop_http_server` joins. HEAD is answered for every GET route; any other
method gets 405 with an Allow header."""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from ..metrics import SchedulerMetrics


def _parse_last(query: str, default: int = 128) -> int:
    try:
        v = int(urllib.parse.parse_qs(query).get("last", [default])[0])
    except (TypeError, ValueError):
        return default
    return max(1, min(v, 65536))


def staleness_healthz(
    base: Callable[[], dict] | None,
    recorder,
    max_age_seconds: float,
    observer=None,  # core/observe.CycleObserver | None
    ladder=None,  # core/degrade.DegradationLadder | None
) -> Callable[[], tuple[bool, dict]]:
    """Health closure with flight-recorder staleness: reports
    `last_cycle_age_s` and flips to not-ok (503) once no scheduling cycle
    completed within `max_age_seconds` (0 = never stale). Before the first
    cycle the age anchors at the recorder's creation, so a scheduler wedged
    during startup also goes unhealthy. With an `observer` the payload
    carries the SLO burn status and `degraded: true` on a fast-window burn
    (still 200: budget burn is a paging signal); with a `ladder` the
    current degradation rung, and any rung below `normal` also reports
    `degraded: true` (still 200: the ladder is recovering)."""

    def healthz() -> tuple[bool, dict]:
        detail = dict(base()) if base is not None else {}
        ok = True
        if recorder is not None:
            age = recorder.last_cycle_age_s()
            detail["last_cycle_age_s"] = round(age, 3)
            detail["cycles"] = recorder.cycles
            if max_age_seconds > 0 and age > max_age_seconds:
                ok = False
                detail["reason"] = (
                    f"no cycle completed in {age:.1f}s "
                    f"(deadline {max_age_seconds:g}s)"
                )
        if observer is not None:
            detail.update(observer.healthz_detail())
        if ladder is not None:
            st = ladder.status()
            detail["degradation"] = st
            if st["rung"] > 0:
                detail["degraded"] = True
                detail.setdefault(
                    "degraded_reason",
                    f"degradation ladder at rung {st['rung']} "
                    f"({st['name']}): {st['last_reason']}",
                )
        return ok, detail

    return healthz


def _json(status: int, payload) -> tuple[int, str, bytes, dict[str, str]]:
    return status, "application/json", json.dumps(payload).encode(), {}


def start_http_server(
    metrics: SchedulerMetrics,
    port: int = 10251,
    host: str = "127.0.0.1",
    healthz: Callable[[], tuple[bool, dict]] | None = None,
    recorder=None,  # core/flight_recorder.FlightRecorder | None
    pod_timeline: Callable[[str], dict | None] | None = None,
    observer=None,  # core/observe.CycleObserver | None
) -> ThreadingHTTPServer:
    """Serve /healthz, /readyz, /metrics and the /debug endpoints; returns
    the running server (its port at `.server_address[1]`; port=0 picks
    one). `recorder` enables /debug/flightrecorder and /debug/traces (and
    the /debug/trace alias); `pod_timeline` (usually
    `Scheduler.pod_timeline`) enables /debug/pods/<uid>, /debug/explain
    and the /debug/traces?pod= filter; `observer` enables
    /debug/anomalies."""
    health_fn = healthz or (lambda: (True, {}))

    class Handler(BaseHTTPRequestHandler):
        # (status, content_type, body, extra_headers)
        def _route(self) -> tuple[int, str, bytes, dict[str, str]]:
            parts = urllib.parse.urlsplit(self.path)
            path, query = parts.path, parts.query
            if path in ("/healthz", "/readyz", "/livez"):
                ok, detail = health_fn()
                return _json(200 if ok else 503, {"ok": ok, **detail})
            if path == "/metrics":
                return (200, "text/plain; version=0.0.4; charset=utf-8",
                        metrics.expose(), {})
            if path == "/debug/flightrecorder" and recorder is not None:
                last = _parse_last(query)
                return _json(200, {"cycles": recorder.to_dicts(last=last),
                                   "derived": recorder.derived(last=last)})
            if path in ("/debug/trace", "/debug/traces") and recorder is not None:
                status, ctype, body, extra = self._trace_route(query)
                if path == "/debug/trace" and status == 200:
                    extra = dict(extra, Deprecation="true",
                                 Link='</debug/traces>; rel="successor-version"')
                return status, ctype, body, extra
            if path == "/debug/explain" and pod_timeline is not None:
                uid = (urllib.parse.parse_qs(query).get("pod") or [""])[0]
                return self._explain_route(uid)
            if path == "/debug/anomalies" and observer is not None:
                return self._anomalies_route(query)
            if path.startswith("/debug/pods/") and pod_timeline is not None:
                uid = urllib.parse.unquote(path[len("/debug/pods/"):])
                tl = pod_timeline(uid) if uid else None
                if tl is None:
                    return _json(404, {"error": f"pod {uid!r} not seen"})
                return _json(200, tl)
            return 404, "text/plain", b"not found", {}

        def _anomalies_route(self, query: str):
            events = observer.anomalies(last=_parse_last(query))
            tenant = (urllib.parse.parse_qs(query).get("tenant") or [""])[0]
            tenant_counts: dict[str, int] = {}
            for ev in events:
                t = ev.get("detail", {}).get("tenant", "")
                if t:
                    tenant_counts[t] = tenant_counts.get(t, 0) + 1
            if tenant:
                events = [ev for ev in events
                          if ev.get("detail", {}).get("tenant", "") == tenant]
            return _json(200, {"anomalies": events, "tenant": tenant or None,
                               "tenant_counts": tenant_counts, **observer.status()})

        def _trace_route(self, query: str):
            """The Perfetto download: `pod=` slices the records to the
            cycles that touched the pod, `trace=` to one trace id; a
            filtered trace defaults to the whole ring, an unfiltered one to
            the last 128 records."""
            from ..core.flight_recorder import to_chrome_trace

            qs = urllib.parse.parse_qs(query)
            pod_uid = (qs.get("pod") or [""])[0]
            trace_id = (qs.get("trace") or [""])[0]
            if "last" in qs:
                last: int | None = _parse_last(query)
            else:
                last = None if (pod_uid or trace_id) else 128
            recs = recorder.snapshot(last=last)
            if pod_uid:
                if pod_timeline is None:
                    return 404, "text/plain", b"pod filter needs the pod timeline", {}
                tl = pod_timeline(pod_uid)
                if tl is None:
                    return _json(404, {"error": f"pod {pod_uid!r} not seen"})
                seqs = {e["cycle"] for e in tl.get("events", ())
                        if e.get("cycle", -1) >= 0}
                recs = [r for r in recs if r.seq in seqs]
            if trace_id:
                recs = [r for r in recs if trace_id in r.trace_ids]
            trace = to_chrome_trace(recs, epoch=recorder.epoch)
            return (200, "application/json", json.dumps(trace).encode(),
                    {"Content-Disposition": 'attachment; filename="scheduler-trace.json"'})

        def _explain_route(self, uid: str):
            """Why is (was) this pod pending: its state, attempts, the
            first-rejecting plugin of each failed attempt, and the
            anomalies of its cycles."""
            if not uid:
                return _json(400, {"error": "missing ?pod=<uid>"})
            tl = pod_timeline(uid)
            if tl is None:
                return _json(404, {"error": f"pod {uid!r} not seen"})
            attempts = tl.get("attempts", [])
            reject_counts: dict[str, int] = {}
            for a in attempts:
                if a.get("result") == "Unschedulable":
                    plug = a.get("plugin", "") or "<unattributed>"
                    reject_counts[plug] = reject_counts.get(plug, 0) + 1
            rejectors = [a.get("plugin", "") for a in attempts
                         if a.get("result") == "Unschedulable" and a.get("plugin")]
            cycles = {e["cycle"] for e in tl.get("events", ()) if e.get("cycle", -1) >= 0}
            payload: dict = {
                "uid": uid,
                "name": tl.get("name", ""),
                "state": tl.get("state", "Pending"),
                "attempts": attempts,
                "reject_counts": reject_counts,
                "first_rejector": rejectors[0] if rejectors else "",
                "last_rejector": rejectors[-1] if rejectors else "",
            }
            if observer is not None:
                payload["anomalies"] = [a for a in observer.anomalies(last=512)
                                        if a.get("seq", -1) in cycles]
            return _json(200, payload)

        def _respond(self, include_body: bool) -> None:
            status, ctype, body, extra = self._route()
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra.items():
                self.send_header(k, v)
            self.end_headers()
            if include_body:
                self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib casing)
            self._respond(include_body=True)

        def do_HEAD(self):  # noqa: N802 (probes commonly use HEAD)
            self._respond(include_body=False)

        def _method_not_allowed(self):
            body = b"method not allowed"
            self.send_response(405)
            self.send_header("Allow", "GET, HEAD")
            self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        # a read-only surface: every mutating verb is a client error (405 +
        # Allow), not the stdlib's 501
        do_POST = _method_not_allowed  # noqa: N815
        do_PUT = _method_not_allowed  # noqa: N815
        do_DELETE = _method_not_allowed  # noqa: N815
        do_PATCH = _method_not_allowed  # noqa: N815
        do_OPTIONS = _method_not_allowed  # noqa: N815

        def log_message(self, fmt, *args):  # probes are noisy
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    # the serve thread is pinned on the server so that stop_http_server can
    # join it
    server._serve_thread = threading.Thread(
        target=server.serve_forever, name="http-metrics", daemon=True)
    server._serve_thread.start()
    return server


def stop_http_server(server: ThreadingHTTPServer, timeout: float = 5.0) -> bool:
    """Shut the serve loop down, join its thread, close the listening
    socket. False when the thread did not exit within `timeout` (the socket
    is closed either way). A second call is a no-op."""
    thread = getattr(server, "_serve_thread", None)
    server.shutdown()
    if thread is not None:
        thread.join(timeout)
        alive = thread.is_alive()
        server._serve_thread = None
    else:
        alive = False
    server.server_close()
    return not alive
