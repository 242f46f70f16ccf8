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
  JSON download of the pipeline's overlapped lanes, with the per-pod
  trace-span tracks (core/spans.py) merged in when a span recorder is
  given; `pod=` slices to the cycles that touched that pod (joined
  through the pod timeline's per-attempt cycle seqs and the spans' seq
  attrs) and to its spans, `trace=` to the cycles and spans of one trace
  id. `/debug/trace` is the deprecated alias (same handler, `Deprecation`
  header);
- `/debug/explain?pod=<uid>` — the pod's state, its attempts, the
  first-rejecting plugin of each failed one, its trace spans' durations,
  the front door's shed/retry history, and the anomalies that overlapped
  its cycles;
- `/debug/pods/<uid>` — the per-pod scheduling timeline;
- `/debug/anomalies?last=N[&tenant=<id>]` — the cycle observer's typed
  anomaly ring with per-tenant counts and its status;
- `/debug/state` — durable-state health (journal lag and segments, fsync
  latency, last snapshot and last restore) with the degradation ladder's
  transition ring, when a `DurableState` is given;
- `/debug/metrics/history?family=&labels=k=v,...&window=&step=` — the
  in-process metrics history (metrics/tsdb.py): raw points (step<1) or
  1 s / 1 m aggregate buckets; without `family` the stored-series
  inventory;
- `/debug/alerts` — active and resolved alert-rule firings with their wall
  timestamps, and every rule's state (metrics/rules.py);
- `/debug/dashboard` — a dependency-free HTML sparkline page over the
  history API (inline SVG, no external assets); 404 when `dashboard` is
  off;
- `POST /submit` — the front door's thin HTTP path: a JSON body
  `{"pods": [<state/codec pod dicts>]}` admitted through the
  `AdmissionController` (200 on accept, 429 + Retry-After on shed, 400 on
  invalid pods, 413 past the body cap, 503 while draining), a W3C
  `traceparent` request header joining the submission's trace and the
  effective traceparent echoed as a response header.

A route whose source is not given answers 404, as the reference's do.

Served with the stdlib http.server on a daemon thread that
`stop_http_server` joins. HEAD is answered for every GET route; any other
method gets 405 with an Allow header."""

from __future__ import annotations

import json
import math
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from ..metrics import SchedulerMetrics

# POST /submit body cap (the gRPC default's 4 MB message limit): the front
# door's bounded-memory contract holds on the HTTP path too — a giant
# Content-Length is refused before any read
_MAX_SUBMIT_BODY_BYTES = 4 << 20


# /debug/dashboard: dependency-free sparkline page over the history
# API. Inline SVG + fetch() only — no external assets, so it renders
# from an airgapped box exactly like every other debug endpoint.
_DASHBOARD_HTML = b"""<!doctype html>
<html><head><meta charset="utf-8"><title>scheduler watchtower</title>
<style>
 body{font:13px monospace;background:#111;color:#ddd;margin:1em}
 h1{font-size:15px} .fam{display:inline-block;width:340px;margin:4px;
 padding:6px;background:#1b1b1b;border:1px solid #333;vertical-align:top}
 .fam b{display:block;font-size:11px;overflow:hidden;white-space:nowrap}
 .lbl{color:#8a8;font-size:10px} .val{color:#fc6;float:right}
 svg{width:100%;height:42px;background:#161616}
 polyline{fill:none;stroke:#6cf;stroke-width:1}
 #alerts{padding:6px;margin:4px}
 .firing{color:#f66;font-weight:bold} .quiet{color:#6a6}
</style></head><body>
<h1>scheduler watchtower &mdash; metrics history + alerts</h1>
<div id="alerts">loading alerts&hellip;</div>
<div id="grid">loading series&hellip;</div>
<script>
const W=330,H=42;
function spark(pts){
 if(pts.length<2)return'<svg></svg>';
 const xs=pts.map(p=>p[0]),ys=pts.map(p=>p[p.length>2?5:1]);
 const x0=Math.min(...xs),x1=Math.max(...xs);
 const y0=Math.min(...ys),y1=Math.max(...ys);
 const pl=pts.map((p,i)=>{
  const x=(xs[i]-x0)/Math.max(x1-x0,1e-9)*W;
  const y=H-2-(ys[i]-y0)/Math.max(y1-y0,1e-9)*(H-4);
  return x.toFixed(1)+','+y.toFixed(1)}).join(' ');
 return'<svg viewBox="0 0 '+W+' '+H+'"><polyline points="'+pl+
  '"/></svg>';
}
async function drawAlerts(){
 try{
  const a=await(await fetch('/debug/alerts')).json();
  const act=a.active||[];
  document.getElementById('alerts').innerHTML=act.length
   ?'<span class="firing">FIRING: '+act.map(x=>x.rule+' ['+x.severity+
     '] value='+Number(x.value).toPrecision(4)).join(' &middot; ')+
     '</span>'
   :'<span class="quiet">no active alerts ('+
     (a.fired_total||0)+' lifetime firings, '+
     (a.resolved||[]).length+' resolved in window)</span>';
 }catch(e){
  document.getElementById('alerts').textContent=
   'alerts endpoint unavailable';
 }
}
async function draw(){
 const inv=await(await fetch('/debug/metrics/history')).json();
 const fams=(inv.families||[]).slice(0,48);
 const out=[];
 for(const f of fams){
  const q=await(await fetch('/debug/metrics/history?family='+
   encodeURIComponent(f.family)+'&window=900&step=1')).json();
  for(const s of (q.series||[]).slice(0,4)){
   const pts=s.points||[];if(!pts.length)continue;
   const last=pts[pts.length-1];
   const v=last[last.length>2?5:1];
   const lbl=Object.entries(s.labels||{}).map(([k,x])=>k+'='+x)
    .join(',');
   out.push('<div class="fam"><b>'+f.family+
    '<span class="val">'+Number(v).toPrecision(5)+'</span></b>'+
    '<span class="lbl">'+(lbl||'&nbsp;')+'</span>'+spark(pts)+
    '</div>');
  }
 }
 document.getElementById('grid').innerHTML=
  out.join('')||'no series stored yet';
}
drawAlerts();draw();setInterval(()=>{drawAlerts();draw()},15000);
</script></body></html>
"""


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
    admission=None,  # service/admission.AdmissionController | None
) -> Callable[[], tuple[bool, dict]]:
    """Health closure with flight-recorder staleness: reports
    `last_cycle_age_s` and flips to not-ok (503) once no scheduling cycle
    completed within `max_age_seconds` (0 = never stale). Before the first
    cycle the age anchors at the recorder's creation, so a scheduler wedged
    during startup also goes unhealthy. With an `observer` the payload
    carries the SLO burn status and `degraded: true` on a fast-window burn
    (still 200: budget burn is a paging signal); with a `ladder` the
    current degradation rung, and any rung below `normal` also reports
    `degraded: true` (still 200: the ladder is recovering); with an
    `admission` controller its status, and `degraded: true` while the
    front door would shed an arriving submission right now."""

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
        if admission is not None:
            detail["admission"] = admission.status()
            shed_now = admission.overloaded()
            if shed_now:
                detail["degraded"] = True
                detail.setdefault("degraded_reason", f"admission shedding: {shed_now}")
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
    state=None,  # state.DurableState | None
    observer=None,  # core/observe.CycleObserver | None
    admission=None,  # service/admission.AdmissionController | None
    spans_recorder=None,  # core/spans.SpanRecorder | None
    tsdb=None,  # metrics/tsdb.MetricsTSDB | None
    alerts=None,  # metrics/rules.RuleEngine | None
    dashboard: bool = True,
) -> ThreadingHTTPServer:
    """Serve /healthz, /readyz, /metrics and the /debug endpoints; returns
    the running server (its port at `.server_address[1]`; port=0 picks
    one). `recorder` enables /debug/flightrecorder and /debug/traces (and
    the /debug/trace alias); `pod_timeline` (usually
    `Scheduler.pod_timeline`) enables /debug/pods/<uid>, /debug/explain
    and the /debug/traces?pod= filter; `state` enables /debug/state;
    `observer` enables /debug/anomalies; `admission` enables
    `POST /submit`; `spans_recorder` (the armed span ring) merges the
    per-pod trace tracks into /debug/traces and the span durations into
    /debug/explain; `tsdb` (the armed metrics history) enables
    /debug/metrics/history and, unless `dashboard` is False,
    /debug/dashboard; `alerts` (the rules engine) enables /debug/alerts."""
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
            if path == "/debug/metrics/history" and tsdb is not None:
                return self._history_route(query)
            if path == "/debug/alerts" and alerts is not None:
                return _json(200, alerts.status())
            if path == "/debug/dashboard" and tsdb is not None and dashboard:
                return 200, "text/html; charset=utf-8", _DASHBOARD_HTML, {}
            if path == "/debug/state" and state is not None:
                return _json(200, state.status())
            if path.startswith("/debug/pods/") and pod_timeline is not None:
                uid = urllib.parse.unquote(path[len("/debug/pods/"):])
                tl = pod_timeline(uid) if uid else None
                if tl is None:
                    return _json(404, {"error": f"pod {uid!r} not seen"})
                return _json(200, tl)
            return 404, "text/plain", b"not found", {}

        def _history_route(self, query: str):
            """The metrics-history query surface: `family=` one family
            (absent: the stored-series inventory), `labels=k=v,k2=v2` a
            subset selector, `window=` seconds back from now (default 300),
            `step=` the tier (>=60 -> 1 m buckets, >=1 -> 1 s, else raw)."""
            qs = urllib.parse.parse_qs(query)
            family = (qs.get("family") or [""])[0]
            if not family:
                return _json(200, {"families": tsdb.families(), **tsdb.status()})
            labels: dict[str, str] = {}
            for pair in (qs.get("labels") or [""])[0].split(","):
                if "=" in pair:
                    k, _, v = pair.partition("=")
                    labels[k.strip()] = v.strip()
            try:
                window = float((qs.get("window") or ["300"])[0])
                step = float((qs.get("step") or ["0"])[0])
            except ValueError:
                return _json(400, {"error": "window/step must be numbers"})
            return _json(200, tsdb.query(family, labels=labels, window_s=window,
                                         step_s=step))

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
            span_list = None
            if spans_recorder is not None:
                if trace_id:
                    span_list = spans_recorder.for_trace(trace_id)
                elif pod_uid:
                    span_list = spans_recorder.for_uid(pod_uid)
                else:
                    span_list = spans_recorder.snapshot()
            if pod_uid:
                if pod_timeline is None:
                    return 404, "text/plain", b"pod filter needs the pod timeline", {}
                tl = pod_timeline(pod_uid)
                if tl is None and not span_list:
                    return _json(404, {"error": f"pod {pod_uid!r} not seen"})
                seqs = {e["cycle"] for e in (tl or {}).get("events", ())
                        if e.get("cycle", -1) >= 0}
                # spans carry the cycle seq as their exemplar attr: the
                # reverse join keeps the cycles when the timeline aged out
                for sp in span_list or ():
                    if sp.attrs.get("seq", -1) >= 0:
                        seqs.add(sp.attrs["seq"])
                recs = [r for r in recs if r.seq in seqs]
            if trace_id:
                recs = [r for r in recs if trace_id in r.trace_ids]
            trace = to_chrome_trace(recs, epoch=recorder.epoch, spans=span_list)
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
            if admission is not None:
                # the front door's shed/retry history (present even when
                # tracing is unarmed)
                payload["admission_history"] = admission.history_for(uid)
            if spans_recorder is not None:
                sp = spans_recorder.for_uid(uid)
                payload["spans"] = [x.to_dict(epoch=spans_recorder.epoch) for x in sp]
                totals: dict[str, float] = {}
                for x in sp:
                    totals[x.name] = totals.get(x.name, 0.0) + max(x.t1 - x.t0, 0.0) * 1e3
                payload["span_totals_ms"] = {k: round(v, 4) for k, v in totals.items()}
                payload["trace_ids"] = sorted({x.trace_id for x in sp})
                for x in sp:
                    if x.attrs.get("seq", -1) >= 0:
                        cycles.add(x.attrs["seq"])
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

        def _submit_route(self) -> tuple[int, bytes, dict[str, str]]:
            """POST /submit: pods travel as state/codec dicts (the
            journal's own pod format), so the HTTP wire needs no second
            codec."""
            from ..state.codec import pod_from_state

            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length > _MAX_SUBMIT_BODY_BYTES:
                    return (413, json.dumps({"error": "submission body too large",
                                             "max_bytes": _MAX_SUBMIT_BODY_BYTES}).encode(),
                            {})
                body = json.loads(self.rfile.read(length) or b"{}")
                pods = [pod_from_state(d) for d in body.get("pods", ())]
            except (ValueError, KeyError, TypeError) as e:
                return 400, json.dumps({"error": f"unparseable submission: {e}"}).encode(), {}
            res = admission.submit(pods, traceparent=self.headers.get("traceparent", ""))
            payload = {
                "accepted": res.accepted,
                "shed": res.shed,
                "invalid": list(res.invalid),
                "reason": res.reason,
                "durable": res.durable,
                "queue_depth": res.queue_depth,
            }
            if res.invalid:
                status, extra = 400, {}
            elif res.reason == "draining":
                status, extra = 503, {}
            elif res.shed:
                # RFC 7231 delta-seconds is an integer: the hint rounds up
                status = 429
                extra = {"Retry-After": str(max(1, math.ceil(res.retry_after_ms / 1e3)))}
            else:
                status, extra = 200, {}
            if res.traceparent:
                # the effective trace context (the caller's own header, or
                # the head-sampled root the scheduler minted)
                extra = dict(extra, traceparent=res.traceparent)
            return status, json.dumps(payload).encode(), extra

        def do_POST(self):  # noqa: N802 — the one mutating route
            if admission is None or urllib.parse.urlsplit(self.path).path != "/submit":
                self._method_not_allowed()
                return
            status, body, extra = self._submit_route()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        # every other mutating verb is a client error on a read-only
        # surface (405 + Allow), not the stdlib's 501
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
