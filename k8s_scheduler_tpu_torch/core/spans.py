"""Pod-lifecycle tracing: span recorder, trace-context propagation (the
port's copy of `k8s_scheduler_tpu/core/spans.py`: the same span names,
traceparent format, sampling coin and exporters).

Every other observability surface is cycle-centric (flight records,
phase histograms, the anomaly sentinel); since the front door landed,
the unit of work users experience is a POD REQUEST: Submit ->
admission -> WAL ack barrier -> mc-group buffering -> (speculative)
dispatch -> inner-cycle decision row -> bind fold -> confirm. This
module makes that whole life one trace:

- `SpanRecorder` — a bounded ring of `Span`s with the same
  seqlock-style publication discipline as the cycle flight recorder
  (core/flight_recorder.FlightRecorder): a writer's cost is the span
  construction plus ONE list-slot store; readers copy the ring without
  blocking writers, retry while a commit tears the copy, and trim to
  the trailing window no commit could have torn. Unlike the flight
  recorder, spans are written from SEVERAL threads (gRPC/HTTP submit
  workers, the serve loop, informer threads); slot sequence numbers
  come from `itertools.count` (atomic in CPython), so concurrent
  writers never race a slot index read-modify-write.
- Arming — the fault-hook pattern (core/faults.py): a module
  global `ARMED` flag plus `arm()`/`disarm()`. Unarmed, every stamp
  site pays ONE module-attribute load and a falsy branch; armed, a
  stamp is dict stores into a Span plus the slot store. The scheduler
  never imports anything trace-specific on the unarmed path.
- Context propagation — `register(uid, traceparent)` binds a pod uid
  to a trace at admission time: an explicit W3C-style `traceparent`
  joins the caller's trace; absent one, deterministic head sampling
  (`sampled(uid)`, a uid-hash coin at the armed sample rate) decides
  per pod. The uid -> context map is the cross-thread join: spans
  emitted on the submit thread (validate/journal/ack), the serve
  thread (buffer wait, dispatch, decision row, apply fold, bind
  confirm) and anywhere else all look the context up by uid and land
  in ONE trace. `release(uid)` drops the binding at the pod's
  terminal event (bound / deleted).
- Export — `spans_to_chrome_events` renders per-trace tracks that
  `to_chrome_trace` merges into the cycle lanes (one Perfetto view
  shows a pod's spans overlapping the batch that served it), and
  `to_otlp_json` / `export_otlp_dir` produce OTLP-JSON resource spans
  for external ingestion (size-rotated).

`SPAN_NAMES` below is the pinned span inventory. Stdlib-only (no torch /
numpy) so the state layer, tools and tests can import it without a
device. The multi-cycle path stamps `mc.buffer_wait`, `encode.ingest`,
`flush.finalize` and `dispatch.speculative` (core/scheduler.py).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
import re
import threading
import time as _time
import uuid
from typing import Any, Callable, Iterable

# The pinned span-name inventory — every stamp site emits one of
# these. Grouped by the thread that stamps them:
#   submit thread:  submit.validate (request validation + dup check),
#                   submit.journal (the informer-path enqueue, which
#                   appends q.add through the WAL), ack.barrier (the
#                   group-commit fsync wait; one span PER SUBMITTER,
#                   all joined to the shared flush seq via the
#                   `flush_seq` attr)
#   serve thread:   mc.buffer_wait (admission -> multi-cycle flush),
#                   encode.ingest (admission-time incremental row
#                   staging), flush.finalize (the O(dirty) flush
#                   apply), dispatch (device dispatch window),
#                   dispatch.speculative (the depth-2 continuation;
#                   attr `outcome`: adopted | abandoned),
#                   decision.row (the inner cycle's slimmed row
#                   transfer), apply.fold (winner bind loop ->
#                   postfilter), bind.confirm (the pod's bind),
#                   preempt.victim (an eviction this pod's nomination
#                   caused; attrs name the victim)
SPAN_NAMES = (
    "submit.validate",
    "submit.journal",
    "ack.barrier",
    "mc.buffer_wait",
    "encode.ingest",
    "flush.finalize",
    "dispatch",
    "dispatch.speculative",
    "decision.row",
    "apply.fold",
    "bind.confirm",
    "preempt.victim",
)

# default head-sampling rate (absent an explicit traceparent): 1/64
DEFAULT_SAMPLE_RATE = 1.0 / 64.0

_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)

# uid -> TraceContext bound at most this deep (LRU): a pod parked
# unschedulable forever must not pin its context entry
_MAX_CONTEXTS = 65_536


@dataclasses.dataclass
class Span:
    """One completed operation in a pod's trace. Times are absolute
    recorder-clock seconds (perf_counter, the same clock the flight
    recorder stamps marks with, so span slices and cycle lanes rebase
    against one epoch). Spans are immutable once recorded — the ring
    replaces slots, it never mutates them."""

    trace_id: str  # 32 hex chars (W3C trace-id)
    span_id: str  # 16 hex chars
    parent: str  # 16 hex chars, "" for a root span
    name: str  # one of SPAN_NAMES
    t0: float
    t1: float
    seq: int = -1  # recorder slot sequence (assigned by record())
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self, epoch: float = 0.0) -> dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent": self.parent,
            "name": self.name,
            "t0_s": round(self.t0 - epoch, 6),
            "t1_s": round(self.t1 - epoch, 6),
            "dur_ms": round(max(self.t1 - self.t0, 0.0) * 1e3, 4),
            "attrs": dict(self.attrs),
        }


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """A pod's binding to a trace, created at admission. `span_id` is
    the parent every span emitted for the pod names: a locally minted
    root id for head-sampled pods, the caller's span id when an
    explicit traceparent joined us to an existing trace. `tenant` is
    the pod's virtual cluster ("" in single-tenant mode): every span
    recorded under the context inherits it as a `tenant` attr, so one
    trace view shows per-tenant lanes."""

    trace_id: str
    span_id: str
    tenant: str = ""

    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id)


# ---- W3C traceparent helpers --------------------------------------------


def parse_traceparent(value: str) -> "tuple[str, str] | None":
    """(trace_id, parent_span_id) from a W3C traceparent header, or
    None when malformed / all-zero (the spec's invalid sentinels)."""
    m = _TRACEPARENT_RE.match((value or "").strip().lower())
    if m is None:
        return None
    trace_id, span_id = m.group(1), m.group(2)
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def format_traceparent(trace_id: str, span_id: str) -> str:
    # flags 01: sampled (we only hold contexts for sampled pods)
    return f"00-{trace_id}-{span_id}-01"


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return os.urandom(8).hex()


def sampled(uid: str, rate: float) -> bool:
    """Deterministic head-sampling coin: the same uid at the same rate
    always decides the same way (a retry of a shed submission keeps
    its sampling fate), and distinct uids decide independently. rate
    >= 1 samples everything, <= 0 nothing."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    h = hashlib.blake2b(uid.encode(), digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0**64 < rate


# ---- the span ring -------------------------------------------------------


class SpanRecorder:
    """Bounded multi-writer ring of completed spans.

    Writer cost: one Span construction + one list-slot store (the
    slot index comes from an `itertools.count`, whose `next()` is
    atomic under CPython — concurrent submit/serve/informer threads
    never race an index increment). `_commits` publishes like the
    flight recorder's seqlock generation; its increment is a benign
    multi-writer race (a lost increment can only cost a reader one
    extra retry) because the snapshot's trailing-window trim — keep
    only the newest run of seqs no commit could have torn — is the
    correctness backstop, exactly as it is for FlightRecorder."""

    def __init__(
        self,
        capacity: int = 8192,
        now: Callable[[], float] = _time.perf_counter,
        wall: Callable[[], float] = _time.time,
    ) -> None:
        self.capacity = max(int(capacity), 1)
        self.now = now
        self._ring: "list[Span | None]" = [None] * self.capacity
        self._seq = itertools.count()
        self._commits = 0
        self.epoch = now()
        self.wall_epoch = wall()

    # ---- writer side -----------------------------------------------------

    def record(
        self,
        name: str,
        ctx: TraceContext,
        t0: float,
        t1: float,
        **attrs: Any,
    ) -> Span:
        """Record one completed span under `ctx` (parent = the
        context's root/caller span id). A tenant-scoped context stamps
        its tenant on every span it records — one stamp site, so no
        emitter can forget the attribution."""
        if ctx.tenant and "tenant" not in attrs:
            attrs["tenant"] = ctx.tenant
        span = Span(
            trace_id=ctx.trace_id,
            span_id=new_span_id(),
            parent=ctx.span_id,
            name=name,
            t0=t0,
            t1=t1,
            seq=next(self._seq),
            attrs=attrs,
        )
        self._ring[span.seq % self.capacity] = span
        # publish AFTER the slot store (GIL-ordered); see class doc
        # for why the racy increment is safe here
        self._commits += 1  # schedlint: disable=TR001 -- benign seqlock-generation race: the snapshot trim is the correctness backstop
        return span

    # ---- reader side -----------------------------------------------------

    @property
    def count(self) -> int:
        """Spans recorded (approximate under concurrent writers —
        monotonic, may trail by in-flight commits)."""
        return self._commits

    def snapshot(self, last: "int | None" = None) -> "list[Span]":
        """Consistent copy of the most recent `last` spans (oldest
        first). Same discipline as FlightRecorder.snapshot: retry the
        lock-free copy while a commit lands in it, then trim to the
        trailing contiguous-capacity window."""
        ring: "list[Span | None]" = []
        for _ in range(8):
            before = self._commits
            ring = list(self._ring)
            if self._commits == before:
                break
        spans = sorted(
            (s for s in ring if s is not None), key=lambda s: s.seq
        )
        if spans:
            spans = [
                s for s in spans
                if s.seq > spans[-1].seq - self.capacity
            ]
        if last is not None:
            n = max(int(last), 0)
            spans = spans[-n:] if n else []
        return spans

    def for_trace(self, trace_id: str) -> "list[Span]":
        return [s for s in self.snapshot() if s.trace_id == trace_id]

    def for_uid(self, uid: str) -> "list[Span]":
        """Spans whose `uid` attr names the pod — the /debug join for
        pods whose context has already been released."""
        return [
            s for s in self.snapshot() if s.attrs.get("uid") == uid
        ]

    def to_dicts(self, last: "int | None" = None) -> "list[dict]":
        return [s.to_dict(epoch=self.epoch) for s in self.snapshot(last)]


# ---- module arming (the fault-hook pattern) ------------------------------

# Hot sites gate on `spans.ARMED` (one module-attribute load + branch
# unarmed); cross-package sites that must not import core (the state
# layer) reach this module through sys.modules, exactly like
# state/journal.py reaches core.faults.
ARMED = False
RECORDER: "SpanRecorder | None" = None
_RATE = DEFAULT_SAMPLE_RATE
# span-name -> count callback (the serving host wires the
# scheduler_trace_spans_total counter here; tests leave it None)
_COUNTER: "Callable[[str], None] | None" = None

_ctx_lock = threading.Lock()
_contexts: "dict[str, TraceContext]" = {}


def arm(
    recorder: "SpanRecorder | None" = None,
    rate: float = DEFAULT_SAMPLE_RATE,
    counter: "Callable[[str], None] | None" = None,
) -> SpanRecorder:
    """Install `recorder` (a fresh default-capacity one when None) as
    the process-wide span sink and flip every stamp site live."""
    global ARMED, RECORDER, _RATE, _COUNTER
    RECORDER = recorder if recorder is not None else SpanRecorder()
    _RATE = float(rate)
    _COUNTER = counter
    ARMED = True
    return RECORDER


def disarm() -> None:
    """Flip every stamp site back to the one-flag-load path and drop
    the uid -> context map (the recorder stays readable for post-hoc
    export until the next arm() replaces it)."""
    global ARMED, _COUNTER
    ARMED = False
    _COUNTER = None
    with _ctx_lock:
        _contexts.clear()


def now() -> float:
    """The armed recorder's clock (perf_counter unless a test
    injected another) — stamp sites use this so span times and
    flight-record marks share one base."""
    rec = RECORDER
    return rec.now() if rec is not None else _time.perf_counter()


# ---- context registry (the cross-thread trace join) ----------------------


def register(
    uid: str, traceparent: str = "", tenant: str = ""
) -> "TraceContext | None":
    """Bind `uid` to a trace at admission: join the caller's trace
    when `traceparent` parses, else head-sample at the armed rate.
    `tenant` names the pod's virtual cluster (multi-tenant front door;
    "" otherwise) and rides the context onto every recorded span.
    Returns the context (None = unsampled or unarmed). Idempotent for
    an already-registered uid (a duplicate submit keeps the original
    binding)."""
    if not ARMED:
        return None
    parsed = parse_traceparent(traceparent) if traceparent else None
    if parsed is None and not sampled(uid, _RATE):
        return None
    with _ctx_lock:
        ctx = _contexts.get(uid)
        if ctx is None:
            if parsed is not None:
                ctx = TraceContext(*parsed, tenant=tenant)
            else:
                ctx = TraceContext(
                    new_trace_id(), new_span_id(), tenant=tenant
                )
            _contexts[uid] = ctx
            if len(_contexts) > _MAX_CONTEXTS:
                # drop the oldest insertion (dicts iterate in order)
                _contexts.pop(next(iter(_contexts)))
    return ctx


def ctx_for(uid: str) -> "TraceContext | None":
    with _ctx_lock:
        return _contexts.get(uid)


def release(uid: str) -> None:
    """Drop the uid's trace binding at its terminal event (bound /
    deleted). Recorded spans stay in the ring; only the LIVE join is
    released."""
    with _ctx_lock:
        _contexts.pop(uid, None)


def record_span(
    name: str,
    ctx: TraceContext,
    t0: float,
    t1: float,
    **attrs: Any,
) -> None:
    """The armed stamp: one span into the module recorder. Callers
    gate on `ARMED` themselves (that IS the unarmed fast path); a
    stamp racing a concurrent disarm is dropped silently."""
    rec = RECORDER
    if rec is None:
        return
    rec.record(name, ctx, t0, t1, **attrs)
    cb = _COUNTER
    if cb is not None:
        try:
            cb(name)
        except Exception:  # schedlint: disable=RB001 -- observability counter failure must never reach a stamp site on the serve/submit path
            pass


# ---- export --------------------------------------------------------------

# chrome-trace: span tracks render in their own process group so
# Perfetto shows them under (and time-aligned with) the cycle lanes
TRACE_TRACK_PID = 2


def spans_to_chrome_events(
    spans: Iterable[Span], epoch: float = 0.0
) -> "list[dict]":
    """Chrome-trace events for per-trace tracks: one tid per trace_id
    (named by the trace's pod uids), each span an `X` slice whose args
    carry the span/parent ids and attrs — the flight-record `seq` attr
    included, which is the exemplar join back to the cycle lanes."""
    events: "list[dict]" = []
    tids: "dict[str, int]" = {}
    uids: "dict[str, set]" = {}
    tenants: "dict[str, set]" = {}
    spans = list(spans)
    for s in spans:
        tid = tids.setdefault(s.trace_id, len(tids) + 1)
        uid = s.attrs.get("uid")
        if uid:
            uids.setdefault(s.trace_id, set()).add(uid)
        tn = s.attrs.get("tenant")
        if tn:
            tenants.setdefault(s.trace_id, set()).add(tn)
    if not tids:
        return events
    events.append(
        {
            "name": "process_name",
            "ph": "M",
            "pid": TRACE_TRACK_PID,
            "args": {"name": "pod traces"},
        }
    )
    for trace_id, tid in tids.items():
        pods = ",".join(sorted(uids.get(trace_id, ()))) or "?"
        # tenant-scoped traces lead with the tenant so Perfetto's
        # track list groups one virtual cluster's lanes together
        tn = ",".join(sorted(tenants.get(trace_id, ())))
        prefix = f"tenant {tn} " if tn else ""
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": TRACE_TRACK_PID,
                "tid": tid,
                "args": {
                    "name": f"{prefix}trace {trace_id[:8]} pod={pods}"
                },
            }
        )
        events.append(
            {
                "name": "thread_sort_index",
                "ph": "M",
                "pid": TRACE_TRACK_PID,
                "tid": tid,
                "args": {"sort_index": tid},
            }
        )
    for s in spans:
        events.append(
            {
                "name": s.name,
                "ph": "X",
                "pid": TRACE_TRACK_PID,
                "tid": tids[s.trace_id],
                "ts": round((s.t0 - epoch) * 1e6, 3),
                "dur": round(max(s.t1 - s.t0, 0.0) * 1e6, 3),
                "cat": "pod-trace",
                "args": {
                    "trace_id": s.trace_id,
                    "span_id": s.span_id,
                    "parent": s.parent,
                    **s.attrs,
                },
            }
        )
    return events


def _otlp_value(v: Any) -> dict:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def to_otlp_json(
    spans: Iterable[Span],
    epoch: float,
    wall_epoch: float,
    service_name: str = "tpu-scheduler",
) -> dict:
    """OTLP/JSON (the OTLP file-exporter shape: one resourceSpans
    entry, spans with hex ids and unix-nano times anchored at the
    recorder's wall epoch) for external ingestion."""

    def nanos(t: float) -> str:
        return str(int((t - epoch + wall_epoch) * 1e9))

    return {
        "resourceSpans": [
            {
                "resource": {
                    "attributes": [
                        {
                            "key": "service.name",
                            "value": {"stringValue": service_name},
                        }
                    ]
                },
                "scopeSpans": [
                    {
                        "scope": {"name": "k8s_scheduler_tpu_torch.core.spans"},
                        "spans": [
                            {
                                "traceId": s.trace_id,
                                "spanId": s.span_id,
                                **(
                                    {"parentSpanId": s.parent}
                                    if s.parent else {}
                                ),
                                "name": s.name,
                                "kind": 1,  # SPAN_KIND_INTERNAL
                                "startTimeUnixNano": nanos(s.t0),
                                "endTimeUnixNano": nanos(s.t1),
                                "attributes": [
                                    {
                                        "key": k,
                                        "value": _otlp_value(v),
                                    }
                                    for k, v in s.attrs.items()
                                ],
                            }
                            for s in spans
                        ],
                    }
                ],
            }
        ]
    }


def export_otlp_dir(
    recorder: SpanRecorder,
    directory: str,
    max_bytes: int = 64 << 20,
) -> "str | None":
    """Dump the recorder's current window as one OTLP-JSON file in
    `directory` (created if needed), then rotate: oldest dumps are
    deleted until the directory's spans-*.json total is back under
    `max_bytes`. Returns the written path (None when the ring is
    empty). Called at shutdown; safe to call repeatedly —
    each call writes the next spans-NNNNNN.json in sequence."""
    spans = recorder.snapshot()
    if not spans:
        return None
    os.makedirs(directory, exist_ok=True)
    existing = sorted(
        f for f in os.listdir(directory)
        if f.startswith("spans-") and f.endswith(".json")
    )
    nxt = 0
    if existing:
        try:
            nxt = int(existing[-1][len("spans-"):-len(".json")]) + 1
        except ValueError:
            nxt = len(existing)
    path = os.path.join(directory, f"spans-{nxt:06d}.json")
    payload = to_otlp_json(spans, recorder.epoch, recorder.wall_epoch)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    # size rotation, oldest-first, never the file just written
    files = sorted(
        f for f in os.listdir(directory)
        if f.startswith("spans-") and f.endswith(".json")
    )
    total = sum(
        os.path.getsize(os.path.join(directory, f)) for f in files
    )
    for f in files[:-1]:
        if total <= max_bytes:
            break
        fp = os.path.join(directory, f)
        total -= os.path.getsize(fp)
        os.remove(fp)
    return path
