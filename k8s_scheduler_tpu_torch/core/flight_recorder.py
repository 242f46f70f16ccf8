"""The port's copy of `k8s_scheduler_tpu/core/flight_recorder.py` (pure Python, the
reference's names and structure), with a pure-Python copy of the function
it imports lazily there: `overlap_from_records` (reference
`core/profiling.py:255`); the span tracks come from the port's
`core/spans.py`.

Cycle flight recorder: bounded per-cycle phase marks + pod timelines.

Production serving needs to answer "which phase ate the cycle and which
plugin rejected this pod" continuously, without stopping the scheduler
and without reconstructing it from three independent probe runs. The
Prometheus histograms aggregate away the per-cycle structure; this module
keeps the structure:

- `FlightRecorder` — a bounded ring of `CycleRecord`s. The scheduling
  loop stamps each cycle with host-side `perf_counter` marks (encode,
  dispatch, decision fetch, winner binds, postfilter, deferred-diagnosis
  resolution) plus counts (pods, binds, preemptions, queue depths, retry
  strikes, fetch bytes, pipeline slot). Writer cost is a handful of dict
  writes and ONE list-slot store per cycle — no locks on the writer side;
  publication is a seqlock-style monotonically increasing commit count
  (`_commits`), which readers check around their ring copy and retry
  until no commit tore the window.
- `PodTimelines` — a bounded (LRU) per-pod event log:
  queued -> attempts[{cycle, result, first-rejecting plugin}] ->
  bound / evicted. Fed by the scheduler's informer handlers and the
  winner/loser loops; joined with the events ring at query time
  (Scheduler.pod_timeline).
- `to_chrome_trace` — reconstructs the split-phase pipeline's overlapped
  lanes (host encode/bind vs in-flight device cycle vs deferred
  diagnosis) as a Chrome-trace/Perfetto JSON from the REAL serving
  timestamps, so pipeline overlap is visible from production, not probe
  medians. Download via `/debug/trace?last=N`, open in ui.perfetto.dev.

Single-writer contract: records are started and committed by the
scheduling loop only (one thread). Pod-timeline notes may arrive from
informer threads and take a small lock. The module is stdlib-only (no
jax/numpy) so tools and tests can import it without a backend.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time as _time
from typing import Any, Callable, Iterable

from .spans import spans_to_chrome_events

# chrome-trace lane (tid) layout: one process, three threads. Perfetto
# renders each tid as its own track, so the overlap between the host
# lane and the device/diagnosis lanes is visible directly.
LANE_HOST = 1  # encode, dispatch call, winner binds, loser requeue
LANE_DEVICE = 2  # dispatched cycle program -> slimmed decision fetch
LANE_DIAG = 3  # deferred FailedScheduling attribution (diag lag)

LANE_NAMES = {
    LANE_HOST: "host (encode/bind)",
    LANE_DEVICE: "device cycle (in flight)",
    LANE_DIAG: "deferred diagnosis",
}

# Where each attribution phase (core/observe.PHASES) renders in the
# chrome-trace export: phase -> (lane tid, slice name). Phases that ride
# inside a parent slice (fold inside encode, compile inside the flip
# cycle's dispatch) map to that parent. `to_chrome_trace` reads its lane
# ids from here, and schedlint's ID005 check enforces that this mapping,
# observe.PHASES, the scheduler_cycle_phase_seconds docstring entry, and
# the README phase table never drift apart.
TRACE_LANE_FOR_PHASE = {
    "total": (LANE_HOST, "cycle[seq]"),
    "encode": (LANE_HOST, "encode"),
    "fold": (LANE_HOST, "encode"),
    "dispatch": (LANE_HOST, "dispatch"),
    "compile": (LANE_HOST, "dispatch"),
    "decision_fetch": (LANE_HOST, "decision_wait"),
    "bind": (LANE_HOST, "bind winners"),
    "postfilter": (LANE_HOST, "postfilter"),
    "device": (LANE_DEVICE, "device cycle[seq]"),
    "diag_lag": (LANE_DIAG, "diag lag[seq]"),
    # multi-cycle batched decomposition: an inner cycle's host-side
    # coalescing wait renders on the host lane (it precedes the batch's
    # encode), its apportioned device share inside the batch's device
    # slice (the host cannot see per-inner-cycle device boundaries)
    "batch_wait": (LANE_HOST, "batch wait"),
    "device_share": (LANE_DEVICE, "device cycle[seq]"),
    # streamed decision fetch: batch flush -> first inner cycle's
    # decision row landed; renders inside the batch's device slice
    # (the window ends where row 0's transfer completes)
    "first_bind": (LANE_DEVICE, "device cycle[seq]"),
    # front door: admission accept -> bind, a host-observed end-to-end
    # window; renders on the host lane (it ends in the bind loop)
    "submit_bind": (LANE_HOST, "bind winners"),
    # admission-time incremental encode: the ingest share was paid
    # before the flush cycle started, but it is host encode work, so
    # both halves render inside the flush cycle's encode slice
    "encode_ingest": (LANE_HOST, "encode"),
    "encode_finalize": (LANE_HOST, "encode"),
}


@dataclasses.dataclass
class CycleRecord:
    """One scheduling cycle's flight data (one per profile per cycle).

    `marks` hold ABSOLUTE recorder-clock times (perf_counter seconds)
    for phase boundaries; `phases` hold derived millisecond durations
    (the ServingPipeline stage report plus scheduler-side phases);
    `counts` hold integers (pods, binds, queue depths, fetch bytes...).
    Records are immutable once committed — the ring replaces slots, it
    never mutates them."""

    seq: int
    profile: str
    t_start: float  # recorder clock (perf_counter)
    wall_start: float  # time.time() anchor for log cross-referencing
    slot: int = -1  # pipeline upload slot id
    forced_sync: bool = False
    t_end: float = 0.0
    marks: dict[str, float] = dataclasses.field(default_factory=dict)
    phases: dict[str, float] = dataclasses.field(default_factory=dict)
    counts: dict[str, int] = dataclasses.field(default_factory=dict)
    # padded-shape signature of the cycle's packed regime, as a sorted
    # tuple of (dim, size) pairs (models/packing.shape_signature): the
    # observer diffs consecutive signatures to attribute WHICH pad
    # dimension (E/MPN/MA/MC/P/N) flipped on a recompile anomaly
    sig: tuple | None = None
    # where this cycle's (re)built programs came from, stamped only on
    # regime-flip cycles: "cold" (full XLA compile on the serve path),
    # "cache" (loaded from the persistent executable cache), or
    # "speculative" (the warm thread pre-built the regime before the
    # flip). The observer surfaces it in /debug/anomalies recompile
    # events so operators can tell a cache miss from a win.
    compile_source: str = ""
    # depth-2 speculative dispatch outcome, stamped on the record of
    # the batch a speculation rode (one sample per speculation):
    # "adopted" | "abandoned" | "none" (speculation considered but not
    # dispatched — e.g. spec mismatch), "" = no speculation involved.
    # Feeds the observer's speculation_thrash abandon-rate EWMA.
    speculation: str = ""
    # trace ids of the sampled pods this cycle served (core/spans):
    # the exemplar join from a flight record back to its pod traces —
    # span attrs carry the cycle `seq` for the reverse direction.
    # Stamped only when tracing is armed AND a sampled pod rode the
    # cycle; empty tuple otherwise (and omitted from to_dict).
    trace_ids: tuple = ()
    # virtual cluster this cycle scheduled for (tenancy/): stamped by
    # _commit_record when the scheduler runs tenant-scoped (the
    # sequential per-tenant reference path); "" = single-tenant, and
    # omitted from to_dict. Arena-mode attribution rides the tenancy
    # metrics + span attrs instead — one record per tenant would undo
    # the batching the arena exists for.
    tenant: str = ""

    def mark(self, name: str, t: float) -> None:
        self.marks[name] = t

    def to_dict(self, epoch: float = 0.0) -> dict[str, Any]:
        """JSON-ready dict; mark times rebased to `epoch` (seconds)."""
        return {
            "seq": self.seq,
            "profile": self.profile,
            "slot": self.slot,
            "forced_sync": self.forced_sync,
            "t_start_s": round(self.t_start - epoch, 6),
            "t_end_s": round(self.t_end - epoch, 6),
            "wall_start": self.wall_start,
            "marks_s": {
                k: round(v - epoch, 6) for k, v in self.marks.items()
            },
            "phases_ms": {k: round(v, 4) for k, v in self.phases.items()},
            "counts": dict(self.counts),
            **(
                {"sig": {k: v for k, v in self.sig}}
                if self.sig is not None else {}
            ),
            **(
                {"compile_source": self.compile_source}
                if self.compile_source else {}
            ),
            **(
                {"speculation": self.speculation}
                if self.speculation else {}
            ),
            **(
                {"trace_ids": list(self.trace_ids)}
                if self.trace_ids else {}
            ),
            **(
                {"tenant": self.tenant}
                if self.tenant else {}
            ),
        }


class PodTimelines:
    """Bounded per-pod scheduling history (LRU on pod uid).

    Each entry is `{"uid", "name", "events": [...]}` where every event
    carries the recorder-clock time, wall time, a kind (Queued /
    Attempt / Nominated / Bound / BindError / Unschedulable / Evicted /
    Deleted), and kind-specific detail (cycle seq, node, first-rejecting
    plugin). Thread-safe — informer handlers run on other threads than
    the scheduling loop."""

    def __init__(self, max_pods: int = 4096, max_events: int = 256):
        self._lock = threading.Lock()
        self._max_pods = max_pods
        self._max_events = max_events
        self._pods: collections.OrderedDict[str, dict] = (
            collections.OrderedDict()
        )

    def note(
        self, uid: str, name: str, kind: str, t: float, wall: float,
        **detail: Any,
    ) -> None:
        ev = {"t_s": t, "wall": wall, "kind": kind, **detail}
        with self._lock:
            entry = self._pods.get(uid)
            if entry is None:
                entry = {"uid": uid, "name": name, "events": []}
                self._pods[uid] = entry
                while len(self._pods) > self._max_pods:
                    self._pods.popitem(last=False)
            else:
                self._pods.move_to_end(uid)
                if name:
                    entry["name"] = name
            events = entry["events"]
            events.append(ev)
            if len(events) > self._max_events:
                del events[: len(events) - self._max_events]

    def get(self, uid: str) -> dict | None:
        with self._lock:
            entry = self._pods.get(uid)
            if entry is None:
                return None
            return {
                "uid": entry["uid"],
                "name": entry["name"],
                "events": [dict(e) for e in entry["events"]],
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._pods)


class FlightRecorder:
    """Bounded ring of CycleRecords + pod timelines.

    Hot-path cost: `start()` is one dataclass construction; `commit()`
    is one list-slot store plus one int publish. Readers (`snapshot`)
    copy the ring without blocking the writer and validate the copy
    against the commit count (seqlock-style): a copy a commit landed in
    is retried."""

    def __init__(
        self,
        capacity: int = 512,
        now: Callable[[], float] = _time.perf_counter,
        wall: Callable[[], float] = _time.time,
        max_pods: int = 4096,
    ) -> None:
        self.capacity = max(int(capacity), 1)
        self.now = now
        self._wall = wall
        self._ring: list[CycleRecord | None] = [None] * self.capacity
        # COMMIT count (monotonic): the seqlock generation readers check.
        # Distinct from _seq — a started-but-never-committed record
        # consumes a seq but must not inflate the committed-cycle count.
        # (A failed decision fetch the degradation ladder handled IS
        # committed, stamped counts.aborted=1 + the post-failure rung —
        # core/scheduler._cycle_failed; only failures that escape the
        # ladder leave a consumed seq behind.)
        self._commits = 0
        self._seq = 0  # next record's sequence number
        self.epoch = now()
        self.wall_epoch = wall()
        self.pods = PodTimelines(max_pods=max_pods)
        # publish-time consumers (core/observe.CycleObserver.observe):
        # called synchronously after each commit with the record. A
        # failing observer is logged once and detached — observability
        # must never take the scheduling loop down with it.
        self.observers: list[Callable[[CycleRecord], None]] = []

    # ---- writer side (scheduling loop only) ------------------------------

    def start(self, profile: str = "default-scheduler") -> CycleRecord:
        rec = CycleRecord(
            seq=self._seq,
            profile=profile,
            t_start=self.now(),
            wall_start=self._wall(),
        )
        self._seq += 1
        return rec

    def commit(self, rec: CycleRecord) -> None:
        if not rec.t_end:
            rec.t_end = self.now()
        self._ring[rec.seq % self.capacity] = rec
        # publish AFTER the slot store: a reader that observes the new
        # count is guaranteed to observe the new record (GIL-ordered)
        self._commits += 1
        for cb in list(self.observers):
            try:
                cb(rec)
            except Exception:  # noqa: BLE001 — see observers docstring
                import logging

                logging.getLogger(__name__).exception(
                    "flight-recorder observer %r failed; detaching", cb
                )
                self.observers.remove(cb)

    def pod_event(
        self, uid: str, name: str, kind: str, **detail: Any
    ) -> None:
        self.pods.note(
            uid, name, kind, self.now() - self.epoch, self._wall(),
            **detail,
        )

    # ---- reader side -----------------------------------------------------

    @property
    def cycles(self) -> int:
        """Total committed records (not capped by capacity; aborted
        starts do not count)."""
        return self._commits

    def snapshot(self, last: int | None = None) -> list[CycleRecord]:
        """Consistent copy of the most recent `last` records (oldest
        first; `last=0` is an empty window). Lock-free: the copy is
        retried until no commit landed during it (the seqlock check —
        commits are cycle-rate, the copy is microseconds, so this
        converges immediately in practice); the fallback trims to the
        newest run of seqs no commit could have torn."""
        ring: list[CycleRecord | None] = []
        for _ in range(8):
            before = self._commits
            ring = list(self._ring)  # atomic-enough slot copy under GIL
            if self._commits == before:
                break  # no commit during the copy: exactly consistent
        recs = sorted(
            (r for r in ring if r is not None), key=lambda r: r.seq
        )
        if recs:
            # fallback consistency trim: a commit mid-copy can leave a
            # stale slot (seq max-capacity) next to its replacement —
            # keep only the trailing window every slot agrees on
            recs = [
                r for r in recs
                if r.seq > recs[-1].seq - self.capacity
            ]
        if last is not None:
            n = max(int(last), 0)
            recs = recs[-n:] if n else []
        return recs

    def last_record(self) -> CycleRecord | None:
        recs = self.snapshot(last=1)
        return recs[-1] if recs else None

    def last_cycle_age_s(self) -> float:
        """Seconds since the newest committed cycle record — or since
        the recorder was created when no cycle has EVER completed, so a
        scheduler that wedged before its first cycle still ages out of
        its health deadline instead of reporting healthy forever."""
        rec = self.last_record()
        anchor = rec.t_end if rec is not None else self.epoch
        return max(0.0, self.now() - anchor)

    def to_dicts(self, last: int | None = None) -> list[dict]:
        return [r.to_dict(epoch=self.epoch) for r in self.snapshot(last)]

    def derived(self, last: int = 64) -> dict[str, float]:
        """Continuous pipeline gauges computed over the recent window —
        the production replacement for the probe's three separated runs
        (see core/profiling.overlap_from_records for the accounting)."""
        recs = self.snapshot(last=last)
        out = overlap_from_records(r.phases for r in recs)
        out["cycles"] = float(self.cycles)
        out["last_cycle_age_s"] = round(self.last_cycle_age_s(), 6)
        return out


# ---- Chrome-trace / Perfetto export ------------------------------------


def _slice(
    name: str, tid: int, t0: float, t1: float, epoch: float,
    args: dict | None = None,
) -> dict:
    ev = {
        "name": name,
        "ph": "X",
        "pid": 1,
        "tid": tid,
        "ts": round((t0 - epoch) * 1e6, 3),
        "dur": round(max(t1 - t0, 0.0) * 1e6, 3),
        "cat": "scheduler",
    }
    if args:
        ev["args"] = args
    return ev


def to_chrome_trace(
    records: Iterable[CycleRecord], epoch: float = 0.0,
    spans: Iterable | None = None,
) -> dict:
    """Chrome-trace (JSON object format) reconstruction of the serving
    pipeline's lanes from committed records. Open the serialized dict in
    ui.perfetto.dev or chrome://tracing.

    When `spans` (core/spans.Span, the same perf_counter clock as the
    cycle marks) is given, per-trace pod tracks render in a second
    process group below the cycle lanes — one Perfetto view shows a
    pod's submit→bind spans overlapping the batch that served it.

    Lane layout (one pid, three tids — see LANE_NAMES):

    - host lane: `encode` -> `dispatch` -> `decision_wait` (the one
      blocking fetch) -> `bind winners` -> `postfilter` -> `losers`;
    - device lane: one `cycle[k]` slice spanning dispatch start ->
      decision fetch end — the window the device (and the transfer) is
      working while the host is free to do other work;
    - diag lane: `diag lag` from decision-fetch end to the moment the
      deferred FailedScheduling attribution was forced.

    Under async serving the diag slice overlaps the host bind slice and
    the device slice overlaps host dispatch-adjacent work; under
    `forced_sync` every slice serializes — the visual proof either way
    comes from real serving timestamps."""
    events: list[dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": 1,
            "args": {"name": "tpu-scheduler serving pipeline"},
        }
    ]
    for tid, name in LANE_NAMES.items():
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": 1,
                "tid": tid,
                "args": {"name": name},
            }
        )
        events.append(
            {
                "name": "thread_sort_index",
                "ph": "M",
                "pid": 1,
                "tid": tid,
                "args": {"sort_index": tid},
            }
        )

    for rec in records:
        m = rec.marks
        args = {
            "seq": rec.seq,
            "profile": rec.profile,
            "slot": rec.slot,
            "forced_sync": rec.forced_sync,
            **{k: v for k, v in rec.counts.items()},
        }
        t_enc0 = m.get("encode_start", rec.t_start)
        t_disp0 = m.get("dispatch_start")
        t_disp1 = m.get("dispatch_end")
        t_dec0 = m.get("decision_start")
        t_dec1 = m.get("decision_end")
        # bind work starts at apply_start when stamped (after the
        # deferred dispatches, which BLOCK under forced_sync)
        t_apply = m.get("apply_start", m.get("decision_end"))
        t_win = m.get("winners_end")
        t_post = m.get("postfilter_end")
        t_diag = m.get("diag_done")

        # whole-cycle envelope on the host lane (parent slice: children
        # below nest inside it on the same tid)
        events.append(
            _slice(
                f"cycle[{rec.seq}]", LANE_HOST, rec.t_start, rec.t_end,
                epoch, args,
            )
        )
        if t_disp0 is not None:
            events.append(
                _slice(
                    TRACE_LANE_FOR_PHASE["encode"][1],
                    TRACE_LANE_FOR_PHASE["encode"][0],
                    t_enc0, t_disp0, epoch,
                )
            )
        if t_disp0 is not None and t_disp1 is not None:
            events.append(
                _slice(
                    TRACE_LANE_FOR_PHASE["dispatch"][1],
                    TRACE_LANE_FOR_PHASE["dispatch"][0],
                    t_disp0, t_disp1, epoch,
                )
            )
        if t_dec0 is not None and t_dec1 is not None:
            events.append(
                _slice(
                    TRACE_LANE_FOR_PHASE["decision_fetch"][1],
                    TRACE_LANE_FOR_PHASE["decision_fetch"][0],
                    t_dec0, t_dec1, epoch,
                    {"fetch_bytes": rec.counts.get("fetch_bytes", 0)},
                )
            )
        if t_apply is not None and t_win is not None:
            events.append(
                _slice(
                    TRACE_LANE_FOR_PHASE["bind"][1],
                    TRACE_LANE_FOR_PHASE["bind"][0],
                    t_apply, t_win, epoch,
                )
            )
        if t_win is not None and t_post is not None:
            events.append(
                _slice(
                    TRACE_LANE_FOR_PHASE["postfilter"][1],
                    TRACE_LANE_FOR_PHASE["postfilter"][0],
                    t_win, t_post, epoch,
                )
            )
        if t_post is not None:
            events.append(
                _slice("losers", LANE_HOST, t_post, rec.t_end, epoch)
            )

        # device lane: dispatched program in flight until the slimmed
        # decision payload landed on the host
        if t_disp0 is not None and t_dec1 is not None:
            events.append(
                _slice(
                    f"device cycle[{rec.seq}] slot={rec.slot}",
                    TRACE_LANE_FOR_PHASE["device"][0],
                    t_disp0, t_dec1, epoch,
                    {"seq": rec.seq, "slot": rec.slot},
                )
            )

        # diagnosis lane: how far FailedScheduling attribution trailed
        # the binds (resolves while the host bind loop runs)
        if t_dec1 is not None and t_diag is not None and t_diag > t_dec1:
            events.append(
                _slice(
                    f"diag lag[{rec.seq}]",
                    TRACE_LANE_FOR_PHASE["diag_lag"][0],
                    t_dec1, t_diag,
                    epoch, {"seq": rec.seq},
                )
            )

    if spans is not None:
        events.extend(spans_to_chrome_events(spans, epoch=epoch))

    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---- a copy of the reference's helper (core/profiling.py) ----------------


def overlap_from_records(
    phase_dicts: "Iterable[dict[str, float]]",
) -> dict[str, float]:
    """Continuous overlap accounting from flight-recorder records (the
    reference's `core/profiling.overlap_from_records`). Each input dict
    is a CycleRecord's `phases` (the ServingPipeline stage report).
    `overlap_ratio` = hidden encode / total encode over the window, with
    the pipeline's conservative per-cycle estimate (hidden = max(0,
    encode - decision_wait)); 0.0 = fully serial (forced_sync)."""
    n = 0
    enc = hidden = wait = diag = diag_n = 0.0
    for ph in phase_dicts:
        n += 1
        e = ph.get("encode_ms", 0.0)
        w = ph.get("decision_wait_ms", 0.0)
        enc += e
        wait += w
        hidden += ph.get("encode_hidden_ms", max(0.0, e - w))
        if "diag_lag_ms" in ph:
            diag += ph["diag_lag_ms"]
            diag_n += 1
    return {
        "window": float(n),
        "encode_ms_mean": round(enc / n, 4) if n else 0.0,
        "decision_wait_ms_mean": round(wait / n, 4) if n else 0.0,
        "encode_hidden_ms_mean": round(hidden / n, 4) if n else 0.0,
        "diag_lag_ms_mean": round(diag / diag_n, 4) if diag_n else 0.0,
        "overlap_ratio": round(min(hidden / enc, 1.0), 4) if enc > 0
        else 0.0,
    }

