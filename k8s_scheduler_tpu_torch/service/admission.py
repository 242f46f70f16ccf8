"""The submission front door: admission control, WAL-before-ack, drain (the
port's copy of `k8s_scheduler_tpu/service/admission.py`: the same
`SubmitResult` fields, shed and invalid reasons and retry-after hints).
Two pieces:

- `AdmissionController` — the admission layer behind the HTTP server's
  `POST /submit` (cmd/httpserver.py) and the gRPC `Submit` /
  `NodeChurn` (service/server.py). A submission is accepted ATOMICALLY or
  rejected whole:

  * **invalid** (missing uid/name, duplicate uid — within the request,
    still pending from an earlier accept, or already assumed/bound in
    the cache: a retry whose ack was lost after the bind must not
    re-admit the pod) — nothing enqueued, nothing journaled.
  * **shed** — explicit backpressure with a retry-after hint, when
    admitting the request would push the admission queue (pending pods
    across all tiers) past `admissionQueueDepth`, when the SLO fast-burn
    gauge fires (core/observe.SloEngine.degraded), or when the
    degradation ladder sits below rung 0. Overload degrades to shedding —
    never to unbounded memory, never to silent latency.
  * **accepted** — every pod is enqueued through the scheduler's
    informer path (`on_pod_add` -> `queue.add`, which journals `q.add`)
    and then, when durable state is attached, the ack WAITS on the
    journal's group-commit fsync barrier (`DurableState.ack_barrier`)
    before returning. An acked submission is durable by contract: a
    kill -9 one instant after the ack replays the pod from the journal.
    Concurrent submitters share one fsync per writer batch.

  Accepted pods are timestamped; `Scheduler._bind` closes the window
  via `note_bind`, and the per-cycle worst submit->bind latency rides
  the flight record as the `submit_bind` phase (observe.PHASES).

- `FrontDoor` — the serve loop for network-fed serving: a thread driving
  `schedule_cycle()` continuously. Its `stop()` is the graceful-drain
  contract: admission closes (late submits get "draining"), the loop keeps
  cycling until the active tier is empty — no pod stranded between ack
  and dispatch — and only then does the caller seal durable state.

The admission depth counts the scheduling queue and the multi-cycle
coalescing buffers; a drain waits for both to empty. Per-tenant admission
(`tenants=`, the tenancy registry) is refused by name until ROADMAP A12
ports the registry.

Thread model: `submit`/`node_churn` run on HTTP worker threads;
`note_bind`/`take_bind_latency_ms`/`queue_depth` run on the serve
loop. Every shared structure is guarded by the controller's one lock;
the queue/cache take their own locks exactly as they do for informer
callbacks.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time as _time

from ..core import blackbox as _blackbox
from ..core import spans as _spans

log = logging.getLogger(__name__)

# accepted-but-unbound timestamps kept at most this many deep: a pod
# parked unschedulable for hours should age out of the latency join
# (its eventual submit->bind sample would only poison the histogram)
_MAX_TRACKED = 262_144

# per-uid admission history (shed / invalid / accepted / bound) kept
# for /debug/explain — bounded LRU on uid, bounded events per uid
_MAX_HISTORY_UIDS = 4096
_MAX_HISTORY_EVENTS = 32


@dataclasses.dataclass
class SubmitResult:
    """Outcome of one submission request (whole-request semantics)."""

    accepted: int = 0
    shed: int = 0
    invalid: tuple[str, ...] = ()  # offending uids (or "" for no-uid)
    reason: str = ""  # shed/invalid/draining detail
    retry_after_ms: float = 0.0  # > 0 on shed
    durable: bool = False  # the WAL ack barrier held
    queue_depth: int = 0  # admission queue depth after the request
    # trace context echoed back to the submitter (W3C traceparent):
    # the caller's own header when one was supplied, else the first
    # sampled pod's locally minted root context, "" when tracing is
    # unarmed or nothing sampled — rides the HTTP response header
    traceparent: str = ""

    @property
    def ok(self) -> bool:
        return not self.shed and not self.invalid and not self.reason


class AdmissionController:
    def __init__(
        self,
        scheduler,
        queue_depth: int | None = None,  # None = config
        retry_after_ms: float | None = None,  # None = config
        max_tracked: int = _MAX_TRACKED,
        tenants=None,  # the reference's tenancy.TenantRegistry
    ) -> None:
        if tenants is not None:
            raise NotImplementedError(
                "tenants= (per-tenant admission over the tenancy registry) "
                "is not ported yet (ROADMAP A12)")
        self.scheduler = scheduler
        cfg = scheduler.config
        self.depth_bound = int(
            cfg.admission_queue_depth if queue_depth is None
            else queue_depth
        )
        self.retry_after_ms = float(
            cfg.admission_retry_after_ms if retry_after_ms is None
            else retry_after_ms
        )
        self._lock = threading.Lock()
        # uid -> accept time (scheduler clock) for accepted, still
        # unbound pods; ordered so overflow evicts the oldest
        self._accept_t: collections.OrderedDict[str, float] = (
            collections.OrderedDict()
        )
        self._max_tracked = max_tracked
        # uid -> [admission events] for /debug/explain (shed/invalid
        # attempts, the accept, the bind) — LRU-bounded both ways
        self._history: collections.OrderedDict[str, list] = (
            collections.OrderedDict()
        )
        self._bind_lat_ms = 0.0  # worst since last take (per record)
        self._closed = False
        self.accepted_total = 0
        self.shed_total = 0
        self.invalid_total = 0
        self.last_shed_reason = ""
        # the durable-state handle bound ONCE here (it is fixed for the
        # scheduler's lifetime): the ack-barrier path does not chase
        # `self.scheduler.state` per submit
        self._durable = scheduler.state
        # the scheduler consults this at bind/record time
        scheduler.admission = self

    # ---- depth ------------------------------------------------------------

    def queue_depth(self) -> int:
        """Pending pods across all queue tiers plus pods buffered in the
        multi-cycle coalescing groups (popped but not dispatched).
        Approximate by design (the serve loop mutates the buffers
        concurrently): the bound is a memory guard, not an exactness
        contract."""
        s = self.scheduler
        n = len(s.queue)
        for bufs in list(s._mc_groups.values()):
            for _t, group in list(bufs):
                n += len(group)
        return n

    # ---- admission history (the /debug/explain join) ----------------------

    def _note_history(self, uids, kind: str, **detail) -> None:
        """Append one admission event per uid (callers hold the lock).
        Tracing-independent: the shed/retry history is part of the
        explain contract whether or not spans are armed."""
        wall = _time.time()
        for uid in uids:
            if not uid:
                continue
            events = self._history.get(uid)
            if events is None:
                events = []
                self._history[uid] = events
                while len(self._history) > _MAX_HISTORY_UIDS:
                    self._history.popitem(last=False)
            else:
                self._history.move_to_end(uid)
            events.append({"wall": wall, "kind": kind, **detail})
            if len(events) > _MAX_HISTORY_EVENTS:
                del events[: len(events) - _MAX_HISTORY_EVENTS]

    def history_for(self, uid: str) -> list:
        """This uid's admission history, oldest first (empty when the
        uid was never seen or aged out of the LRU)."""
        with self._lock:
            events = self._history.get(uid)
            return [dict(e) for e in events] if events else []

    # ---- submission -------------------------------------------------------

    def submit(self, pods, traceparent: str = "") -> SubmitResult:
        t0 = _time.perf_counter()
        m = self.scheduler.metrics
        if self._closed:
            return SubmitResult(
                shed=len(pods), reason="draining",
                retry_after_ms=self.retry_after_ms,
                queue_depth=self.queue_depth(),
                traceparent=traceparent,
            )
        # validation first: an invalid request must journal NOTHING
        bad: list[str] = []
        seen: set[str] = set()
        for p in pods:
            uid = getattr(p, "uid", "")
            if not uid or not p.name:
                bad.append(uid or "")
            elif uid in seen:
                bad.append(uid)
            seen.add(uid)
        if bad:
            with self._lock:
                self.invalid_total += len(pods)
                self._note_history(bad, "invalid", reason="malformed")
            m.admission_total.labels(outcome="invalid").inc(len(pods))
            return SubmitResult(
                invalid=tuple(bad),
                reason=f"invalid pods: {bad[:4]!r}",
                queue_depth=self.queue_depth(),
                traceparent=traceparent,
            )
        # a uid the cache already knows (assumed or bound) is a
        # duplicate too: a client retrying a Submit whose ack was lost
        # AFTER the pod bound must not re-admit it — note_bind has
        # already dropped it from _accept_t, and re-queueing a bound
        # pod double-schedules it. Checked OUTSIDE the admission lock
        # (cache takes its own lock; nesting it under ours would
        # invert against the bind path's note_bind).
        cache = self.scheduler.cache
        known = [u for u in seen if cache.has_pod(u)]
        if known:
            with self._lock:
                self.invalid_total += len(pods)
                self._note_history(
                    known, "invalid", reason="already bound"
                )
            m.admission_total.labels(outcome="invalid").inc(len(pods))
            return SubmitResult(
                invalid=tuple(known),
                reason=f"uids already bound: {known[:4]!r}",
                queue_depth=self.queue_depth(),
                traceparent=traceparent,
            )
        t_valid = _time.perf_counter()
        ctxs: list = []  # (uid, TraceContext) for sampled pods
        with self._lock:
            if self._closed:
                return SubmitResult(
                    shed=len(pods), reason="draining",
                    retry_after_ms=self.retry_after_ms,
                    queue_depth=self.queue_depth(),
                    traceparent=traceparent,
                )
            # a uid still pending from an earlier accepted submission
            # is a duplicate, not an update — re-queueing it would
            # reset its attempt bookkeeping and could double-bind
            dup = [u for u in seen if u in self._accept_t]
            if dup:
                self.invalid_total += len(pods)
                self._note_history(
                    dup, "invalid", reason="already pending"
                )
                m.admission_total.labels(outcome="invalid").inc(
                    len(pods)
                )
                return SubmitResult(
                    invalid=tuple(dup),
                    reason=f"uids already pending: {dup[:4]!r}",
                    queue_depth=self.queue_depth(),
                    traceparent=traceparent,
                )
            depth = self.queue_depth()
            reason = self._shed_reason(depth, len(pods))
            if reason:
                self.shed_total += len(pods)
                self.last_shed_reason = reason
                self._note_history(
                    seen, "shed", reason=reason,
                    retry_after_ms=self.retry_after_ms,
                )
                m.admission_total.labels(outcome="shed").inc(len(pods))
                return SubmitResult(
                    shed=len(pods), reason=reason,
                    retry_after_ms=self.retry_after_ms,
                    queue_depth=depth,
                    traceparent=traceparent,
                )
            # accept: enqueue through the informer path — queue.add
            # journals q.add with the same codec/clock discipline every
            # other mutator uses, so replay and the standby-takeover
            # digest machinery need nothing new for submitted pods
            now = self.scheduler._now()
            for p in pods:
                # bind the trace context BEFORE the enqueue: the serve
                # loop can pop and flush the pod the instant queue.add
                # releases, and its mc.buffer_wait/dispatch spans join
                # the trace by uid lookup
                if _spans.ARMED:
                    c = _spans.register(p.uid, traceparent)
                    if c is not None:
                        ctxs.append((p.uid, c))
                self.scheduler.on_pod_add(p)
                self._accept_t[p.uid] = now
            while len(self._accept_t) > self._max_tracked:
                self._accept_t.popitem(last=False)
            self.accepted_total += len(pods)
            self._note_history(seen, "accepted", depth=depth)
            depth += len(pods)
        m.admission_total.labels(outcome="accepted").inc(len(pods))
        m.admission_queue_depth.set(depth)
        # WAL-before-ack, OUTSIDE the admission lock: the barrier is
        # the group-commit fsync every concurrent submitter shares —
        # serializing it under the lock would turn group commit back
        # into one fsync per request
        durable = False
        t_ack0 = _time.perf_counter()
        flush_seq = -1
        if self._durable is not None:
            durable = self._durable.ack_barrier()
            if ctxs:
                flush_seq = self._durable.flush_seq()
        m.submit_ack.observe(_time.perf_counter() - t0)
        tp = traceparent
        if ctxs:
            # one span triple per sampled pod, stamped from the shared
            # request timestamps: validate (request entry -> dup checks
            # done), journal (the informer-path enqueue, which stamped
            # itself inside the lock window), ack.barrier (the shared
            # group-commit fsync wait — every submitter's span carries
            # the flush seq it rode)
            t_ack1 = _time.perf_counter()
            for uid, c in ctxs:
                _spans.record_span(
                    "submit.validate", c, t0, t_valid, uid=uid
                )
                _spans.record_span(
                    "submit.journal", c, t_valid, t_ack0, uid=uid
                )
                if self._durable is not None:
                    _spans.record_span(
                        "ack.barrier", c, t_ack0, t_ack1, uid=uid,
                        flush_seq=flush_seq, durable=durable,
                    )
            if not tp:
                tp = ctxs[0][1].traceparent()
        return SubmitResult(
            accepted=len(pods), durable=durable, queue_depth=depth,
            traceparent=tp,
        )

    def _shed_reason(self, depth: int, incoming: int) -> str:
        """The backpressure predicate (callers hold the lock)."""
        if self.depth_bound > 0 and depth + incoming > self.depth_bound:
            return (
                f"admission queue full ({depth}+{incoming} > "
                f"{self.depth_bound})"
            )
        reason = ""
        obs = self.scheduler.observer
        ladder = self.scheduler.ladder
        if obs is not None and obs.slo.degraded():
            reason = (
                "SLO fast-burn "
                f"({obs.slo.burn_rate('fast'):.1f}x sustainable)"
            )
        elif ladder.rung > 0:
            from ..core.degrade import RUNGS

            # RUNGS[rung], not ladder.status(): this predicate runs
            # under the admission lock on the ack path — it must stay
            # a pure read of plain attributes
            reason = (
                f"degradation ladder at rung {ladder.rung} "
                f"({RUNGS[ladder.rung]})"
            )
        if reason:
            # half-open, not closed: while degraded the effective
            # bound shrinks to a probe trickle instead of zero. Both
            # recovery signals are TRAFFIC-DRIVEN (ladder promotion
            # counts clean DISPATCHING cycles; the SLO windows advance
            # one entry per attempted cycle) — shedding everything
            # while degraded would freeze the very evidence recovery
            # needs, and one watchdog expiry would pin the door shut
            # for good. The flood still sheds; the trickle heals.
            trickle = (
                max(self.depth_bound // 8, 16)
                if self.depth_bound > 0 else 64
            )
            if depth + incoming > trickle:
                return reason
        return ""

    # ---- node churn -------------------------------------------------------

    def node_churn(self, adds=(), updates=(), deletes=()) -> bool:
        """Apply node churn through the informer path (journaled via
        the cache's c.add_node/c.update_node/c.remove_node records) and
        hold the same ack barrier. Node churn is never shed — dropping
        cluster state is strictly worse than any queue depth — but a
        draining front door refuses it (AdmissionClosed -> UNAVAILABLE:
        the state is about to seal)."""
        if self._closed:
            raise AdmissionClosed("front door draining")
        s = self.scheduler
        for nd in adds:
            s.on_node_add(nd)
        for nd in updates:
            s.on_node_update(nd)
        for name in deletes:
            s.on_node_delete(name)
        if self._durable is not None:
            return self._durable.ack_barrier()
        return False

    # ---- serve-loop side --------------------------------------------------

    def note_bind(self, uid: str) -> None:
        """Called by Scheduler._bind for every successful bind: closes
        the submit->bind window for front-door pods (a uid this
        controller never accepted is a no-op). Must never raise — it
        sits on the bind path."""
        with self._lock:
            t0 = self._accept_t.pop(uid, None)
            if t0 is None:
                return
            lat_ms = max(self.scheduler._now() - t0, 0.0) * 1e3
            if lat_ms > self._bind_lat_ms:
                self._bind_lat_ms = lat_ms
            if uid in self._history:
                self._note_history(
                    (uid,), "bound", latency_ms=round(lat_ms, 3)
                )

    def note_delete(self, uid: str) -> None:
        """Called by Scheduler.on_pod_delete: a pod deleted before it
        bound leaves the accepted-pending set, so a re-created pod
        reusing the uid can be admitted again (without this the uid
        would answer 'already pending' until the LRU happened to evict
        it). Must never raise — it sits on the informer path."""
        with self._lock:
            self._accept_t.pop(uid, None)
        # a deleted pod's trace is over — drop its live context (the
        # recorded spans stay in the ring for /debug queries)
        if _spans.ARMED:
            _spans.release(uid)

    def take_bind_latency_ms(self) -> float:
        """Worst submit->bind latency among binds since the last take
        (consumed by Scheduler._commit_record into the `submit_bind`
        flight-record phase); 0.0 when no front-door pod bound."""
        with self._lock:
            v = self._bind_lat_ms
            self._bind_lat_ms = 0.0
        return v

    # ---- lifecycle / status ----------------------------------------------

    def close(self) -> None:
        """Stop admitting (drain begins): every later submit answers
        'draining' (UNAVAILABLE), node churn raises AdmissionClosed."""
        with self._lock:
            self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed

    def overloaded(self) -> str:
        """Non-empty reason while the front door would shed RIGHT NOW
        — surfaced as `degraded: true` in /healthz during a burst.
        Deliberately lock-free: the predicate reads plain attributes
        plus the queue's own lock, and a probe must never queue behind
        a submit's fsync barrier (the depth it reports is a snapshot
        either way)."""
        return self._shed_reason(self.queue_depth(), 1)

    def status(self) -> dict:
        with self._lock:
            return {
                "queue_depth": self.queue_depth(),
                "depth_bound": self.depth_bound,
                "accepted_total": self.accepted_total,
                "shed_total": self.shed_total,
                "invalid_total": self.invalid_total,
                "pending_accepted": len(self._accept_t),
                "last_shed_reason": self.last_shed_reason,
                "closed": self._closed,
                "tenant_depths": {},  # per-tenant admission: ROADMAP A12
            }


class AdmissionClosed(RuntimeError):
    """Raised by node_churn on a draining front door."""


class FrontDoor:
    """The serve loop for network-fed arrivals, with graceful drain.

    `cycle_fn` defaults to the scheduler's `schedule_cycle`. `step()` is
    one iteration of the loop (a cycle, then `post_cycle`) for a caller
    that drives the cycles itself."""

    def __init__(
        self,
        admission: AdmissionController,
        cycle_fn=None,
        idle_sleep: float = 0.005,
        post_cycle=None,
    ) -> None:
        self.admission = admission
        self.scheduler = admission.scheduler
        self._cycle_fn = cycle_fn or self.scheduler.schedule_cycle
        self._idle_sleep = idle_sleep
        # runs on the loop thread after every cycle — an in-process drive
        # uses it to play the informer back (bind confirmations), which a
        # real deployment's agent does; without confirmation an assumed
        # pod expires on the 30 s TTL and re-binds
        self._post_cycle = post_cycle
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._drained = threading.Event()
        self._thread: threading.Thread | None = None
        self.cycles = 0
        self.cycle_failures = 0
        self._failure_backoff = 0.5

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("front door already started")
        self._thread = threading.Thread(
            target=self._run, name="front-door-serve", daemon=True
        )
        self._thread.start()

    def step(self):
        """One serve-loop iteration: a cycle, then the post-cycle hook.
        Returns the cycle's stats."""
        stats = self._cycle_fn()
        self.cycles += 1
        if self._post_cycle is not None:
            self._post_cycle()
        return stats

    def _run(self) -> None:
        try:
            self._run_loop()
        finally:
            # fail SHUT: if the loop ever exits without a completed
            # drain or an explicit stop() (a BaseException, a logic
            # error), the door must not keep acking durable pods into
            # a serve loop that no longer exists
            if not self._stop.is_set() and not self._drained.is_set():
                log.error(
                    "front-door serve loop exited abnormally — "
                    "closing admission (acked pods stay journaled "
                    "and dispatch on restart)"
                )
                self.admission.close()

    def _buffered(self) -> bool:
        return any(self.scheduler._mc_groups.values())

    def _run_loop(self) -> None:
        s = self.scheduler
        while not self._stop.is_set():
            try:
                stats = self.step()
            except Exception:
                # a host-side bug escaping schedule_cycle (device
                # failures are consumed by the watchdog + ladder) must
                # not silently kill the serve thread while admission
                # keeps acking: log, count, back off, keep serving —
                # accepted pods are journaled and stay dispatchable
                # the moment the fault clears
                self.cycle_failures += 1
                log.exception(
                    "front-door cycle failed (%d so far) — backing "
                    "off %.1fs and continuing",
                    self.cycle_failures, self._failure_backoff,
                )
                # unhandled serve-loop exception = black-box trigger
                # (throttled inside; the loop is about to keep running,
                # so the bundle must capture the rings now)
                _blackbox.trigger(
                    "serve_loop",
                    f"cycle_failures={self.cycle_failures}",
                )
                self._stop.wait(self._failure_backoff)
                continue
            if self._draining.is_set():
                # drain condition: nothing ready AND nothing coalescing
                # (backoff/unschedulable pods are durable in the sealed
                # state and legitimately outlive the drain — they are
                # parked, not stranded between ack and dispatch)
                if (s.queue.pending_counts().get("active", 0) == 0
                        and not self._buffered()):
                    self._drained.set()
                    return
                continue  # drain at full cadence, no idle sleep
            if stats.attempted == 0 and not self._buffered():
                self._stop.wait(self._idle_sleep)

    def begin_drain(self) -> None:
        """Stop admission and switch the loop into drain mode."""
        self.admission.close()
        self._draining.set()

    def stop(self, drain: bool = True, timeout: float = 30.0) -> bool:
        """Graceful shutdown: close admission, cycle until the active tier
        is empty, stop the loop, join the thread. Returns True when the
        drain completed (False = timeout; the journal tail still holds
        every acked pod, so nothing is lost either way)."""
        drained = True
        if drain and self._thread is not None:
            self.begin_drain()
            drained = self._drained.wait(timeout)
            if not drained:
                log.warning(
                    "front door drain did not complete within %.1fs "
                    "(active=%d) — stopping anyway; the journal tail "
                    "covers the remainder",
                    timeout,
                    self.scheduler.queue.pending_counts().get(
                        "active", 0
                    ),
                )
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=max(timeout, 5.0))
            if thread.is_alive():
                log.error(
                    "front-door serve thread failed to exit; leaving "
                    "it daemon (a wedged dispatch is bounded by the "
                    "watchdog, not this join)"
                )
            self._thread = None
        return drained


def self_confirming_front_door(service, admission) -> FrontDoor:
    """FrontDoor for agentless serving: the local loop is the binder of
    record — no API server echoes its bindings back — so an assumed bind
    would otherwise expire on the cache TTL and re-bind forever. Chains
    the scheduler's binder with a confirm queue the loop plays back
    post-cycle through the informer path (the same contract an agent's
    confirmation provides); the confirmed bind is journaled, so a
    failover restores it bound instead of re-schedulable.

    `service` is a `service.server.SchedulerService` (its `scheduler` and
    `run_local_cycle`, the CLI's case) or the `Scheduler` itself, whose
    `schedule_cycle` is the cycle."""
    confirm_q: collections.deque = collections.deque()
    sched = getattr(service, "scheduler", service)
    cycle_fn = getattr(service, "run_local_cycle", sched.schedule_cycle)
    svc_binder = sched.binder

    def binder(pod, node_name):
        svc_binder(pod, node_name)
        confirm_q.append((pod, node_name))

    sched.binder = binder

    def confirm():
        while confirm_q:
            p, n = confirm_q.popleft()
            sched.on_pod_add(p, n)

    return FrontDoor(admission, cycle_fn=cycle_fn, post_cycle=confirm)
