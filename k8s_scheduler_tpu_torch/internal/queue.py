"""The port's copy of `k8s_scheduler_tpu/internal/queue.py` (pure Python,
the reference's names and structure), with its journaling hooks.

SchedulingQueue: active / backoff / unschedulable tiers. The whole ready
set is scheduled per cycle, so the upstream heap collapses to set
bookkeeping:

- `active`: pods ready for the next cycle. `pop_ready()` drains it;
  ordering is re-derived by the encoder's `pod_order` (the profile's
  queueSort), so no heap is needed host-side.
- `backoff`: pods that failed recently, with an expiry deadline
  (exponential per-pod backoff, initial/max from config).
  `flush_backoff()` moves expired entries back to active.
- `unschedulable`: pods that found no node and wait for a cluster event.
  `move_all_to_active_or_backoff(event)` relocates them, honoring the
  event->plugin queueing-hint table below.

Pods handed out by `pop_ready()` are tracked as in-flight until the cycle
requeues or drops them; a delete arriving mid-cycle marks the uid so the
requeue discards it instead of resurrecting a deleted pod. All public
methods take the queue lock. Time is injected (`now` callable) so tests
drive the clock.

Durability contract (state/ package): every public mutator reads the
clock EXACTLY ONCE, applies its change through non-emitting internal
helpers, and emits EXACTLY ONE journal record carrying that clock value
— so replaying the record stream under a clock pinned to each record's
timestamp reproduces this queue bit-identically (attempt counts, backoff
expiries, tier membership, in-flight set). Internal helpers never emit
and never read the clock themselves.
"""

from __future__ import annotations

import dataclasses
import threading
import time as _time
from typing import Callable, Iterable, Sequence

from ..models.api import Pod
from .cache import _codec as _shared_codec

# Cluster events (the reference's framework.ClusterEvent resource/action
# pairs, collapsed to the ones that matter for requeueing).
EVENT_NODE_ADD = "NodeAdd"
EVENT_NODE_UPDATE = "NodeUpdate"
EVENT_NODE_DELETE = "NodeDelete"
EVENT_POD_ADD = "PodAdd"
EVENT_POD_UPDATE = "PodUpdate"
EVENT_POD_DELETE = "PodDelete"
EVENT_PVC_CHANGE = "PvcChange"  # PVC add/update (e.g. became bound)
EVENT_PV_CHANGE = "PvChange"  # PV add/update (e.g. became available)
EVENT_STORAGE_CLASS_CHANGE = "StorageClassChange"
EVENT_UNSCHEDULABLE_TIMEOUT = "UnschedulableTimeout"

# Which failure reasons (plugin names) an event can unstick — the
# queueing-hint registry (upstream EventsToRegister). A pod rejected by
# plugin X only requeues on events in HINTS[X]. Unknown reasons requeue on
# everything (conservative default, matches hintless upstream behavior).
QUEUEING_HINTS: dict[str, frozenset[str]] = {
    "NodeResourcesFit": frozenset(
        {EVENT_NODE_ADD, EVENT_NODE_UPDATE, EVENT_POD_DELETE}
    ),
    "NodeAffinity": frozenset({EVENT_NODE_ADD, EVENT_NODE_UPDATE}),
    "NodeName": frozenset({EVENT_NODE_ADD, EVENT_NODE_UPDATE}),
    "NodeUnschedulable": frozenset({EVENT_NODE_ADD, EVENT_NODE_UPDATE}),
    "TaintToleration": frozenset({EVENT_NODE_ADD, EVENT_NODE_UPDATE}),
    "NodePorts": frozenset({EVENT_NODE_ADD, EVENT_POD_DELETE}),
    "InterPodAffinity": frozenset(
        {EVENT_NODE_ADD, EVENT_POD_ADD, EVENT_POD_UPDATE, EVENT_POD_DELETE}
    ),
    "PodTopologySpread": frozenset(
        {EVENT_NODE_ADD, EVENT_POD_ADD, EVENT_POD_UPDATE, EVENT_POD_DELETE}
    ),
    "Coscheduling": frozenset({EVENT_POD_ADD, EVENT_POD_DELETE,
                               EVENT_NODE_ADD, EVENT_NODE_UPDATE}),
    "VolumeBinding": frozenset({
        EVENT_NODE_ADD, EVENT_NODE_UPDATE, EVENT_PVC_CHANGE,
        EVENT_PV_CHANGE, EVENT_STORAGE_CLASS_CHANGE,
    }),
}


def _codec_pod():
    """The journal's pod serializer, via the ONE lazy codec binding
    shared with SchedulerCache (cache._codec): bound on first use so
    schedulers without durability never import state/, and journaling
    mutators skip per-call import machinery inside the queue lock."""
    return _shared_codec()[0]


@dataclasses.dataclass
class _QueuedPod:
    pod: Pod
    attempts: int = 0  # scheduling attempts so far (drives backoff length)
    backoff_expiry: float = 0.0
    # plugins that rejected it (() = unknown -> requeue on any event). A pod
    # requeues when the event can cure ANY of its reasons (upstream: the
    # union of the failed plugins' EventsToRegister hints).
    unschedulable_reasons: tuple[str, ...] = ()
    enqueued_at: float = 0.0


class SchedulingQueue:
    def __init__(
        self,
        initial_backoff_seconds: float = 1.0,
        max_backoff_seconds: float = 10.0,
        unschedulable_timeout_seconds: float = 300.0,
        now: Callable[[], float] = _time.monotonic,
        on_enqueue: Callable[[str, str], None] | None = None,
        journal: Callable[[str, float, dict], None] | None = None,
    ) -> None:
        self._initial = initial_backoff_seconds
        self._max = max_backoff_seconds
        self._timeout = unschedulable_timeout_seconds
        self._now = now
        # (queue_name, event) observer for EVERY tier entry — feeds the
        # upstream scheduler_queue_incoming_pods_total metric; kept in the
        # queue so no transition undercounts
        self._on_enqueue = on_enqueue or (lambda queue, event: None)
        # (op, t, data) observer for the write-ahead journal (state/):
        # None = durability disabled. DurableState.attach wires it.
        self._journal = journal
        self._lock = threading.RLock()
        self._active: dict[str, _QueuedPod] = {}
        self._backoff: dict[str, _QueuedPod] = {}
        self._unschedulable: dict[str, _QueuedPod] = {}
        self._in_flight: dict[str, _QueuedPod] = {}
        self._deleted_in_flight: set[str] = set()

    def set_journal(
        self, journal: Callable[[str, float, dict], None] | None
    ) -> None:
        with self._lock:
            self._journal = journal

    def _emit(self, op: str, t: float, data: dict) -> None:
        if self._journal is not None:
            self._journal(op, t, data)

    # ---- intake ----------------------------------------------------------

    def add(self, pod: Pod) -> None:
        """New pod (informer Add): straight to active."""
        with self._lock:
            now = self._now()
            self._add_locked(pod, now, EVENT_POD_ADD)
            if self._journal is not None:
                self._emit("q.add", now, {"pod": _codec_pod()(pod)})

    def _add_locked(self, pod: Pod, now: float, event: str) -> None:
        uid = pod.uid
        self._backoff.pop(uid, None)
        self._unschedulable.pop(uid, None)
        self._active[uid] = _QueuedPod(pod, enqueued_at=now)
        self._on_enqueue("active", event)

    def update(self, pod: Pod) -> None:
        """Spec/labels changed: an update can unstick its own pod."""
        with self._lock:
            now = self._now()
            if self._journal is not None:
                self._emit("q.update", now, {"pod": _codec_pod()(pod)})
            uid = pod.uid
            for tier in (self._active, self._backoff, self._unschedulable):
                if uid in tier:
                    entry = tier[uid]
                    entry.pod = pod
                    if tier is self._unschedulable:
                        # the update may cure the failure, but the pod's
                        # backoff window still applies (upstream checks
                        # isPodBackingOff here) — otherwise a controller
                        # touching annotations defeats exponential backoff
                        del tier[uid]
                        if entry.backoff_expiry > now:
                            self._backoff[uid] = entry
                            self._on_enqueue("backoff", EVENT_POD_UPDATE)
                        else:
                            self._active[uid] = entry
                            self._on_enqueue("active", EVENT_POD_UPDATE)
                    return
            if uid in self._in_flight:
                # being scheduled right now: refresh the in-flight object so
                # a requeue carries the new spec, but do NOT double-enqueue
                self._in_flight[uid].pod = pod
                return
            self._add_locked(pod, now, EVENT_POD_ADD)

    def delete(self, pod_uid: str) -> None:
        with self._lock:
            changed = False
            for tier in (self._active, self._backoff, self._unschedulable):
                if tier.pop(pod_uid, None) is not None:
                    changed = True
            if pod_uid in self._in_flight:
                # mark so the cycle's requeue discards instead of
                # resurrecting a deleted pod
                self._deleted_in_flight.add(pod_uid)
                changed = True
            if changed:  # a no-op delete journals nothing (replay-exact)
                self._emit("q.delete", self._now(), {"uid": pod_uid})

    # ---- cycle boundary --------------------------------------------------

    def pop_ready(self, hold: bool = False) -> list[Pod]:
        """Drain the active tier — the whole next cycle's pending set.
        Flushes expired backoff first so a ready pod is never left behind.

        `hold=True` is the multi-cycle coalescing variant: groups popped
        by EARLIER cycles are still buffered scheduler-side (their
        outcomes apply at the batch flush), so this pop ACCUMULATES into
        the in-flight set instead of replacing it, and keeps the
        deleted-in-flight tombstones — otherwise a buffered pod would
        lose its attempts count, its delete tombstone, and its crash
        recovery (recover_in_flight) the moment the next group was
        popped. The flag is journaled: replay must reproduce the exact
        in-flight set a takeover recovers."""
        with self._lock:
            now = self._now()
            # journal only a pop that changes SOMETHING: drains pods,
            # flushes backoff, or retires a previous in-flight set — an
            # idle scheduler's empty cycles must not grow the journal
            had_inflight = not hold and (
                bool(self._in_flight) or bool(self._deleted_in_flight)
            )
            flushed = self._flush_backoff_locked(now, "BackoffComplete")
            ready = [e.pod for e in self._active.values()]
            for e in self._active.values():
                e.attempts += 1
            if hold:
                self._in_flight.update(self._active)
            else:
                self._in_flight = dict(self._active)
                self._deleted_in_flight.clear()
            self._active.clear()
            if ready or flushed or had_inflight:
                self._emit(
                    "q.pop", now, {"hold": True} if hold else {}
                )
            return ready

    def retire_in_flight(self, uids: Sequence[str]) -> None:
        """A multi-cycle batch flush applied these pods' outcomes: drop
        them (and their delete tombstones) from the in-flight set.

        Single-cycle serving retires implicitly — the next non-hold
        pop replaces the whole set — but hold pops only ever
        ACCUMULATE, and out-of-phase profile buffers can keep every
        pop holding, so without an explicit retire a bound pod would
        stay "recoverable" forever: unbounded in-flight growth, and a
        leader takeover re-scheduling (re-binding) pods bound
        arbitrarily long ago. Pods the failure paths already requeued
        are not in the set — the membership filter skips them."""
        with self._lock:
            live = [
                u for u in uids
                if u in self._in_flight or u in self._deleted_in_flight
            ]
            if not live:
                return
            now = self._now()
            self._emit("q.retire", now, {"uids": live})
            for u in live:
                self._in_flight.pop(u, None)
                self._deleted_in_flight.discard(u)

    def requeue_unschedulable(
        self, pod: Pod, reasons: Sequence[str] | str = ()
    ) -> None:
        """Cycle found no node (AddUnschedulableIfNotPresent). Goes to the
        unschedulable tier to wait for an event; backoff still advances so
        an event-triggered retry honors it. `reasons` names the rejecting
        plugins (drives the queueing-hint check on later events)."""
        if isinstance(reasons, str):
            reasons = (reasons,) if reasons else ()
        with self._lock:
            now = self._now()
            uid = pod.uid
            # journal BEFORE the deleted-in-flight check: the discard
            # branch mutates state too (clears the tombstone + in-flight
            # entry), and replay must take the same branch it took live
            if self._journal is not None:
                self._emit(
                    "q.unsched", now,
                    {"pod": _codec_pod()(pod),
                     "reasons": list(reasons)},
                )
            if uid in self._deleted_in_flight:
                self._deleted_in_flight.discard(uid)
                self._in_flight.pop(uid, None)
                return
            self._active.pop(uid, None)
            self._backoff.pop(uid, None)
            entry = self._in_flight.pop(uid, None) or _QueuedPod(pod)
            entry.pod = pod
            entry.unschedulable_reasons = tuple(reasons)
            entry.enqueued_at = now
            entry.backoff_expiry = now + self._backoff_for(entry.attempts)
            self._unschedulable[uid] = entry
            self._on_enqueue("unschedulable", "ScheduleAttemptFailure")

    def requeue_backoff(self, pod: Pod, event: str = "BindError") -> None:
        """Transient failure (e.g. bind error): retry after backoff."""
        with self._lock:
            now = self._now()
            uid = pod.uid
            # journal before the deleted-in-flight check (see
            # requeue_unschedulable: the discard branch mutates state)
            if self._journal is not None:
                self._emit(
                    "q.backoff", now,
                    {"pod": _codec_pod()(pod), "event": event},
                )
            if uid in self._deleted_in_flight:
                self._deleted_in_flight.discard(uid)
                self._in_flight.pop(uid, None)
                return
            self._active.pop(uid, None)
            self._unschedulable.pop(uid, None)
            entry = self._in_flight.pop(uid, None) or _QueuedPod(pod)
            entry.pod = pod
            entry.backoff_expiry = now + self._backoff_for(entry.attempts)
            self._backoff[uid] = entry
            self._on_enqueue("backoff", event)

    def _backoff_for(self, attempts: int) -> float:
        return min(self._initial * (2 ** max(attempts - 1, 0)), self._max)

    # ---- event-driven movement ------------------------------------------

    def flush_backoff(self) -> int:
        with self._lock:
            now = self._now()
            n = self._flush_backoff_locked(now, "BackoffComplete")
            if n:  # no-op flushes journal nothing
                self._emit("q.flush_backoff", now, {})
            return n

    def _flush_backoff_locked(self, now: float, event: str) -> int:
        expired = [
            u for u, e in self._backoff.items() if e.backoff_expiry <= now
        ]
        for u in expired:
            self._active[u] = self._backoff.pop(u)
            self._on_enqueue("active", event)
        return len(expired)

    def flush_unschedulable_timeout(self) -> int:
        """Upstream flushUnschedulablePodsLeftover: pods stuck too long
        retry even without an event."""
        with self._lock:
            now = self._now()
            stuck = [
                u for u, e in self._unschedulable.items()
                if now - e.enqueued_at >= self._timeout
            ]
            for u in stuck:
                self._move_out(u, EVENT_UNSCHEDULABLE_TIMEOUT, now)
            if stuck:  # no-op sweeps journal nothing
                self._emit("q.flush_timeout", now, {})
            return len(stuck)

    def move_all_to_active_or_backoff(self, event: str) -> int:
        """Informer event: move unschedulable pods whose failure the event
        can cure (queueing hints) to backoff (or active if expired)."""
        with self._lock:
            now = self._now()
            moved = 0
            for u in list(self._unschedulable):
                reasons = self._unschedulable[u].unschedulable_reasons
                if reasons and not any(
                    event in QUEUEING_HINTS.get(r, frozenset({event}))
                    for r in reasons
                ):
                    continue
                self._move_out(u, event, now)
                moved += 1
            if moved:
                # gated: this runs on EVERY informer event — journaling
                # the no-op moves would dominate the journal at scale
                self._emit("q.move", now, {"event": event})
            return moved

    def _move_out(self, uid: str, event: str, now: float) -> None:
        entry = self._unschedulable.pop(uid, None)
        if entry is None:
            return
        if entry.backoff_expiry > now:
            self._backoff[uid] = entry
            self._on_enqueue("backoff", event)
        else:
            self._active[uid] = entry
            self._on_enqueue("active", event)

    # ---- durability (state/ package) -------------------------------------

    def recover_in_flight(self) -> int:
        """Takeover recovery: requeue pods that were IN FLIGHT when the
        previous leader died — their cycle's outcome records never made
        it to the journal, so without this they would be silently
        dropped by the next pop_ready's in-flight reset. Attempts are
        preserved (the crashed attempt never concluded); a pod the
        informer re-added meanwhile keeps its fresher active entry.
        Journaled like any mutator, so a crash right after recovery
        replays it. The Scheduler calls this once after
        DurableState.attach; replay applies it via the q.recover op."""
        with self._lock:
            now = self._now()
            n = 0
            for uid, e in self._in_flight.items():
                if uid in self._deleted_in_flight:
                    continue
                if uid not in self._active:
                    e.enqueued_at = now
                    self._active[uid] = e
                    self._on_enqueue("active", "LeaderTakeover")
                    n += 1
            had = bool(self._in_flight) or bool(self._deleted_in_flight)
            self._in_flight = {}
            self._deleted_in_flight.clear()
            if had:
                self._emit("q.recover", now, {})
            return n

    def dump_state(self) -> dict:
        """Full durable state as JSON-able plain data (snapshot payload).
        Tier entry order is insertion order and is part of the contract —
        replay reproduces it, so digests compare order-sensitively."""
        from ..state.codec import pod_to_state

        def entry(e: _QueuedPod) -> dict:
            return {
                "pod": pod_to_state(e.pod),
                "attempts": e.attempts,
                "backoff_expiry": e.backoff_expiry,
                "reasons": list(e.unschedulable_reasons),
                "enqueued_at": e.enqueued_at,
            }

        with self._lock:
            return {
                "active": [entry(e) for e in self._active.values()],
                "backoff": [entry(e) for e in self._backoff.values()],
                "unschedulable": [
                    entry(e) for e in self._unschedulable.values()
                ],
                "in_flight": [entry(e) for e in self._in_flight.values()],
                "deleted_in_flight": sorted(self._deleted_in_flight),
            }

    def load_state(self, state: dict) -> None:
        """Inverse of dump_state: replace this queue's contents. Expiry
        and enqueue timestamps are restored verbatim — they are
        CLOCK_MONOTONIC values valid on the host that wrote them (the
        same-host failover contract; see state/__init__)."""
        from ..state.codec import pod_from_state

        def entry(d: dict) -> _QueuedPod:
            return _QueuedPod(
                pod=pod_from_state(d["pod"]),
                attempts=int(d.get("attempts", 0)),
                backoff_expiry=float(d.get("backoff_expiry", 0.0)),
                unschedulable_reasons=tuple(d.get("reasons", ())),
                enqueued_at=float(d.get("enqueued_at", 0.0)),
            )

        with self._lock:
            for name, tier in (
                ("active", self._active),
                ("backoff", self._backoff),
                ("unschedulable", self._unschedulable),
                ("in_flight", self._in_flight),
            ):
                tier.clear()
                for d in state.get(name, ()):
                    e = entry(d)
                    tier[e.pod.uid] = e
            self._deleted_in_flight = set(state.get("deleted_in_flight", ()))

    # ---- introspection ---------------------------------------------------

    def attempts_of(self, uid: str) -> int:
        """Scheduling attempts the in-flight pod has used (1 = first try)."""
        with self._lock:
            e = self._in_flight.get(uid)
            return e.attempts if e else 1

    def pending_counts(self) -> dict[str, int]:
        """Tier sizes, keyed like the upstream pending_pods{queue=...}
        metric labels."""
        with self._lock:
            return {
                "active": len(self._active),
                "backoff": len(self._backoff),
                "unschedulable": len(self._unschedulable),
            }

    def all_pending(self) -> Iterable[Pod]:
        with self._lock:
            entries = [
                e.pod
                for tier in (self._active, self._backoff, self._unschedulable)
                for e in tier.values()
            ]
        return entries

    def __len__(self) -> int:
        with self._lock:
            return (
                len(self._active)
                + len(self._backoff)
                + len(self._unschedulable)
            )
