"""The port's copy of `k8s_scheduler_tpu/internal/queue.py` (pure Python,
the reference's names and structure), without durable state: the
journaling hooks (`journal=`, `set_journal`, `recover_in_flight`,
`dump_state`, `load_state`) belong to the durable-state slice (ROADMAP
A10b).

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
"""

from __future__ import annotations

import dataclasses
import threading
import time as _time
from typing import Callable, Iterable, Sequence

from ..models.api import Pod

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


@dataclasses.dataclass
class _QueuedPod:
    pod: Pod
    attempts: int = 0  # scheduling attempts so far (drives backoff length)
    backoff_expiry: float = 0.0
    # plugins that rejected it (() = unknown -> requeue on any event). A pod
    # requeues when the event can cure ANY of its reasons.
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
    ) -> None:
        self._initial = initial_backoff_seconds
        self._max = max_backoff_seconds
        self._timeout = unschedulable_timeout_seconds
        self._now = now
        # (queue_name, event) observer for EVERY tier entry — feeds the
        # upstream scheduler_queue_incoming_pods_total metric
        self._on_enqueue = on_enqueue or (lambda queue, event: None)
        self._lock = threading.RLock()
        self._active: dict[str, _QueuedPod] = {}
        self._backoff: dict[str, _QueuedPod] = {}
        self._unschedulable: dict[str, _QueuedPod] = {}
        self._in_flight: dict[str, _QueuedPod] = {}
        self._deleted_in_flight: set[str] = set()

    # ---- intake ----------------------------------------------------------

    def add(self, pod: Pod) -> None:
        """New pod (informer Add): straight to active."""
        with self._lock:
            self._add_locked(pod, self._now(), EVENT_POD_ADD)

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
            uid = pod.uid
            for tier in (self._active, self._backoff, self._unschedulable):
                if uid in tier:
                    entry = tier[uid]
                    entry.pod = pod
                    if tier is self._unschedulable:
                        # the update may cure the failure, but the pod's
                        # backoff window still applies (upstream checks
                        # isPodBackingOff here)
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
            for tier in (self._active, self._backoff, self._unschedulable):
                tier.pop(pod_uid, None)
            if pod_uid in self._in_flight:
                # mark so the cycle's requeue discards instead of
                # resurrecting a deleted pod
                self._deleted_in_flight.add(pod_uid)

    # ---- cycle boundary --------------------------------------------------

    def pop_ready(self, hold: bool = False) -> list[Pod]:
        """Drain the active tier — the whole next cycle's pending set.
        Flushes expired backoff first so a ready pod is never left behind.
        `hold=True` (the multi-cycle coalescing variant) accumulates into
        the in-flight set instead of replacing it."""
        with self._lock:
            now = self._now()
            self._flush_backoff_locked(now, "BackoffComplete")
            ready = [e.pod for e in self._active.values()]
            for e in self._active.values():
                e.attempts += 1
            if hold:
                self._in_flight.update(self._active)
            else:
                self._in_flight = dict(self._active)
                self._deleted_in_flight.clear()
            self._active.clear()
            return ready

    def retire_in_flight(self, uids: Sequence[str]) -> None:
        """These pods' outcomes were applied: drop them (and their delete
        tombstones) from the in-flight set."""
        with self._lock:
            for u in uids:
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
            return self._flush_backoff_locked(self._now(), "BackoffComplete")

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
