"""The port's copy of `k8s_scheduler_tpu/core/events.py` (pure Python, the reference's names
and structure).

Events: the upstream event stream (`Scheduled` / `FailedScheduling` /
`Preempted`), as an injectable recorder.

The reference family posts Kubernetes Events per pod with per-plugin
failure reasons ("0/5 nodes are available: 3 Insufficient cpu, ...";
upstream's `EventBroadcaster`). There is no API server here to post to, so the recorder
keeps a bounded in-memory ring + structured logging, which doubles as the
per-cycle decision log the batched design needs; the gRPC shim drains the
ring into each CycleResponse so the cluster agent can post real Events.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
from typing import Iterable

from ..models.api import Pod

log = logging.getLogger("k8s_scheduler_tpu_torch.events")

# Event reasons, upstream names
SCHEDULED = "Scheduled"
FAILED_SCHEDULING = "FailedScheduling"
PREEMPTED = "Preempted"
# batched-cycle addition: the assumed-pod TTL sweep used to drop pods
# silently — this reason makes the expiry explainable per pod
ASSUME_EXPIRED = "AssumeExpired"
# robustness additions: scheduler-level (pod-less) events — a consumed
# cycle's fetch failure and degradation-ladder rung transitions must
# leave an on-box trace even though no single pod owns them
FETCH_FAILED = "FetchFailed"
DEGRADED = "Degraded"
PROMOTED = "Promoted"
# watchtower additions: alert-rule transitions (metrics/rules.py) ride
# the events ring too — the literals live in rules.py so metrics/ stays
# importable without core/, and these constants keep the reason
# namespace discoverable in one place
ALERT_FIRING = "AlertFiring"
ALERT_RESOLVED = "AlertResolved"


@dataclasses.dataclass(frozen=True)
class Event:
    type: str  # "Normal" | "Warning"
    reason: str  # Scheduled | FailedScheduling | Preempted
    pod_uid: str
    pod_name: str
    message: str


def failed_scheduling_message(
    num_nodes: int, reject_counts: Iterable[tuple[str, int]]
) -> str:
    """Upstream-style diagnosis line: '0/5 nodes are available:
    3 NodeResourcesFit, 2 NodeAffinity.' — counts are nodes first-rejected
    per plugin (CycleResult.reject_counts row)."""
    parts = [f"{int(n)} {name}" for name, n in reject_counts if n > 0]
    detail = ", ".join(parts) if parts else "no nodes matched"
    return f"0/{num_nodes} nodes are available: {detail}."


class EventRecorder:
    """Bounded in-memory event ring + structured log line per event.

    Thread-safe; `events()` snapshots for tests/endpoints; the gRPC shim
    calls `drain()` per Cycle so events ride the CycleResponse."""

    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()
        self._ring: collections.deque[Event] = collections.deque(
            maxlen=capacity
        )

    def record(self, type_: str, reason: str, pod: Pod, message: str) -> None:
        ev = Event(type_, reason, pod.uid, pod.name, message)
        with self._lock:
            self._ring.append(ev)
        log.info(
            "event", extra={"event_reason": reason, "pod": pod.name,
                            "event_message": message}
        )

    def scheduled(self, pod: Pod, node_name: str) -> None:
        self.record(
            "Normal", SCHEDULED, pod,
            f"Successfully assigned {pod.namespace}/{pod.name} to {node_name}",
        )

    def failed_scheduling(self, pod: Pod, message: str) -> None:
        self.record("Warning", FAILED_SCHEDULING, pod, message)

    def preempted(self, victim: Pod, preemptor_name: str) -> None:
        self.record(
            "Normal", PREEMPTED, victim,
            f"Preempted by pod {preemptor_name}",
        )

    def system(self, reason: str, message: str) -> None:
        """A scheduler-level event with no owning pod (fetch failures,
        degradation-ladder transitions): rides the same ring/drain path
        as pod events with an empty uid and the synthetic name
        "scheduler", so the gRPC shim forwards it like any other."""
        ev = Event("Warning", reason, "", "scheduler", message)
        with self._lock:
            self._ring.append(ev)
        log.warning(
            "event", extra={"event_reason": reason, "pod": "scheduler",
                            "event_message": message}
        )

    def assume_expired(self, pod: Pod, node_name: str) -> None:
        self.record(
            "Warning", ASSUME_EXPIRED, pod,
            f"assumed binding to {node_name} expired without bind "
            "confirmation; pod requeued with backoff",
        )

    def events(self) -> list[Event]:
        with self._lock:
            return list(self._ring)

    def events_for(self, pod_uid: str) -> list[Event]:
        """Events still in the ring for one pod — the events-ring half of
        the per-pod scheduling timeline join (Scheduler.pod_timeline).
        Empty after the gRPC shim drained the ring; the flight recorder's
        own pod timeline is the durable half."""
        with self._lock:
            return [e for e in self._ring if e.pod_uid == pod_uid]

    def drain(self) -> list[Event]:
        """Pop everything recorded so far (the gRPC shim calls this per
        Cycle response so the agent can post real Kubernetes Events)."""
        with self._lock:
            out = list(self._ring)
            self._ring.clear()
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
