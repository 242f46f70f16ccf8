"""The port's copy of `k8s_scheduler_tpu/internal/cache.py` (pure Python,
the reference's names and structure), without durable state: the
journaling hooks (the reference's `journal=`, `set_journal`, `_codec`,
`dump_state`, `load_state`) belong to the durable-state slice (ROADMAP
A10b).

SchedulerCache: node/pod stores with the assume/confirm/forget lifecycle.
The cache owns the object lists the encoder consumes and answers "which
pods count as existing on node X right now":

    assume(pod, node)      cycle picked a node; counts as existing at once
    finish_binding(pod)    bind RPC dispatched; TTL starts
    confirm(pod)           API bound event arrived; assumed -> bound
    forget(pod)            bind failed; drop the assumption
    cleanup_expired()      assumed-pod TTL sweep (upstream cleanupAssumedPods)

Time is injected for tests. Thread-safety: a single RLock around
mutations — the cycle runs single-threaded; informer callbacks may come
from elsewhere.
"""

from __future__ import annotations

import dataclasses
import threading
import time as _time
from typing import Callable

from ..models.api import Node, Pod


@dataclasses.dataclass
class _AssumedPod:
    pod: Pod
    node_name: str
    binding_finished: bool = False
    deadline: float = 0.0


class SchedulerCache:
    def __init__(
        self,
        assumed_pod_ttl_seconds: float = 30.0,
        now: Callable[[], float] = _time.monotonic,
    ) -> None:
        self._ttl = assumed_pod_ttl_seconds
        self._now = now
        self._lock = threading.RLock()
        self._nodes: dict[str, Node] = {}
        self._bound: dict[str, tuple[Pod, str]] = {}  # uid -> (pod, node)
        self._assumed: dict[str, _AssumedPod] = {}

    # ---- node events -----------------------------------------------------

    def add_node(self, node: Node) -> None:
        with self._lock:
            self._nodes[node.name] = node

    def update_node(self, node: Node) -> None:
        with self._lock:
            self._nodes[node.name] = node

    def remove_node(self, node_name: str) -> None:
        with self._lock:
            self._nodes.pop(node_name, None)

    # ---- pod events (bound pods observed via informer) -------------------

    def add_pod(self, pod: Pod, node_name: str) -> None:
        """A bound pod appeared (or an assumed pod's bind was observed)."""
        with self._lock:
            self._assumed.pop(pod.uid, None)
            self._bound[pod.uid] = (pod, node_name)

    def remove_pod(self, pod_uid: str) -> None:
        with self._lock:
            self._bound.pop(pod_uid, None)
            self._assumed.pop(pod_uid, None)

    # ---- assume lifecycle ------------------------------------------------

    def assume(self, pod: Pod, node_name: str) -> None:
        with self._lock:
            if pod.uid in self._bound:
                raise ValueError(f"pod {pod.name} already bound")
            self._assumed[pod.uid] = _AssumedPod(pod, node_name)

    def finish_binding(self, pod_uid: str) -> None:
        with self._lock:
            a = self._assumed.get(pod_uid)
            if a is not None:
                a.binding_finished = True
                a.deadline = self._now() + self._ttl

    def confirm(self, pod_uid: str) -> None:
        """Bind confirmed by the cluster store (add_pod also confirms)."""
        with self._lock:
            a = self._assumed.pop(pod_uid, None)
            if a is not None:
                self._bound[pod_uid] = (a.pod, a.node_name)

    def forget(self, pod_uid: str) -> None:
        with self._lock:
            self._assumed.pop(pod_uid, None)

    def is_assumed(self, pod_uid: str) -> bool:
        with self._lock:
            return pod_uid in self._assumed

    def has_pod(self, pod_uid: str) -> bool:
        """Known to the cluster state: bound or assumed."""
        with self._lock:
            return pod_uid in self._bound or pod_uid in self._assumed

    def cleanup_expired(self) -> list[tuple[Pod, str]]:
        """Drop assumed pods whose bind confirmation never arrived;
        returns (pod, node_name) pairs so the caller can requeue AND
        explain the expiry (events ring + pod timeline)."""
        with self._lock:
            now = self._now()
            gone = [
                u for u, a in self._assumed.items()
                if a.binding_finished and a.deadline <= now
            ]
            out = []
            for u in gone:
                a = self._assumed.pop(u)
                out.append((a.pod, a.node_name))
            return out

    # ---- snapshot --------------------------------------------------------

    def nodes(self) -> list[Node]:
        with self._lock:
            return list(self._nodes.values())

    def existing_pods(self) -> list[tuple[Pod, str]]:
        """Bound + assumed pods — what the encoder treats as `existing`."""
        with self._lock:
            out = list(self._bound.values())
            out.extend((a.pod, a.node_name) for a in self._assumed.values())
            return out

    def counts(self) -> dict[str, int]:
        with self._lock:
            return {
                "nodes": len(self._nodes),
                "bound": len(self._bound),
                "assumed": len(self._assumed),
            }
