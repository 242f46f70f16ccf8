"""The port's copy of `k8s_scheduler_tpu/internal/cache.py` (pure Python,
the reference's names and structure), with its journaling hooks.

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
from elsewhere (re-entrant so the durable-state snapshot can hold it
across a consistent dump).

Durability contract (state/ package): same as SchedulingQueue — each
public mutator reads the clock once, applies, and emits one journal
record with that clock value, so replay under a pinned clock reproduces
assumed-pod TTL deadlines exactly.
"""

from __future__ import annotations

import dataclasses
import threading
import time as _time
from typing import Callable

from ..models.api import Node, Pod

# codec bindings for journal emission, bound on first use so schedulers
# without durability never import state/ — and journaling mutators skip
# per-call import machinery inside the cache lock
_pod_to_state = _node_to_state = None


def _codec():
    global _pod_to_state, _node_to_state
    if _pod_to_state is None:
        from ..state.codec import node_to_state, pod_to_state

        _pod_to_state = pod_to_state
        _node_to_state = node_to_state
    return _pod_to_state, _node_to_state


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
        journal: Callable[[str, float, dict], None] | None = None,
    ) -> None:
        self._ttl = assumed_pod_ttl_seconds
        self._now = now
        self._lock = threading.RLock()
        self._journal = journal
        self._nodes: dict[str, Node] = {}
        self._bound: dict[str, tuple[Pod, str]] = {}  # uid -> (pod, node)
        self._assumed: dict[str, _AssumedPod] = {}

    def set_journal(
        self, journal: Callable[[str, float, dict], None] | None
    ) -> None:
        with self._lock:
            self._journal = journal

    def _emit(self, op: str, data: dict) -> None:
        if self._journal is not None:
            self._journal(op, self._now(), data)

    def _emit_node(self, op: str, node: Node) -> None:
        if self._journal is not None:
            self._journal(
                op, self._now(), {"node": _codec()[1](node)}
            )

    # ---- node events -----------------------------------------------------

    def add_node(self, node: Node) -> None:
        with self._lock:
            self._nodes[node.name] = node
            self._emit_node("c.add_node", node)

    def update_node(self, node: Node) -> None:
        with self._lock:
            self._nodes[node.name] = node
            self._emit_node("c.update_node", node)

    def remove_node(self, node_name: str) -> None:
        with self._lock:
            if self._nodes.pop(node_name, None) is not None:
                self._emit("c.remove_node", {"name": node_name})

    # ---- pod events (bound pods observed via informer) -------------------

    def add_pod(self, pod: Pod, node_name: str) -> None:
        """A bound pod appeared (or an assumed pod's bind was observed)."""
        with self._lock:
            self._assumed.pop(pod.uid, None)
            self._bound[pod.uid] = (pod, node_name)
            if self._journal is not None:
                self._emit(
                    "c.add_pod",
                    {"pod": _codec()[0](pod), "node": node_name},
                )

    def remove_pod(self, pod_uid: str) -> None:
        with self._lock:
            b = self._bound.pop(pod_uid, None)
            a = self._assumed.pop(pod_uid, None)
            if b is not None or a is not None:
                self._emit("c.remove_pod", {"uid": pod_uid})

    # ---- assume lifecycle ------------------------------------------------

    def assume(self, pod: Pod, node_name: str) -> None:
        with self._lock:
            if pod.uid in self._bound:
                # raise WITHOUT emitting: a refused assume must not be
                # replayed (replay would refuse it again and abort)
                raise ValueError(f"pod {pod.name} already bound")
            self._assumed[pod.uid] = _AssumedPod(pod, node_name)
            if self._journal is not None:
                self._emit(
                    "c.assume",
                    {"pod": _codec()[0](pod), "node": node_name},
                )

    def finish_binding(self, pod_uid: str) -> None:
        with self._lock:
            now = self._now()
            a = self._assumed.get(pod_uid)
            if a is not None:
                a.binding_finished = True
                a.deadline = now + self._ttl
                if self._journal is not None:
                    self._journal("c.finish_binding", now, {"uid": pod_uid})

    def confirm(self, pod_uid: str) -> None:
        """Bind confirmed by the cluster store (add_pod also confirms)."""
        with self._lock:
            a = self._assumed.pop(pod_uid, None)
            if a is not None:
                self._bound[pod_uid] = (a.pod, a.node_name)
                self._emit("c.confirm", {"uid": pod_uid})

    def forget(self, pod_uid: str) -> None:
        with self._lock:
            if self._assumed.pop(pod_uid, None) is not None:
                self._emit("c.forget", {"uid": pod_uid})

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
        explain the expiry (events ring + pod timeline — upstream logs
        and drops; the informer re-delivers the pod as still-pending)."""
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
            if out and self._journal is not None:
                # gated: this sweep runs every cycle — an idle scheduler
                # must not grow the journal with no-op records. Emits the
                # SAME `now` the sweep used (read-clock-once contract): a
                # second read could stamp a later t under which replay
                # would expire deadlines this sweep did not.
                self._journal("c.expire", now, {})
            return out

    # ---- durability (state/ package) -------------------------------------

    def dump_state(self) -> dict:
        from ..state.codec import node_to_state, pod_to_state

        with self._lock:
            return {
                "nodes": [
                    node_to_state(n) for n in self._nodes.values()
                ],
                "bound": [
                    {"pod": pod_to_state(p), "node": n}
                    for p, n in self._bound.values()
                ],
                "assumed": [
                    {
                        "pod": pod_to_state(a.pod),
                        "node": a.node_name,
                        "finished": a.binding_finished,
                        "deadline": a.deadline,
                    }
                    for a in self._assumed.values()
                ],
            }

    def load_state(self, state: dict) -> None:
        from ..state.codec import node_from_state, pod_from_state

        with self._lock:
            self._nodes.clear()
            self._bound.clear()
            self._assumed.clear()
            for d in state.get("nodes", ()):
                n = node_from_state(d)
                self._nodes[n.name] = n
            for d in state.get("bound", ()):
                p = pod_from_state(d["pod"])
                self._bound[p.uid] = (p, d["node"])
            for d in state.get("assumed", ()):
                p = pod_from_state(d["pod"])
                self._assumed[p.uid] = _AssumedPod(
                    pod=p,
                    node_name=d["node"],
                    binding_finished=bool(d.get("finished", False)),
                    deadline=float(d.get("deadline", 0.0)),
                )

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
