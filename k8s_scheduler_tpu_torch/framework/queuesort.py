"""QueueSort extension point (reference `framework/queuesort.py`).

Upstream's queueSort plugin supplies `Less(podInfo1, podInfo2)` and owns
the active queue's order; exactly one is enabled per scheduler. Here, as
in the reference, there is no host-side heap: the encoder bakes the queue
order into the snapshot's `pod_order` rank, which every commit engine
honours (the scan commits in rank order, the rounds engine arbitrates
same-target contention by rank, preemption fills its window by rank). The
extension point is a batched rank function called at encode time:
`rank(pods, priorities, creation) -> i32 [n]` queue positions, one lexsort
instead of a comparator sort with Python callbacks.

The port keeps its own copy (numpy only) of the reference's plugins,
registry and `queue_sort_for_profile`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class QueueSortPlugin:
    """Protocol: subclasses order the pending set. `rank` returns each
    pod's queue position (0 = scheduled first) as an i32 array over the
    real pods; the encoder puts the ranks into the padded `pod_order`
    field (pad slots get INT32_MAX)."""

    name = "QueueSort"

    def __init__(self, args: dict | None = None):
        self.args = dict(args or {})

    def rank(
        self,
        pods: Sequence,
        priorities: np.ndarray,  # i32 [n] spec.priority
        creation: np.ndarray,  # f64 [n] creationTimestamp
    ) -> np.ndarray:
        raise TypeError(
            f"{type(self).__name__} must implement rank() "
            "(QueueSortPlugin is a protocol, not a usable plugin)"
        )


def _ranks_from_order(order_key: np.ndarray, n: int) -> np.ndarray:
    out = np.empty(n, np.int32)
    out[order_key] = np.arange(n, dtype=np.int32)
    return out


class PrioritySort(QueueSortPlugin):
    """Default queueSort: priority desc, creation asc, index as the final
    deterministic tie-break (upstream compares pod UIDs last; the encode
    index is the stable equivalent)."""

    name = "PrioritySort"

    def rank(self, pods, priorities, creation):
        n = len(pods)
        order_key = np.lexsort((np.arange(n), creation[:n], -priorities[:n]))
        return _ranks_from_order(order_key, n)


class CreationSort(QueueSortPlugin):
    """FIFO by creation timestamp, priority ignored (args
    `{"newest_first": True}` makes it LIFO)."""

    name = "CreationSort"

    def rank(self, pods, priorities, creation):
        n = len(pods)
        c = creation[:n]
        if self.args.get("newest_first"):
            c = -c
        order_key = np.lexsort((np.arange(n), c))
        return _ranks_from_order(order_key, n)


_QUEUE_SORTS: dict[str, type[QueueSortPlugin]] = {
    PrioritySort.name: PrioritySort,
    CreationSort.name: CreationSort,
}


def register_queue_sort(cls: type[QueueSortPlugin]) -> type[QueueSortPlugin]:
    """Register a custom queueSort plugin class (usable as a decorator)."""
    _QUEUE_SORTS[cls.name] = cls
    return cls


def make_queue_sort(name: str, args: dict | None = None) -> QueueSortPlugin:
    cls = _QUEUE_SORTS.get(name)
    if cls is None:
        raise KeyError(
            f"unknown queueSort plugin {name!r}; registered: {sorted(_QUEUE_SORTS)}"
        )
    return cls(args)


def queue_sort_for_profile(profile) -> QueueSortPlugin:
    """A config `Profile`'s queueSort plugin. Exactly one is active, as
    upstream: an enabled plugin replaces the default outright; otherwise
    PrioritySort (also when everything is disabled: a queue needs an
    order)."""
    qs = profile.plugins.queue_sort
    name = qs.enabled[0].name if qs.enabled else PrioritySort.name
    return make_queue_sort(name, profile.plugin_config.get(name))
