"""FailedScheduling reasons (`k8s_scheduler_tpu/core/events.py`): the
diagnosis line of one pod from its row of reject counts (a full cycle's
`CycleResult.reject_counts` or the diagnosis program's output, columns
`Framework.filter_names`)."""

from __future__ import annotations

from typing import Iterable


def failed_scheduling_message(num_nodes: int,
                              reject_counts: Iterable[tuple[str, int]]) -> str:
    """Upstream-style diagnosis line: '0/5 nodes are available:
    3 NodeResourcesFit, 2 NodeAffinity.' — counts are nodes first rejected
    per plugin; zero counts are left out."""
    parts = [f"{int(n)} {name}" for name, n in reject_counts if n > 0]
    detail = ", ".join(parts) if parts else "no nodes matched"
    return f"0/{num_nodes} nodes are available: {detail}."
