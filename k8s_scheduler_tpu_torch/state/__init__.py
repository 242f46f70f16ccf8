"""Durable scheduler state, the port's copy of `k8s_scheduler_tpu/state/`
(pure Python, the reference's names, record formats and on-disk formats:
a journal or snapshot written by either package restores in the other).

A takeover without durable state drops the `SchedulingQueue`'s backoff
deadlines and attempt counts and the `SchedulerCache`'s assumed but
unconfirmed pods. This package is the crash-consistent state layer that
keeps them:

- `journal.py` — checksummed, segment-rotated write-ahead journal of
  logical queue/cache mutations, drained by a writer thread with group
  fsync (appends never touch the bind path's latency budget);
- `codec.py` — hand-rolled Pod/Node <-> plain-dict converters (the
  journal/snapshot wire format) plus the canonical state digest;
- `snapshot.py` — atomic whole-state snapshots that compact the journal
  (write-temp + fsync + rename);
- `manager.py` — `DurableState`: wires emitters into a live queue/cache
  pair, restores snapshot+tail on attach, snapshots on an interval, and
  seals the journal on clean shutdown.

Replay is exact: each journal record carries the emitting clock value and
restore re-executes the logical operation under a replay clock, so backoff
expiries, attempt counts and assumed-pod TTL deadlines come back
bit-identical. Timestamps are the host's CLOCK_MONOTONIC — valid for
same-host failover (the FileLease deployment shape); snapshots carry a
wall-clock anchor for observability.
"""

from .journal import (
    FORMAT_VERSION,
    Journal,
    StateCorruption,
    StateError,
    StateVersionError,
    replay_dir,
)
from .codec import state_digest
from .manager import DurableState

__all__ = [
    "FORMAT_VERSION",
    "Journal",
    "DurableState",
    "StateCorruption",
    "StateError",
    "StateVersionError",
    "replay_dir",
    "state_digest",
]
