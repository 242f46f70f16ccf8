"""The port's copy of `k8s_scheduler_tpu/core/degrade.py` (pure Python, the reference's names
and structure).

The explicit degradation ladder: every recovery mode, ordered.

The repo's failure handling used to be real but implicit — `_Resilient`
retried, a journal death silently went stateless, a wedge killed the
process and the standby took over. This module names the modes and
drives transitions between them, so a dispatch failure walks an
EXPLICIT, observable recovery ladder instead of an ad-hoc one:

    rung 0  normal       full async pipeline; `_Resilient` retries
                         absorb transient flakes invisibly
    rung 1  retrace      compiled-program memos cleared (the
                         clear_cache+retrace recovery, regime-wide)
    rung 2  sequential   multi-cycle batching off — every cycle is its
                         own dispatch (smaller blast radius per fault)
    rung 3  forced_sync  every dispatch blocks to completion (no
                         in-flight state to lose; the measurement mode,
                         now a recovery mode)
    rung 4  stateless    durable state sealed + detached for failover;
                         serving continues without durability (the
                         standby restores the sealed snapshot)

The literal `RUNGS` tuple is the inventory of record: schedlint ID007
pins the README "## Failure model & degradation ladder" rung table to
it. Each transition (both directions) is emitted as an events-ring
entry, a typed `degraded` anomaly in /debug/anomalies, the
`scheduler_degradation_rung` gauge, and a
`scheduler_degradation_transitions_total{from,to}` counter increment;
the current rung rides `/healthz` and `/debug/state`.

Degradation state is PROCESS-LOCAL, deliberately never journaled as
authoritative: a standby that takes over starts at the top rung and
walks down only on its own evidence (the fault may have died with the
old process — tests/test_state_failover.py asserts the restart-at-top
behavior). Promotion is automatic: `promote_after` consecutive clean
scheduling cycles step one rung back up, so a cleared fault recovers
the full pipeline without operator action.
"""

from __future__ import annotations

import collections
import logging
import threading
import time as _time
from typing import Callable

log = logging.getLogger("k8s_scheduler_tpu_torch.degrade")

# Bounded transition-log depth: a long-lived process under a persistent
# fault degrades every cycle, and an unbounded list would grow one dict
# per degrade forever. The ring keeps the recent window the soaks and bench
# config 7 read for MTTR; the exact lifetime counts live in the
# `degradations` / `transitions_total` counters and the
# `scheduler_degradation_transitions_total` metric, which never lose
# precision to the cap.
TRANSITIONS_CAP = 512

# The ladder, top first. Index IS the rung number; schedlint ID007 pins
# the README rung table to this literal tuple.
RUNGS = (
    "normal",
    "retrace",
    "sequential",
    "forced_sync",
    "stateless",
)

RUNG_NORMAL = 0
RUNG_RETRACE = 1
RUNG_SEQUENTIAL = 2
RUNG_FORCED_SYNC = 3
RUNG_STATELESS = 4


class DegradationLadder:
    """Rung state + transition plumbing. Thread model: `degrade` and
    `note_clean_cycle` run on the scheduling loop; readers (`/healthz`
    closures, `/debug/state`) take the same small lock. The
    `on_transition(old, new, reason)` callback runs WITHOUT the lock
    held (it clears program memos / seals state — work that must not
    nest under a status read)."""

    def __init__(
        self,
        *,
        promote_after: int = 8,
        metrics=None,  # SchedulerMetrics | None
        events=None,  # core/events.EventRecorder | None
        observer=None,  # core/observe.CycleObserver | None
        on_transition: "Callable[[int, int, str], None] | None" = None,
    ) -> None:
        self._lock = threading.Lock()
        self.promote_after = max(int(promote_after), 1)
        self.rung = RUNG_NORMAL
        # promotion floor: the ladder never promotes below this rung.
        # The scheduler pins it at RUNG_STATELESS after sealing durable
        # state away — serving at lower rungs could resume, but
        # reporting rung 0 ("normal") while every mutation since the
        # seal is unjournaled would be a lie; the standby takeover (or
        # a restart) is the recovery that clears it.
        self.floor = RUNG_NORMAL
        self.last_reason = ""
        self._clean = 0
        self._metrics = metrics
        self._events = events
        self._observer = observer
        self._on_transition = on_transition
        # transition log (soaks and bench config 7 read it for MTTR):
        # each entry carries both clocks so recovery time is measurable
        # in wall seconds. A bounded ring: a
        # process degrading every cycle for weeks must not grow one
        # dict per fault — `transitions_total` keeps the exact count.
        self.transitions: "collections.deque[dict]" = collections.deque(
            maxlen=TRANSITIONS_CAP
        )
        self.transitions_total = 0
        self.degradations = 0
        if metrics is not None:
            metrics.degradation_rung.set(0)

    # ---- transitions -----------------------------------------------------

    def degrade(self, reason: str, seq: int = -1) -> int:
        """Step one rung DOWN (toward stateless); returns the new rung.
        At the bottom rung further failures re-emit the event/anomaly
        (the operator must see continued failures) without moving — and
        RE-FIRE `on_transition`: the rung's side
        effects (the retrace memo clear) must be re-applied under
        continued failure, or a stale executable installed after the
        last clear survives into every subsequent retry."""
        with self._lock:
            old = self.rung
            new = min(old + 1, len(RUNGS) - 1)
            self.rung = new
            self.last_reason = reason
            self._clean = 0
            self.degradations += 1
        self._emit(old, new, reason, seq, down=True)
        return new

    def note_clean_cycle(self, seq: int = -1) -> None:
        """One scheduling cycle completed without a dispatch failure;
        after `promote_after` in a row, step one rung back UP — never
        below `floor` (the scheduler pins the floor at `stateless` once
        durable state is sealed away: durability cannot come back in
        this process, so the ladder must not report full recovery)."""
        with self._lock:
            if self.rung <= max(RUNG_NORMAL, self.floor):
                self._clean = 0
                return
            self._clean += 1
            if self._clean < self.promote_after:
                return
            old = self.rung
            new = old - 1
            self.rung = new
            self._clean = 0
        self._emit(
            old, new,
            f"promoted after {self.promote_after} clean cycles", seq,
            down=False,
        )

    def _emit(
        self, old: int, new: int, reason: str, seq: int, down: bool
    ) -> None:
        entry = {
            "from": old,
            "to": new,
            "from_name": RUNGS[old],
            "to_name": RUNGS[new],
            "reason": reason,
            "seq": seq,
            "t": _time.perf_counter(),
            "wall": _time.time(),
        }
        with self._lock:
            self.transitions.append(entry)
            self.transitions_total += 1
        # direction comes from the CALLER's intent, not old/new order:
        # a degrade() at the sticky bottom rung keeps old == new, and
        # inferring direction from the comparison would report those
        # continued failures as promotions
        direction = "DOWN" if down else "up"
        log.warning(
            "degradation ladder %s: rung %d (%s) -> %d (%s): %s",
            direction, old, RUNGS[old], new, RUNGS[new], reason,
        )
        m = self._metrics
        if m is not None:
            m.degradation_rung.set(new)
            if new != old:
                m.degradation_transitions.labels(
                    RUNGS[old], RUNGS[new]
                ).inc()
        ev = self._events
        if ev is not None:
            from .events import DEGRADED, PROMOTED

            ev.system(
                DEGRADED if down else PROMOTED,
                f"degradation ladder rung {old} ({RUNGS[old]}) -> "
                f"{new} ({RUNGS[new]}): {reason}",
            )
        obs = self._observer
        if obs is not None:
            obs.raise_anomaly(
                "degraded",
                seq=seq,
                from_rung=RUNGS[old],
                to_rung=RUNGS[new],
                direction="down" if down else "up",
                reason=reason[:300],
            )
        cb = self._on_transition
        # the hook fires on every rung CHANGE and on every sticky-bottom
        # degrade repeat (old == new, down): continued failure must
        # re-apply the rung's actions (retrace re-clears the program
        # memos), not only re-emit telemetry. Promotions always change
        # the rung, so `down` can't double-fire them.
        if cb is not None and (new != old or down):
            try:
                cb(old, new, reason)
            except Exception:
                # a failing rung-effect hook must not mask the original
                # fault or take the loop down — the rung number already
                # moved, which is what readers and promotion act on
                log.exception(
                    "degradation rung-transition hook failed "
                    "(%d -> %d)", old, new,
                )

    # ---- readers ---------------------------------------------------------

    def status(self) -> dict:
        """The /healthz + /debug/state payload."""
        with self._lock:
            return {
                "rung": self.rung,
                "name": RUNGS[self.rung],
                "floor": self.floor,
                "clean_cycles": self._clean,
                "promote_after": self.promote_after,
                "degradations": self.degradations,
                "last_reason": self.last_reason,
                # exact lifetime count — the ring below may have evicted
                "transitions": self.transitions_total,
                "transitions_buffered": len(self.transitions),
            }

    def transition_log(self, last: "int | None" = None) -> list[dict]:
        """Copy of the transition ring (oldest first), each entry with
        its monotonic `t` and wall timestamp — the /debug/state MTTR
        surface and the black box's ladder tail. `last` trims to the
        most recent entries; the ring itself is bounded (512)."""
        with self._lock:
            out = [dict(e) for e in self.transitions]
        return out if last is None else out[-last:]

    def recovery_episodes_ms(self) -> list[float]:
        """Wall milliseconds of each completed recovery episode (left
        rung 0 -> returned to rung 0) — the MTTR series bench config 7
        and soak_chaos report."""
        out: list[float] = []
        down_t: "float | None" = None
        # snapshot under the lock: iterating the live deque while the
        # scheduling loop appends raises (a list raced benignly here;
        # a deque does not)
        with self._lock:
            transitions = list(self.transitions)
        for e in transitions:
            if e["from"] == RUNG_NORMAL and e["to"] > RUNG_NORMAL:
                if down_t is None:
                    down_t = e["t"]
            elif e["to"] == RUNG_NORMAL and down_t is not None:
                out.append((e["t"] - down_t) * 1e3)
                down_t = None
        return out
