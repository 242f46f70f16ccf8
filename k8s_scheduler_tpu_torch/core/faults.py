"""Deterministic fault injection: named points on the real code paths (the
port's copy of `k8s_scheduler_tpu/core/faults.py`: the same plan grammar,
rules, seeded draws and fire log).

Every recovery rung of the serving host — `_Resilient` retries, the
dispatch watchdog, journal-death stateless degrade, warm-standby failover —
is verified against faults a `FaultPlan` fires on demand: a seeded plan
fires scripted faults at named injection points threaded through the real
serving and durability code, so tests and the smoke run can prove each
ladder rung works.

Injection points (`POINTS`; each hook sits on the exact code path the
real fault class strikes):

- `fetch_delay`    — sleep `ms` BEFORE the blocking decision fetch (a
  slow transfer: latency visible to the caller, watchdog not involved;
  `ServingPipeline.fetch_decisions`);
- `fetch_hang`     — sleep `ms` INSIDE the watchdog-bounded fetch call
  (a wedged transfer: what `dispatchDeadlineMs` exists to bound);
- `device_error`   — raise from inside `_Resilient.__call__` with a
  message carrying the port's marker signatures (`kind=` transport |
  corrupt | wedge — `core/cycle.py` `_TRANSPORT_MARKERS` /
  `_CORRUPT_MARKERS` / `_WEDGE_MARKERS`), driving the real retry /
  fail-fast classification;
- `journal_enospc` — the journal writer's batch write raises ENOSPC
  (state/journal.py), driving the documented degrade-to-stateless path;
- `cache_torn`     — the compile-cache store lands a TRUNCATED entry;
- `cache_enospc`   — the compile-cache store raises ENOSPC;
- `clock_skew`     — the scheduler's cycle-clock read jumps by `ms`
  (derived stats must tolerate a stepping clock).

`cache_torn` and `cache_enospc` parse exactly as in the reference and fire
at the persistent kernel cache's store (`core/compile_cache.py`), which
`compileCacheDir` / `stateDir` open.

Plan syntax (config `faultSpec`, env `SCHED_FAULTS`):

    fetch_hang@cycle=40:ms=5000
    seed=7;fetch_delay@cycle=3..9:ms=50:p=0.5;device_error@cycle=12:kind=wedge:n=1

Rules separated by `;` (or `,`); each is `point[@param:param:...]` with
params `cycle=<i>[..<j>]` (inclusive window; omitted = any cycle),
`ms=<float>`, `kind=<name>`, `p=<prob>`, `n=<max fires>`. A standalone
`seed=<int>` seeds the probability draws, making the whole plan
deterministic. The ambient cycle index is stamped by the scheduler
(`set_cycle`) at the top of every `schedule_cycle`; hooks on other
threads (journal writer, warm thread) see the loop's latest stamp.

Zero overhead unarmed: every hook is gated on the module flag `ARMED`
(one global load + branch); no plan object, rng, or lock is touched.
"""

from __future__ import annotations

import dataclasses
import errno
import logging
import random
import threading
import time as _time

log = logging.getLogger("k8s_scheduler_tpu_torch.faults")

POINTS = (
    "fetch_delay",
    "fetch_hang",
    "device_error",
    "journal_enospc",
    "cache_torn",
    "cache_enospc",
    "clock_skew",
)

# Hot-path gate: hooks read this ONE module global and branch away when
# no plan is armed. Mutated only by arm()/disarm().
ARMED = False

_PLAN: "FaultPlan | None" = None
_CYCLE = -1  # ambient cycle index (set_cycle; -1 before the first cycle)


@dataclasses.dataclass
class FaultRule:
    point: str
    lo: "int | None" = None  # inclusive cycle window; None = any cycle
    hi: "int | None" = None
    ms: float = 0.0
    kind: str = "transport"  # device_error class
    prob: float = 1.0
    count: "int | None" = None  # max fires (None = unlimited)
    fired: int = 0

    def eligible(self, cycle: int) -> bool:
        if self.count is not None and self.fired >= self.count:
            return False
        if self.lo is not None and (cycle < self.lo or cycle > self.hi):
            return False
        return True


class FaultPlanError(ValueError):
    """Malformed fault spec — refused loudly at arm time, never at the
    moment the fault would have fired."""


class FaultPlan:
    """A parsed, seeded set of FaultRules plus the fire log (every fire
    is recorded so tests and the smoke run can assert the plan actually
    ran)."""

    def __init__(self, rules: "list[FaultRule]", seed: int = 0) -> None:
        self.rules = list(rules)
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.log: list[dict] = []

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        rules: list[FaultRule] = []
        seed = 0
        for raw in spec.replace(",", ";").split(";"):
            tok = raw.strip()
            if not tok:
                continue
            if tok.startswith("seed="):
                seed = int(tok[len("seed="):])
                continue
            point, _, params = tok.partition("@")
            point = point.strip()
            if point not in POINTS:
                raise FaultPlanError(
                    f"unknown fault point {point!r} (known: {POINTS})"
                )
            rule = FaultRule(point=point)
            for p in params.split(":"):
                p = p.strip()
                if not p:
                    continue
                k, _, v = p.partition("=")
                if not v:
                    raise FaultPlanError(
                        f"fault param {p!r} in {tok!r} needs key=value"
                    )
                if k == "cycle":
                    lo, _, hi = v.partition("..")
                    rule.lo = int(lo)
                    rule.hi = int(hi) if hi else rule.lo
                elif k == "ms":
                    rule.ms = float(v)
                elif k == "kind":
                    if v not in ("transport", "corrupt", "wedge"):
                        raise FaultPlanError(
                            f"unknown device_error kind {v!r} in {tok!r}"
                        )
                    rule.kind = v
                elif k == "p":
                    rule.prob = float(v)
                elif k == "n":
                    rule.count = int(v)
                else:
                    raise FaultPlanError(
                        f"unknown fault param {k!r} in {tok!r}"
                    )
            rules.append(rule)
        if not rules:
            raise FaultPlanError(f"fault spec {spec!r} contains no rules")
        return cls(rules, seed=seed)

    def fire(self, point: str, cycle: int) -> "FaultRule | None":
        """The first eligible rule for `point` at `cycle` (recorded in
        the fire log), or None. Probability draws come from the plan's
        seeded rng, so a plan replays identically given the same
        sequence of hook invocations."""
        with self._lock:
            for rule in self.rules:
                if rule.point != point or not rule.eligible(cycle):
                    continue
                if rule.prob < 1.0 and self._rng.random() >= rule.prob:
                    continue
                rule.fired += 1
                entry = {
                    "point": point,
                    "cycle": cycle,
                    "kind": rule.kind,
                    "ms": rule.ms,
                    "wall": _time.time(),
                }
                self.log.append(entry)
                log.warning(
                    "fault injected: %s at cycle %d (%s)", point, cycle,
                    ", ".join(f"{k}={v}" for k, v in
                              (("kind", rule.kind), ("ms", rule.ms))
                              if v),
                )
                return rule
        return None

    def fired_points(self) -> "set[str]":
        with self._lock:
            return {e["point"] for e in self.log}


def arm(plan: "FaultPlan | None") -> None:
    global ARMED, _PLAN
    _PLAN = plan
    ARMED = plan is not None


def disarm() -> None:
    arm(None)


def plan() -> "FaultPlan | None":
    return _PLAN


def set_cycle(cycle: int) -> None:
    """Stamp the ambient cycle index (scheduler loop, once per cycle)."""
    global _CYCLE
    _CYCLE = cycle


def fire(point: str) -> "FaultRule | None":
    p = _PLAN
    return p.fire(point, _CYCLE) if p is not None else None


def sleep_point(point: str) -> "FaultRule | None":
    """Fire `point`; sleep its `ms` when it fired (fetch_delay/hang)."""
    r = fire(point)
    if r is not None and r.ms > 0:
        _time.sleep(r.ms / 1e3)
    return r


def raise_device_error() -> None:
    """Fire `device_error`; raise with the matching marker signature so
    the REAL classifier (`_Resilient`, `classify_failure`) routes it."""
    r = fire("device_error")
    if r is None:
        return
    from .cycle import _CORRUPT_MARKERS, _WEDGE_MARKERS

    if r.kind == "corrupt":
        raise RuntimeError(
            f"[fault-injected] CUDA error: {_CORRUPT_MARKERS[0]} for "
            "execution on the device"
        )
    if r.kind == "wedge":
        raise RuntimeError(
            f"[fault-injected] CUDA error: an {_WEDGE_MARKERS[0]} was "
            "encountered"
        )
    raise RuntimeError(
        "[fault-injected] remote_execute: response body closed"
    )


def raise_enospc(point: str) -> None:
    """Fire `point`; raise ENOSPC when it fired (journal/cache stores)."""
    if fire(point) is not None:
        raise OSError(
            errno.ENOSPC, "No space left on device [fault-injected]"
        )


def torn_store() -> bool:
    """True when the compile-cache store should land a torn entry."""
    return fire("cache_torn") is not None


def skew_s() -> float:
    """Injected clock-skew offset in seconds (0.0 when nothing fired)."""
    r = fire("clock_skew")
    return (r.ms / 1e3) if r is not None else 0.0
