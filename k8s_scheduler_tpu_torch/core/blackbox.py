"""Crash black box: one-file post-mortem bundles (the port's copy of
`k8s_scheduler_tpu/core/blackbox.py`: the same bundle format, triggers and
retention).

A crash takes every in-memory ring down with it — flight recorder,
span ring, anomaly ring, metric history, active alerts — and a
`kill -9` doesn't even run `finally` blocks. So the black box dumps a
bundle at the moment things go WRONG, not at exit: by the time the
process dies (cleanly or not), the last bundle is already durable on
disk.

Triggers (each wired at its site, one module-flag check when unarmed —
the core/faults.py arming pattern):

- `sigterm`       — the CLI's shutdown path (cmd/main.py)
- `stateless`     — the degradation ladder entering RUNG_STATELESS
                    (Scheduler._on_rung_transition)
- `watchdog`      — a dispatch watchdog deadline abort
                    (Scheduler._cycle_failed, class "deadline")
- `serve_loop`    — an unhandled front-door serve-loop exception
                    (service/admission.FrontDoor._run_loop)

A bundle is one JSON file under `<stateDir>/blackbox/`, written
tmp + fsync + rename (the journal/snapshot atomicity discipline) so a
crash mid-dump leaves the previous bundle intact, never a torn one. It
carries: trigger metadata + build fingerprint + config, the TSDB metric
history window, flight records (+ derived stats + a pre-rendered
chrome trace for Perfetto), spans, anomalies, active/resolved alerts,
the ladder transition ring, and the fault-plan log. Retention is
bounded (`blackboxRetention` newest bundles kept, oldest deleted
first); `load_bundle` reads one back. The metric history and the alerts
(`metrics_history`, `alerts`) fill when the box is wired with the armed
store and rules engine (`cmd/watchtower.arm_watchtower`); a box wired
without them dumps what it has.

Dumps are throttled (`MIN_INTERVAL_S` per trigger kind) so a
crash-looping serve loop cannot turn the black box into a disk-filling
loop; `sigterm` is exempt (shutdown dumps exactly once and must win).
All dump paths swallow + log — the black box must never be the thing
that takes the scheduler down.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any

log = logging.getLogger(__name__)

# Module arming (core/faults.py pattern): hot trigger sites gate on one
# module-attribute load + branch; `arm(box)` installs the collector.
ARMED = False
BOX: "BlackBox | None" = None

MIN_INTERVAL_S = 30.0
DEFAULT_RETENTION = 8
MAX_DIR_BYTES = 64 << 20  # same ceiling as spans.export_otlp_dir


class BlackBox:
    """Holds references to the live observability surfaces and dumps
    them as one atomic bundle on demand. Every source is optional —
    a partially wired box dumps what it has."""

    def __init__(self, directory: str, retention: int = DEFAULT_RETENTION,
                 config: dict | None = None,
                 recorder=None, observer=None, spans_recorder=None,
                 tsdb=None, engine=None, ladder=None, fault_plan=None,
                 events=None):
        self.directory = directory
        self.retention = max(1, int(retention))
        self.config = config or {}
        self.recorder = recorder
        self.observer = observer
        self.spans_recorder = spans_recorder
        self.tsdb = tsdb
        self.engine = engine
        self.ladder = ladder
        self.fault_plan = fault_plan
        self.events = events
        self.dumps = 0
        self.last_path: str | None = None
        self._lock = threading.Lock()
        self._last_dump: dict[str, float] = {}

    # ---- bundle assembly --------------------------------------------

    def _collect(self, trigger: str, detail: str) -> dict:
        bundle: dict[str, Any] = {
            "blackbox_version": 1,
            "trigger": trigger,
            "detail": detail,
            "wall": time.time(),
            "pid": os.getpid(),
            "config": self.config,
        }
        try:
            from ..metrics.metrics import build_fingerprint
            bundle["build"] = build_fingerprint()
        except Exception:
            log.exception("blackbox: build fingerprint failed")
        rec = self.recorder
        if rec is not None:
            bundle["flight"] = {
                "records": rec.to_dicts(last=256),
                "derived": rec.derived(last=64),
                "cycles": rec.cycles,
            }
            try:
                from .flight_recorder import to_chrome_trace
                spans = (self.spans_recorder.snapshot(last=512)
                         if self.spans_recorder is not None else None)
                bundle["chrome_trace"] = to_chrome_trace(
                    rec.snapshot(last=256), epoch=rec.epoch, spans=spans)
            except Exception:
                log.exception("blackbox: chrome trace render failed")
        if self.spans_recorder is not None:
            bundle["spans"] = self.spans_recorder.to_dicts(last=512)
        if self.observer is not None:
            bundle["anomalies"] = {
                "events": self.observer.anomalies(last=512),
                "status": self.observer.status(),
            }
        if self.engine is not None:
            bundle["alerts"] = self.engine.status()
        if self.tsdb is not None:
            bundle["metrics_history"] = self.tsdb.snapshot_all()
        if self.ladder is not None:
            bundle["ladder"] = {
                "status": self.ladder.status(),
                "transitions": self.ladder.transition_log(),
            }
        if self.fault_plan is not None:
            bundle["faults"] = {
                "fired": sorted(self.fault_plan.fired_points()),
                "log": list(self.fault_plan.log)[-128:],
            }
        if self.events is not None:
            import dataclasses as _dc
            bundle["events"] = [_dc.asdict(e) for e in
                                self.events.events()[-128:]]
        return bundle

    # ---- atomic write + retention -----------------------------------

    def dump(self, trigger: str, detail: str = "") -> str | None:
        """Writes one bundle; returns its path or None (throttled /
        failed). Never raises."""
        now = time.time()
        with self._lock:
            last = self._last_dump.get(trigger, 0.0)
            if trigger != "sigterm" and now - last < MIN_INTERVAL_S:
                return None
            self._last_dump[trigger] = now
            try:
                return self._dump_locked(trigger, detail)
            except Exception:
                log.exception("blackbox: dump failed (trigger=%s)", trigger)
                return None

    def _dump_locked(self, trigger: str, detail: str) -> str:
        bundle = self._collect(trigger, detail)
        os.makedirs(self.directory, exist_ok=True)
        existing = self._bundles()
        nxt = 0
        if existing:
            try:
                nxt = int(existing[-1].split("-")[1]) + 1
            except (IndexError, ValueError):
                nxt = len(existing)
        name = f"blackbox-{nxt:06d}-{trigger}.json"
        path = os.path.join(self.directory, name)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(bundle, f, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self.dumps += 1
        self.last_path = path
        log.warning("blackbox: dumped %s (trigger=%s%s)", path, trigger,
                    f": {detail}" if detail else "")
        self._rotate()
        return path

    def _bundles(self) -> list[str]:
        try:
            return sorted(
                f for f in os.listdir(self.directory)
                if f.startswith("blackbox-") and f.endswith(".json"))
        except OSError:
            return []

    def _rotate(self) -> None:
        files = self._bundles()
        # count retention first, then the byte ceiling; never delete
        # the bundle just written
        for f in files[:-self.retention]:
            self._unlink(f)
        files = self._bundles()
        total = 0
        sizes = {}
        for f in files:
            try:
                sizes[f] = os.path.getsize(os.path.join(self.directory, f))
            except OSError:
                sizes[f] = 0
            total += sizes[f]
        for f in files[:-1]:
            if total <= MAX_DIR_BYTES:
                break
            self._unlink(f)
            total -= sizes[f]

    def _unlink(self, name: str) -> None:
        try:
            os.unlink(os.path.join(self.directory, name))
        except OSError:
            log.warning("blackbox: rotate failed to remove %s", name)

    def status(self) -> dict:
        return {"directory": self.directory, "retention": self.retention,
                "dumps": self.dumps, "last_path": self.last_path,
                "bundles": self._bundles()}


def arm(box: BlackBox) -> BlackBox:
    global ARMED, BOX
    BOX = box
    ARMED = True
    return box


def disarm() -> None:
    global ARMED, BOX
    ARMED = False
    BOX = None


def trigger(kind: str, detail: str = "") -> "str | None":
    """The hot-site entry point: one module-flag check when unarmed."""
    if not ARMED:
        return None
    box = BOX
    if box is None:
        return None
    return box.dump(kind, detail)


def load_bundle(path: str) -> dict:
    """Reads one bundle back (scripts/blackbox_read.py round-trip)."""
    with open(path, encoding="utf-8") as f:
        return json.load(f)
