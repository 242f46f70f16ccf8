"""Declarative recording + alert rules over the in-process TSDB (the
port's copy of `k8s_scheduler_tpu/metrics/rules.py`: the same rule pack,
state machine and replay).

A `Rule` is a structured object — family + label selector, windowed
aggregation, comparator, threshold, `for`-duration, severity,
clear-hysteresis — and the `RuleEngine` evaluates the pack against
`metrics/tsdb.py` history each cycle (throttled) and from the wall
ticker, so alerts keep evaluating even when the scheduling loop is
wedged. A firing rule:

- lands in the events ring (`AlertFiring` / `AlertResolved`
  scheduler-level events, core/events.py),
- raises an `alert` anomaly (core/observe.py ANOMALY_CLASSES) carrying
  rule name, severity, observed value and threshold,
- increments `scheduler_alerts_total{rule,severity}`,
- shows in `/debug/alerts` as active until it resolves, then in the
  resolved tail with both wall timestamps.

State machine per rule: ok -> pending (condition true) -> firing
(condition held for `for_s`) -> resolved (condition false AGAINST THE
CLEAR THRESHOLD for `for_s` — hysteresis on both the value axis via
`clear` and the time axis via the symmetric hold, so a value oscillating
around the threshold cannot flap the alert).

`BUILTIN_RULES` is the committed rule pack, the reference's, a
module-level literal. Operators extend the pack with `alertRulesFile`
(YAML/JSON list of the same shape).

Rules with `"kind": "record"` are recording rules: the aggregated value
is appended back into the TSDB under `record_as` each evaluation,
giving derived series (e.g. a smoothed anomaly rate) their own history
and making them selectable by other rules and the dashboard.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import time
from typing import Iterable

log = logging.getLogger(__name__)

# Event-ring reasons for rule transitions; mirrored as constants in
# core/events.py (kept as literals here so metrics/ stays importable
# without the core package).
ALERT_FIRING = "AlertFiring"
ALERT_RESOLVED = "AlertResolved"

SEVERITIES = ("critical", "warning", "info")
AGGS = ("avg", "min", "max", "sum", "last", "rate", "count")
OPS = (">", ">=", "<", "<=")

# The committed built-in rule pack. Thresholds are production-shaped
# (windows in wall seconds); tests scale them down via `scale_rules`.
BUILTIN_RULES = (
    # SLO fast-window burn: spending error budget > 6x sustainable.
    {"name": "slo_fast_burn", "family": "scheduler_slo_burn_rate",
     "labels": {"window": "fast"}, "agg": "avg", "window_s": 30.0,
     "op": ">", "threshold": 6.0, "for_s": 15.0, "clear": 2.0,
     "severity": "critical"},
    # Degradation ladder sitting below normal (rung > 0).
    {"name": "degraded_rung", "family": "scheduler_degradation_rung",
     "labels": {}, "agg": "last", "window_s": 60.0,
     "op": ">", "threshold": 0.5, "for_s": 10.0,
     "severity": "warning"},
    # A tenant repeatedly losing every arena auction it entered.
    {"name": "tenant_starved_streak",
     "family": "scheduler_anomalies_total",
     "labels": {"class": "tenant_starved"}, "agg": "rate",
     "window_s": 60.0, "op": ">", "threshold": 0.03, "for_s": 30.0,
     "severity": "warning"},
    # Aggregate anomaly rate across every class.
    {"name": "anomaly_rate", "family": "scheduler_anomalies_total",
     "labels": {}, "agg": "rate", "window_s": 60.0,
     "op": ">", "threshold": 1.0, "for_s": 15.0, "clear": 0.5,
     "severity": "warning"},
    # Tunnel round-trip stall burst (the FaultPlan fetch-stall shape).
    {"name": "tunnel_stall_burst", "family": "scheduler_anomalies_total",
     "labels": {"class": "tunnel_stall"}, "agg": "rate",
     "window_s": 30.0, "op": ">", "threshold": 0.2, "for_s": 10.0,
     "clear": 0.05, "severity": "critical"},
    # Journal records appended but not yet durable (fsync lag).
    {"name": "journal_buffer_depth",
     "family": "scheduler_journal_buffer_depth", "labels": {},
     "agg": "max", "window_s": 15.0, "op": ">", "threshold": 1024.0,
     "for_s": 10.0, "clear": 256.0, "severity": "warning"},
    # Executable-cache misses on the serve path (cold compiles).
    {"name": "compile_cache_miss_spike",
     "family": "scheduler_compile_cache_misses_total", "labels": {},
     "agg": "rate", "window_s": 60.0, "op": ">", "threshold": 0.5,
     "for_s": 20.0, "severity": "warning"},
    # Consumed cycles whose blocking decision fetch raised.
    {"name": "fetch_failure_rate",
     "family": "scheduler_fetch_failures_total", "labels": {},
     "agg": "rate", "window_s": 60.0, "op": ">", "threshold": 0.2,
     "for_s": 20.0, "clear": 0.05, "severity": "critical"},
    # Front door shedding submissions (explicit backpressure).
    {"name": "admission_shed_rate", "family": "scheduler_admission_total",
     "labels": {"outcome": "shed"}, "agg": "rate", "window_s": 60.0,
     "op": ">", "threshold": 0.1, "for_s": 15.0,
     "severity": "warning"},
    # Recording rule: smoothed anomaly rate as its own series.
    {"name": "anomaly_rate_1m", "kind": "record",
     "family": "scheduler_anomalies_total", "labels": {},
     "agg": "rate", "window_s": 60.0,
     "record_as": "anomaly_rate_1m"},
)


@dataclasses.dataclass(frozen=True)
class Rule:
    """One declarative rule; `kind` is "alert" or "record"."""

    name: str
    family: str
    agg: str
    window_s: float
    labels: tuple = ()
    kind: str = "alert"
    op: str = ">"
    threshold: float = 0.0
    for_s: float = 0.0
    severity: str = "warning"
    clear: float | None = None  # hysteresis clear threshold
    record_as: str = ""

    @classmethod
    def from_dict(cls, d: dict) -> "Rule":
        d = dict(d)
        labels = tuple(sorted(
            (str(k), str(v)) for k, v in (d.pop("labels", {}) or {}).items()))
        rule = cls(labels=labels, **d)
        if not rule.name or not rule.family:
            raise ValueError(f"rule needs name and family: {d}")
        if rule.agg not in AGGS:
            raise ValueError(f"rule {rule.name}: bad agg {rule.agg!r}")
        if rule.kind == "alert":
            if rule.op not in OPS:
                raise ValueError(f"rule {rule.name}: bad op {rule.op!r}")
            if rule.severity not in SEVERITIES:
                raise ValueError(
                    f"rule {rule.name}: bad severity {rule.severity!r}")
        elif rule.kind == "record":
            if not rule.record_as:
                raise ValueError(f"rule {rule.name}: record needs record_as")
        else:
            raise ValueError(f"rule {rule.name}: bad kind {rule.kind!r}")
        return rule

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["labels"] = dict(self.labels)
        return d


def builtin_rules() -> list[Rule]:
    return [Rule.from_dict(d) for d in BUILTIN_RULES]


def scale_rules(rules: Iterable[Rule], time_scale: float) -> list[Rule]:
    """Scales window/for durations (tests and bench replay shrink the
    production windows instead of sleeping through them)."""
    return [dataclasses.replace(r, window_s=r.window_s * time_scale,
                                for_s=r.for_s * time_scale)
            for r in rules]


def load_rules_file(path: str) -> list[Rule]:
    """Loads operator rules (YAML or JSON list of rule dicts)."""
    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text)
    except ValueError:
        import yaml  # same lazy-dep posture as config loading
        data = yaml.safe_load(text)
    if not isinstance(data, list):
        raise ValueError(f"{path}: expected a list of rule objects")
    return [Rule.from_dict(d) for d in data]


def _cmp(value: float, op: str, threshold: float) -> bool:
    if op == ">":
        return value > threshold
    if op == ">=":
        return value >= threshold
    if op == "<":
        return value < threshold
    return value <= threshold


class _State:
    __slots__ = ("stage", "since", "clear_since", "value", "record")

    def __init__(self):
        self.stage = "ok"  # ok | pending | firing
        self.since = 0.0
        self.clear_since = 0.0
        self.value: float | None = None
        self.record: dict | None = None


class RuleEngine:
    """Evaluates a rule pack against the TSDB; see module docstring.

    Driven by `MetricsTSDB.maybe_evaluate` (cycle observer + wall
    ticker, throttled + serialized there), so `evaluate` itself needs no
    internal locking beyond what the TSDB snapshot discipline gives."""

    def __init__(self, rules: Iterable[Rule], tsdb,
                 observer=None, events=None, metrics=None,
                 history: int = 256):
        self.rules = list(rules)
        self.tsdb = tsdb
        self.observer = observer
        self.events = events
        self.metrics = metrics
        self._states = {r.name: _State() for r in self.rules}
        self.history: collections.deque = collections.deque(maxlen=history)
        self.fired_total = 0
        self.evaluations = 0

    # ---- value extraction -------------------------------------------

    def _series_value(self, rule: Rule, points: list) -> tuple | None:
        """(value, weight) aggregate of one series' window, or None."""
        if not points:
            return None
        # raw rows are [t, v]; bucket rows are [t, min, max, sum, count,
        # last] — normalize to per-point stats
        if len(points[0]) == 2:
            vals = [p[1] for p in points]
            mn, mx, sm, cnt, last = (min(vals), max(vals), sum(vals),
                                     len(vals), vals[-1])
            first_t, first_v = points[0][0], points[0][1]
            last_t, last_v = points[-1][0], points[-1][1]
        else:
            mn = min(p[1] for p in points)
            mx = max(p[2] for p in points)
            sm = sum(p[3] for p in points)
            cnt = sum(p[4] for p in points)
            last = points[-1][5]
            first_t, first_v = points[0][0], points[0][5]
            last_t, last_v = points[-1][0], points[-1][5]
        if rule.agg == "rate":
            if last_t <= first_t:
                return None
            # counter rate; clamp at 0 so a counter reset reads as
            # quiet, not as a huge negative rate
            return (max(0.0, (last_v - first_v) / (last_t - first_t)), cnt)
        if rule.agg == "avg":
            return (sm / cnt, cnt) if cnt else None
        if rule.agg == "min":
            return (mn, cnt)
        if rule.agg == "max":
            return (mx, cnt)
        if rule.agg == "sum":
            return (sm, cnt)
        if rule.agg == "count":
            return (float(cnt), cnt)
        return (last, cnt)  # "last"

    def _value(self, rule: Rule, now: float) -> float | None:
        step = 0.0 if rule.window_s <= 600 else 1.0
        q = self.tsdb.query(rule.family, labels=dict(rule.labels),
                            window_s=rule.window_s, step_s=step, now=now)
        per = [self._series_value(rule, s["points"]) for s in q["series"]]
        per = [p for p in per if p is not None]
        if not per:
            return None
        if rule.agg in ("rate", "sum", "count"):
            return sum(v for v, _ in per)
        if rule.agg == "min":
            return min(v for v, _ in per)
        if rule.agg in ("max", "last"):
            return max(v for v, _ in per)
        total = sum(w for _, w in per)  # "avg": weight by sample count
        return (sum(v * w for v, w in per) / total) if total else None

    # ---- state machine ----------------------------------------------

    def evaluate(self, now: float | None = None) -> None:
        now = time.time() if now is None else now
        # serialized by MetricsTSDB.maybe_evaluate's _eval_lock (the
        # only concurrent callers — cycle observer + wall ticker — both
        # enter through it); direct calls are single-threaded test rigs
        self.evaluations += 1  # schedlint: disable=TR001 -- maybe_evaluate serializes every concurrent caller
        for rule in self.rules:
            st = self._states[rule.name]
            v = self._value(rule, now)
            st.value = v
            if rule.kind == "record":
                if v is not None:
                    self.tsdb.append(rule.record_as, (), v, t=now)
                continue
            cond = v is not None and _cmp(v, rule.op, rule.threshold)
            if st.stage == "ok":
                if cond:
                    st.stage, st.since = "pending", now
            elif st.stage == "pending" and not cond:
                st.stage = "ok"
            if st.stage == "pending" and now - st.since >= rule.for_s:
                self._fire(rule, st, now)
                continue
            if st.stage == "firing":
                clear_thr = (rule.threshold if rule.clear is None
                             else rule.clear)
                cleared = v is None or not _cmp(v, rule.op, clear_thr)
                if not cleared:
                    st.clear_since = 0.0
                elif st.clear_since == 0.0:
                    st.clear_since = now
                elif now - st.clear_since >= rule.for_s:
                    self._resolve(rule, st, now)

    def _fire(self, rule: Rule, st: _State, now: float) -> None:
        st.stage, st.since, st.clear_since = "firing", now, 0.0
        self.fired_total += 1  # schedlint: disable=TR001 -- only called from evaluate; maybe_evaluate serializes
        value = st.value if st.value is not None else 0.0
        st.record = {
            "rule": rule.name, "severity": rule.severity,
            "family": rule.family, "labels": dict(rule.labels),
            "value": value, "threshold": rule.threshold,
            "op": rule.op, "for_s": rule.for_s,
            "fired_wall": now, "resolved_wall": None,
        }
        self.history.append(st.record)
        msg = (f"alert {rule.name} firing [{rule.severity}]: "
               f"{rule.family} {rule.agg}/{rule.window_s:g}s = {value:.4g} "
               f"{rule.op} {rule.threshold:g} held {rule.for_s:g}s")
        log.warning("%s", msg)
        if self.events is not None:
            self.events.system(ALERT_FIRING, msg)
        if self.observer is not None:
            self.observer.raise_anomaly(
                "alert", value_s=float(value), rule=rule.name,
                severity=rule.severity, threshold=rule.threshold,
                family=rule.family)
        if self.metrics is not None:
            self.metrics.alerts.labels(
                rule=rule.name, severity=rule.severity).inc()

    def _resolve(self, rule: Rule, st: _State, now: float) -> None:
        st.stage, st.clear_since = "ok", 0.0
        if st.record is not None:
            st.record["resolved_wall"] = now
        msg = (f"alert {rule.name} resolved after "
               f"{now - (st.record or {}).get('fired_wall', now):.1f}s")
        log.info("%s", msg)
        if self.events is not None:
            self.events.system(ALERT_RESOLVED, msg)
        st.record = None

    # ---- read side ---------------------------------------------------

    def status(self) -> dict:
        """Payload for `/debug/alerts` and the black box."""
        active, rules = [], []
        for rule in self.rules:
            st = self._states[rule.name]
            rules.append({
                **rule.to_dict(), "state": st.stage, "value": st.value,
                "since": st.since or None,
            })
            if st.stage == "firing" and st.record is not None:
                active.append(dict(st.record))
        resolved = [dict(r) for r in self.history
                    if r.get("resolved_wall") is not None]
        return {
            "active": active,
            "resolved": resolved,
            "rules": rules,
            "fired_total": self.fired_total,
            "evaluations": self.evaluations,
        }


def replay_alerts(samples_s: Iterable[float],
                  rules: Iterable[Rule] | None = None) -> dict:
    """Replays a bench per-cycle latency series through the production
    classifier AND the built-in rule pack (mirror of
    core/observe.classify_latency_series): each cycle advances a
    virtual wall clock by one second — so a 60 s rule window reads as a
    60-cycle window — feeds the observer's cumulative anomaly counters
    into a throwaway TSDB, and evaluates the pack. Returns
    {"alerts_fired": n, "fired_rules": [...]} for the bench headline."""
    from ..core.observe import CycleObserver  # lazy: avoids cycles
    from .tsdb import MetricsTSDB

    tsdb = MetricsTSDB(raw_cap=256)
    engine = RuleEngine(rules if rules is not None else builtin_rules(),
                        tsdb)
    obs = CycleObserver(metrics=None)
    fired_rules: set[str] = set()
    for i, t in enumerate(samples_s):
        obs.observe_phases(
            {"total": t, "device": t, "decision_fetch": t},
            profile="bench", seq=i,
        )
        now = float(i + 1)
        for cls, n in obs.anomaly_counts.items():
            tsdb.append("scheduler_anomalies_total",
                        (("class", cls),), float(n), t=now)
        engine.evaluate(now)
        for rule in engine.rules:
            if engine._states[rule.name].stage == "firing":
                fired_rules.add(rule.name)
    return {"alerts_fired": engine.fired_total,
            "fired_rules": sorted(fired_rules)}
