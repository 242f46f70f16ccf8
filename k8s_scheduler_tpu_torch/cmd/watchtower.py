"""Arming the watchtower — the metrics history (`metrics/tsdb.py`) and the
alert rules (`metrics/rules.py`) — over a running `Scheduler`, as the
reference CLI does at startup (`k8s_scheduler_tpu/cmd/main.py:498-535`).
The port's CLI calls `arm_watchtower`; tests and the smoke run call it
directly. Library and test constructions that do not arm it pay one
module-flag check at the flight recorder's observer hook."""

from __future__ import annotations

import logging

from ..metrics import tsdb as _tsdb
from ..metrics.rules import RuleEngine, builtin_rules, load_rules_file

log = logging.getLogger(__name__)


def arm_watchtower(config, scheduler, metrics=None, rules=None):
    """Arm the metrics history with `config.metrics_history_samples` raw
    samples a series, attach the rules engine (the built-in pack plus
    `config.alert_rules_file`, or `rules` where given, e.g. `scale_rules`
    of the pack) with the scheduler's observer and events, hook the store
    into the scheduler's flight recorder and start the registry ticker
    every `config.metrics_ticker_seconds`. Returns (store, engine), or
    (None, None) when `metrics_history_samples` is 0."""
    if config.metrics_history_samples <= 0:
        return None, None
    m = metrics or scheduler.metrics
    store = _tsdb.arm(raw_cap=config.metrics_history_samples)
    if rules is None:
        rules = builtin_rules()
        if config.alert_rules_file:
            rules += load_rules_file(config.alert_rules_file)
    engine = RuleEngine(rules, store, observer=scheduler.observer,
                        events=scheduler.events, metrics=m)
    store.engine = engine
    if scheduler.flight is not None:
        scheduler.flight.observers.append(store.observe_record)
    store.start_ticker(m.registry, interval_s=config.metrics_ticker_seconds)
    log.info("watchtower armed: %d rules, history %d raw samples/series, ticker %gs",
             len(rules), config.metrics_history_samples, config.metrics_ticker_seconds)
    return store, engine


def disarm_watchtower(scheduler, store) -> None:
    """Stop the ticker, disarm the store (it stays readable) and detach it
    from the scheduler's flight recorder."""
    if store is None:
        return
    if scheduler.flight is not None and store.observe_record in scheduler.flight.observers:
        scheduler.flight.observers.remove(store.observe_record)
    _tsdb.disarm()
