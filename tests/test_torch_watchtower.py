"""The port's watchtower — the metrics history (`metrics/tsdb.py`), the alert
rules (`metrics/rules.py`), their HTTP endpoints, the black box's two
sections and `cmd/watchtower.arm_watchtower` — against the reference's.

- The same sample stream gives the same queries in every tier (raw, 1 s
  and 1 m downsampling), inventories and bounded dumps in both packages.
- The same stream through both rule engines gives the same rule states,
  firings and resolutions, step by step; `replay_alerts` gives the same
  headline; rule validation and rule files agree.
- `/debug/metrics/history`, `/debug/alerts` and `/debug/dashboard` answer
  as the reference's do (the dashboard page byte for byte), the dashboard
  404s when off; a black-box bundle carries `alerts` and
  `metrics_history`, equal to the reference's for the same store.
- The registry's `collect()` gives prometheus_client's samples for the
  same metric operations; the config fields load with the reference's
  defaults; `arm_watchtower` samples a serving Scheduler's cycles.
Every comparison is exact."""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request

import pytest

import k8s_scheduler_tpu.cmd.httpserver as ref_http
import k8s_scheduler_tpu.config as ref_config
import k8s_scheduler_tpu.core.blackbox as ref_blackbox
import k8s_scheduler_tpu.metrics as ref_metrics
import k8s_scheduler_tpu.metrics.rules as ref_rules
import k8s_scheduler_tpu.metrics.tsdb as ref_tsdb
import k8s_scheduler_tpu_torch.cmd.httpserver as http
import k8s_scheduler_tpu_torch.config as port_config
import k8s_scheduler_tpu_torch.core.blackbox as blackbox
import k8s_scheduler_tpu_torch.metrics as port_metrics
import k8s_scheduler_tpu_torch.metrics.rules as rules
import k8s_scheduler_tpu_torch.metrics.tsdb as tsdb
import k8s_scheduler_tpu_torch.models as port_models
import k8s_scheduler_tpu_torch.utils.synth as port_synth
from k8s_scheduler_tpu_torch.cmd.watchtower import arm_watchtower, disarm_watchtower
from k8s_scheduler_tpu_torch.core import Scheduler
from test_torch_encoding import fixture
from torch_one_thread import one_torch_thread  # noqa: F401

T0 = 1_700_000_000.0


@pytest.fixture(autouse=True)
def _disarm():
    yield
    tsdb.disarm()
    ref_tsdb.disarm()
    blackbox.disarm()


def _stream():
    """A deterministic sample stream over 3 minutes: a fast-burning SLO
    gauge, a stall-counter burst, a cycle-phase series, a labelled family
    with two label sets."""
    out = []
    stalls = 0
    for i in range(180):
        t = T0 + i * 1.0 + (i % 3) * 0.25
        out.append(("scheduler_slo_burn_rate", {"window": "fast"},
                    8.0 if 40 <= i < 90 else 0.5, t))
        if 60 <= i < 100 and i % 2 == 0:
            stalls += 1
        out.append(("scheduler_anomalies_total", {"class": "tunnel_stall"}, float(stalls), t))
        out.append(("cycle_phase_ms", (("phase", "total"),), 10.0 + (i % 7) * 1.5, t))
        out.append(("scheduler_admission_total", {"outcome": "shed" if i % 2 else "accepted"},
                    float(i // 2), t))
    return out


def _stores(raw_cap=64):
    a, b = ref_tsdb.MetricsTSDB(raw_cap=raw_cap), tsdb.MetricsTSDB(raw_cap=raw_cap)
    for fam, labels, v, t in _stream():
        a.append(fam, labels, v, t=t)
        b.append(fam, labels, v, t=t)
    return a, b


QUERIES = [
    ("scheduler_slo_burn_rate", {"window": "fast"}, 300.0, 0.0),
    ("scheduler_slo_burn_rate", None, 100.0, 1.0),
    ("scheduler_anomalies_total", {}, 1000.0, 60.0),
    ("cycle_phase_ms", {"phase": "total"}, 30.0, 0.0),
    ("scheduler_admission_total", {"outcome": "shed"}, 90.0, 1.0),
    ("scheduler_admission_total", None, 400.0, 60.0),
    ("missing_family", None, 300.0, 0.0),
]


@pytest.mark.parametrize("q", range(len(QUERIES)))
def test_queries_and_downsampling_match_reference(q):
    a, b = _stores()
    fam, labels, window, step = QUERIES[q]
    now = T0 + 180.0
    assert b.query(fam, labels=labels, window_s=window, step_s=step, now=now) == a.query(
        fam, labels=labels, window_s=window, step_s=step, now=now)


def test_inventory_status_and_dump_match_reference():
    a, b = _stores(raw_cap=16)
    assert b.families() == a.families()
    assert b.status() == a.status()
    assert b.snapshot_all() == a.snapshot_all()
    assert b.snapshot_all(raw_last=4, sec_last=3, min_last=2) == a.snapshot_all(
        raw_last=4, sec_last=3, min_last=2)


def test_series_ceiling_matches_reference():
    a, b = ref_tsdb.MetricsTSDB(max_series=5), tsdb.MetricsTSDB(max_series=5)
    for i in range(9):
        a.append("f", {"i": str(i)}, 1.0, t=T0)
        b.append("f", {"i": str(i)}, 1.0, t=T0)
    assert (b.dropped_series, b.status()) == (a.dropped_series, a.status())


def _engines(scale):
    a, b = ref_tsdb.MetricsTSDB(), tsdb.MetricsTSDB()
    ra = ref_rules.scale_rules(ref_rules.builtin_rules(), scale)
    rb = rules.scale_rules(rules.builtin_rules(), scale)
    ma, mb = ref_metrics.SchedulerMetrics(), port_metrics.SchedulerMetrics()
    ea = ref_rules.RuleEngine(ra, a, metrics=ma)
    eb = rules.RuleEngine(rb, b, metrics=mb)
    return (a, ea, ma), (b, eb, mb)


@pytest.mark.parametrize("scale", [1.0, 0.25])
def test_rule_states_match_reference_step_by_step(scale):
    (a, ea, ma), (b, eb, mb) = _engines(scale)
    by_t: dict[float, list] = {}
    for fam, labels, v, t in _stream():
        by_t.setdefault(t, []).append((fam, labels, v))
    for t in sorted(by_t):
        for fam, labels, v in by_t[t]:
            a.append(fam, labels, v, t=t)
            b.append(fam, labels, v, t=t)
        ea.evaluate(t)
        eb.evaluate(t)
        assert eb.status() == ea.status(), t
    assert eb.fired_total == ea.fired_total and ea.fired_total > 0
    # the recording rule's derived series
    now = T0 + 200.0
    assert b.query("anomaly_rate_1m", now=now, window_s=1e6) == a.query(
        "anomaly_rate_1m", now=now, window_s=1e6)

    def alert_samples(m):
        return sorted((s.labels["rule"], s.labels["severity"], s.value)
                      for f in m.registry.collect() for s in f.samples
                      if s.name in ("scheduler_alerts_total", "scheduler_alerts_total_total"))

    assert alert_samples(mb) == alert_samples(ma)


SERIES = [[0.5] * 40, [0.5] * 10 + [28.0] * 25 + [0.5] * 5, [28.0] * 60,
          [0.5, 28.0] * 30]


@pytest.mark.parametrize("i", range(len(SERIES)))
def test_replay_alerts_headline_matches_reference(i):
    assert rules.replay_alerts(SERIES[i]) == ref_rules.replay_alerts(SERIES[i])


BAD_RULES = [
    {"name": "", "family": "f", "agg": "avg", "window_s": 1.0},
    {"name": "x", "family": "f", "agg": "median", "window_s": 1.0},
    {"name": "x", "family": "f", "agg": "avg", "window_s": 1.0, "op": "=="},
    {"name": "x", "family": "f", "agg": "avg", "window_s": 1.0, "severity": "page"},
    {"name": "x", "family": "f", "agg": "avg", "window_s": 1.0, "kind": "record"},
    {"name": "x", "family": "f", "agg": "avg", "window_s": 1.0, "kind": "other"},
]


@pytest.mark.parametrize("i", range(len(BAD_RULES)))
def test_rule_validation_matches_reference(i):
    with pytest.raises(ValueError) as ea:
        ref_rules.Rule.from_dict(BAD_RULES[i])
    with pytest.raises(ValueError) as eb:
        rules.Rule.from_dict(BAD_RULES[i])
    assert str(eb.value) == str(ea.value)


def test_rule_file_and_pack_match_reference(tmp_path):
    path = tmp_path / "rules.json"
    path.write_text(json.dumps([
        {"name": "mine", "family": "scheduler_pending_pods", "labels": {"queue": "active"},
         "agg": "max", "window_s": 30.0, "op": ">=", "threshold": 100.0, "for_s": 5.0},
        {"name": "rec", "kind": "record", "family": "f", "agg": "count",
         "window_s": 10.0, "record_as": "f_count"}]))
    assert [r.to_dict() for r in rules.load_rules_file(str(path))] == [
        r.to_dict() for r in ref_rules.load_rules_file(str(path))]
    assert [r.to_dict() for r in rules.builtin_rules()] == [
        r.to_dict() for r in ref_rules.builtin_rules()]


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, dict(r.headers), r.read()


def _servers(dashboard=True):
    a, b = _stores()
    now = time.time()
    for store in (a, b):  # a recent window the endpoints' default covers
        for i in range(30):
            store.append("scheduler_slo_burn_rate", {"window": "slow"}, 0.25,
                         t=now - 30.0 + i)
    (_, ea, _), (_, eb, _) = _engines(0.25)
    ea.tsdb, eb.tsdb = a, b
    ea.evaluate(now)
    eb.evaluate(now)
    ra = ref_http.start_http_server(ref_metrics.SchedulerMetrics(), port=0, tsdb=a, alerts=ea,
                                    dashboard=dashboard)
    rb = http.start_http_server(port_metrics.SchedulerMetrics(), port=0, tsdb=b, alerts=eb,
                                dashboard=dashboard)
    return ra, rb


def _base(srv):
    return f"http://127.0.0.1:{srv.server_address[1]}"


ROUTES = [
    "/debug/metrics/history",
    "/debug/metrics/history?family=scheduler_slo_burn_rate&labels=window=slow&window=1000&step=1",
    "/debug/metrics/history?family=scheduler_slo_burn_rate&window=100000000&step=60",
    "/debug/metrics/history?family=cycle_phase_ms&window=100000000",
    "/debug/alerts",
]


@pytest.mark.parametrize("route", ROUTES)
def test_endpoints_match_reference(route):
    ra, rb = _servers()
    try:
        sa, _, body_a = _get(_base(ra) + route)
        sb, hb, body_b = _get(_base(rb) + route)
        assert sb == sa == 200
        assert hb["Content-Type"] == "application/json"
        ja, jb = json.loads(body_a), json.loads(body_b)
        ja.pop("now", None)
        jb.pop("now", None)
        if route.endswith("step=1"):  # the open 1 s bucket moves with the clock
            for j in (ja, jb):
                for s in j["series"]:
                    s["points"] = s["points"][:-2]
        assert jb == ja
    finally:
        http.stop_http_server(rb)
        ra.shutdown()


def test_dashboard_and_bad_query():
    ra, rb = _servers()
    try:
        sa, ha, body_a = _get(_base(ra) + "/debug/dashboard")
        sb, hb, body_b = _get(_base(rb) + "/debug/dashboard")
        assert (sb, hb["Content-Type"], body_b) == (sa, ha["Content-Type"], body_a)
        assert sb == 200 and b"<svg" in body_b
        for srv in (ra, rb):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(_base(srv) + "/debug/metrics/history?family=f&window=nope")
            assert ei.value.code == 400
    finally:
        http.stop_http_server(rb)
        ra.shutdown()


def test_dashboard_off_404s_and_routes_without_sources_404():
    ra, rb = _servers(dashboard=False)
    bare = http.start_http_server(port_metrics.SchedulerMetrics(), port=0)
    try:
        for srv in (ra, rb):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(_base(srv) + "/debug/dashboard")
            assert ei.value.code == 404
        for route in ("/debug/metrics/history", "/debug/alerts", "/debug/dashboard"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(_base(bare) + route)
            assert ei.value.code == 404
    finally:
        http.stop_http_server(rb)
        http.stop_http_server(bare)
        ra.shutdown()


def test_bundle_carries_both_sections_as_the_reference(tmp_path):
    a, b = _stores()
    (_, ea, _), (_, eb, _) = _engines(0.25)
    ea.tsdb, eb.tsdb = a, b
    for t in (T0 + 60.0, T0 + 120.0, T0 + 179.0):
        ea.evaluate(t)
        eb.evaluate(t)
    pa = ref_blackbox.BlackBox(str(tmp_path / "ref"), tsdb=a, engine=ea).dump("manual")
    pb = blackbox.BlackBox(str(tmp_path / "port"), tsdb=b, engine=eb).dump("manual")
    ba, bb = ref_blackbox.load_bundle(pa), blackbox.load_bundle(pb)
    for section in ("alerts", "metrics_history"):
        assert bb[section] == ba[section]
    assert bb["alerts"]["fired_total"] > 0 and bb["metrics_history"]["series"]


def test_registry_collect_matches_prometheus_client():
    ma, mb = ref_metrics.SchedulerMetrics(), port_metrics.SchedulerMetrics()
    for m in (ma, mb):
        m.plugin_duration.labels(plugin="NodeAffinity", extension_point="Filter",
                                 status="Success").observe(0.003)
        m.plugin_duration.labels(plugin="NodeAffinity", extension_point="Filter",
                                 status="Success").observe(2.0)
        m.alerts.labels(rule="slo_fast_burn", severity="critical").inc()
        m.compile_cache_hits.inc(3)
        m.degradation_rung.set(2)
        m.compile_cache_loads.observe(0.0001)

    names = ("scheduler_plugin_execution_duration_seconds", "scheduler_alerts_total",
             "scheduler_compile_cache_hits_total", "scheduler_degradation_rung",
             "scheduler_compile_cache_loads_seconds")

    def samples(m):
        out = set()
        for f in m.registry.collect():
            for s in f.samples:
                if s.name.endswith("_created") or not s.name.startswith(names):
                    continue
                out.add((s.name, tuple(sorted(s.labels.items())), float(s.value)))
        return out

    assert samples(mb) == samples(ma)


def test_config_fields_load_with_the_reference_defaults():
    for data in ({}, {"metricsHistorySamples": 128, "metricsTickerSeconds": 0.5,
                      "alertRulesFile": "/etc/rules.yaml", "debugDashboard": False,
                      "compileCacheDir": "/var/cache/kscc", "blackboxRetention": 3}):
        a, b = ref_config.load_config(data), port_config.load_config(data)
        for f in ("metrics_history_samples", "metrics_ticker_seconds", "alert_rules_file",
                  "debug_dashboard", "compile_cache_dir", "blackbox_retention"):
            assert getattr(b, f) == getattr(a, f), f
    assert port_config.SchedulerConfiguration().metrics_history_samples == 512


def test_arm_watchtower_samples_a_serving_scheduler(tmp_path):
    cfg = port_config.SchedulerConfiguration(commit_mode="scan", metrics_ticker_seconds=0.05,
                                             metrics_history_samples=64)
    s = Scheduler(cfg, device="cpu")
    store, engine = arm_watchtower(cfg, s, rules=rules.scale_rules(rules.builtin_rules(),
                                                                   0.01))
    try:
        assert tsdb.ARMED and tsdb.STORE is store and store.engine is engine
        assert store.raw_cap == 64 and store.observe_record in s.flight.observers
        nodes, pods, existing, _ = fixture("mixed", port_models, port_synth)
        for nd in nodes:
            s.on_node_add(nd)
        for p in pods:
            s.on_pod_add(p)
        for _ in range(2):
            s.schedule_cycle()
        # Wait for two ticks taken after the cycles: the ticker starts at
        # arm_watchtower, so earlier ticks may all predate the counters.
        after = store.ticks + 2
        deadline = time.time() + 10.0
        while store.ticks < after and time.time() < deadline:
            time.sleep(0.02)
        fams = {f["family"] for f in store.families()}
        assert "cycle_phase_ms" in fams and "cycle_count" in fams
        assert "scheduler_schedule_attempts_total" in fams  # the registry ticker
        assert engine.status()["evaluations"] > 0
        box = blackbox.BlackBox(str(tmp_path / "bb"), recorder=s.flight, tsdb=store,
                                engine=engine)
        bundle = blackbox.load_bundle(box.dump("manual"))
        assert {"alerts", "metrics_history", "flight"} <= set(bundle)
    finally:
        disarm_watchtower(s, store)
    assert not tsdb.ARMED and store.observe_record not in s.flight.observers
    assert arm_watchtower(port_config.SchedulerConfiguration(metrics_history_samples=0),
                          s) == (None, None)
