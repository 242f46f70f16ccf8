"""The config API: the port's copy of `k8s_scheduler_tpu/config/types.py`
— profiles with per-extension-point plugin sets and args (every point
upstream names), the default plugin sets and weights, every serving
field with the reference's defaults, and `load_config`, which reads every
field the reference's reads under its upstream name. `shard_devices` > 1
is read but refused by the `Scheduler` (ROADMAP A13)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass
class PluginEntry:
    name: str
    weight: int = 1


@dataclass
class PluginSet:
    enabled: list[PluginEntry] = field(default_factory=list)
    disabled: list[str] = field(default_factory=list)  # ["*"] = all defaults

    def resolve(self, defaults: list[PluginEntry]) -> list[PluginEntry]:
        """Upstream merge semantics: defaults minus disabled, plus enabled
        (enabled entries replace same-named defaults to carry new weights)."""
        if "*" in self.disabled:
            base: list[PluginEntry] = []
        else:
            base = [d for d in defaults if d.name not in self.disabled]
        out = {e.name: e for e in base}
        for e in self.enabled:
            out[e.name] = e
        return list(out.values())


@dataclass
class Plugins:
    queue_sort: PluginSet = field(default_factory=PluginSet)
    pre_filter: PluginSet = field(default_factory=PluginSet)
    filter: PluginSet = field(default_factory=PluginSet)
    post_filter: PluginSet = field(default_factory=PluginSet)
    pre_score: PluginSet = field(default_factory=PluginSet)
    score: PluginSet = field(default_factory=PluginSet)
    reserve: PluginSet = field(default_factory=PluginSet)
    permit: PluginSet = field(default_factory=PluginSet)
    bind: PluginSet = field(default_factory=PluginSet)


@dataclass
class Profile:
    scheduler_name: str = "default-scheduler"
    plugins: Plugins = field(default_factory=Plugins)
    plugin_config: dict[str, dict[str, Any]] = field(default_factory=dict)


@dataclass
class Extender:
    """HTTP scheduler-extender config (upstream `Extender` in
    KubeSchedulerConfiguration): filter/prioritize/bind delegation to an
    external webhook. `carry_verdicts` is the operator's assertion that
    the Filter/Prioritize verdicts are deterministic per pod (the
    reference keeps its device-carry path then)."""

    url_prefix: str
    filter_verb: str = ""
    prioritize_verb: str = ""
    bind_verb: str = ""
    weight: int = 1
    http_timeout_seconds: float = 5.0
    ignorable: bool = False  # errors don't fail the pod's attempt
    carry_verdicts: bool = False


@dataclass
class SchedulerConfiguration:
    profiles: list[Profile] = field(default_factory=lambda: [Profile()])
    percentage_of_nodes_to_score: int = 0  # 0 = adaptive (upstream default)
    pod_initial_backoff_seconds: float = 1.0
    pod_max_backoff_seconds: float = 10.0
    gang_scheduling: bool = True
    # in-cycle commitment engine: "rounds" or "scan" (build_cycle_fn's
    # commit_mode)
    commit_mode: str = "rounds"
    extenders: list[Extender] = field(default_factory=list)
    # the encoder's sticky pads (0 = size from the first snapshot)
    pad_existing: int = 0
    pad_pods_per_node: int = 0
    pad_ma: int = 0
    pad_mc: int = 0
    # block every pipeline dispatch to completion (identical results)
    forced_sync: bool = False
    # flight recorder ring capacity (0 disables recording, the observer
    # and the speculative warm builds)
    flight_recorder_size: int = 512
    # /healthz staleness deadline: 503 when no cycle completed within this
    # many seconds (0 = never stale; cmd/main.py)
    health_max_cycle_age_seconds: float = 0.0
    # latency SLO over the observer's window (0 disables the objective)
    slo_p99_ms: float = 0.0
    slo_window_cycles: int = 1024
    # multi-cycle dispatch: up to K arrival groups a dispatch; 1 = every cycle alone
    multi_cycle_k: int = 1
    multi_cycle_max_wait_ms: float = 5.0
    # down-step margin of the P / N pad buckets (0 = immediate)
    pad_hysteresis_pct: float = 0.0
    # the persistent kernel cache (core/compile_cache.py): "" derives
    # <stateDir>/compile_cache when stateDir is set, else off; "off" /
    # "none" turn it off even with a state dir
    compile_cache_dir: str = ""
    # multi-device carry (ROADMAP A13); 0 / 1 = one device
    shard_devices: int = 0
    # warm-build the adjacent pad regime off the serving thread
    speculative_compile: bool = True
    # depth-2 speculative dispatch, multi-cycle path only
    speculative_dispatch: bool = True
    # admission-time encode, multi-cycle path only (a no-op at K = 1)
    incremental_encode: bool = False
    # bound on the blocking decision fetch in ms (0 = unbounded)
    dispatch_deadline_ms: float = 0.0
    # clean cycles before the degradation ladder steps back up
    degrade_promote_cycles: int = 8
    # fault injection (core/faults.py): a FaultPlan spec like
    # "fetch_hang@cycle=40:ms=5000" (env SCHED_FAULTS when this is
    # empty); "" disarms
    fault_spec: str = ""
    # the front door (service/admission.py): bound on the admission
    # queue (pending pods in every queue tier); a Submit that would pass
    # it is shed whole with a retry-after hint. 0 disables the bound.
    admission_queue_depth: int = 65536
    # retry-after hint (ms) of a shed submission (HTTP Retry-After)
    admission_retry_after_ms: float = 250.0
    # pod-lifecycle tracing (core/spans.py): head-sampling probability of
    # a submission without a traceparent (deterministic per pod uid);
    # 0 leaves tracing unarmed, 1 traces every pod
    trace_sample_rate: float = 1.0 / 64.0
    # durable state (state/): directory of the write-ahead journal and
    # the snapshots; "" disables durability
    state_dir: str = ""
    # snapshot cadence in seconds (0 = journal only, never compact)
    snapshot_interval_seconds: float = 60.0
    # the watchtower (metrics/tsdb.py + metrics/rules.py): per-series raw
    # ring capacity of the in-process metrics history; `arm_watchtower`
    # arms the store and the built-in alert rules when > 0 (0 disables
    # history, rules and dashboard)
    metrics_history_samples: int = 512
    # wall-ticker cadence (seconds) sampling the registry's gauges (0 =
    # cycle-driven samples only)
    metrics_ticker_seconds: float = 2.0
    # extra alert rules (YAML/JSON list of rule objects) appended to the
    # built-in pack ("" = the built-in pack only)
    alert_rules_file: str = ""
    # crash black box (core/blackbox.py): bundles kept under
    # <stateDir>/blackbox/ (0 disables capture)
    blackbox_retention: int = 8
    # /debug/dashboard (needs the watchtower armed); False turns just the
    # page off, the history and alerts endpoints stay
    debug_dashboard: bool = True

    def profile(self, scheduler_name: str = "default-scheduler") -> Profile:
        for p in self.profiles:
            if p.scheduler_name == scheduler_name:
                return p
        return self.profiles[0]


# Upstream default plugin sets (PodTopologySpread 2, TaintToleration 3,
# others 1), in the reference's order: the static score sums in this
# order, and f32 sums are order-sensitive.
_DEFAULT_FILTERS = [
    "NodeUnschedulable",
    "NodeName",
    "TaintToleration",
    "NodeAffinity",
    "NodePorts",
    "NodeResourcesFit",
    "VolumeBinding",
    "InterPodAffinity",
    "PodTopologySpread",
]
_DEFAULT_SCORES = [
    ("NodeResourcesBalancedAllocation", 1),
    ("ImageLocality", 1),
    ("InterPodAffinity", 1),
    ("NodeResourcesFit", 1),
    ("NodeAffinity", 1),
    ("PodTopologySpread", 2),
    ("TaintToleration", 3),
]
_DEFAULT_POST_FILTERS = ["DefaultPreemption"]


def default_plugins() -> dict[str, list[PluginEntry]]:
    return {
        "filter": [PluginEntry(n) for n in _DEFAULT_FILTERS],
        "score": [PluginEntry(n, w) for n, w in _DEFAULT_SCORES],
        "post_filter": [PluginEntry(n) for n in _DEFAULT_POST_FILTERS],
    }


def _duration_seconds(v) -> float:
    """Upstream serializes durations as strings ('5s', '500ms', '1m30s');
    accept those and plain numbers."""
    if isinstance(v, (int, float)):
        return float(v)
    import re

    total = 0.0
    for num, unit in re.findall(r"([0-9.]+)(h|m(?!s)|s|ms|us|ns)", str(v)):
        total += float(num) * {"h": 3600.0, "m": 60.0, "s": 1.0,
                               "ms": 1e-3, "us": 1e-6, "ns": 1e-9}[unit]
    return total or 5.0


def _plugin_set_from_dict(d: dict) -> PluginSet:
    return PluginSet(
        enabled=[PluginEntry(e["name"], e.get("weight", 1)) for e in d.get("enabled", [])],
        disabled=[e["name"] if isinstance(e, dict) else e for e in d.get("disabled", [])],
    )


# (upstream extension-point name, Plugins attribute), every point the reference reads
_POINTS = (("queueSort", "queue_sort"), ("preFilter", "pre_filter"), ("filter", "filter"),
           ("postFilter", "post_filter"), ("preScore", "pre_score"), ("score", "score"),
           ("reserve", "reserve"), ("permit", "permit"), ("bind", "bind"))


def load_config(source: "str | dict") -> SchedulerConfiguration:
    """A configuration from a dict (or a YAML string or file path, where
    PyYAML is installed) with upstream field names, as the reference's
    `load_config` reads them: every field it reads."""
    if isinstance(source, str):
        import yaml

        if "\n" not in source and source.endswith((".yaml", ".yml", ".json")):
            with open(source) as f:
                source = yaml.safe_load(f)
        else:
            source = yaml.safe_load(source)
    data = source or {}
    profiles = []
    for pd in data.get("profiles", [{}]):
        plugins = Plugins()
        for point, attr in _POINTS:
            if point in pd.get("plugins", {}):
                setattr(plugins, attr, _plugin_set_from_dict(pd["plugins"][point]))
        profiles.append(Profile(
            scheduler_name=pd.get("schedulerName", "default-scheduler"),
            plugins=plugins,
            plugin_config={e["name"]: e.get("args", {}) for e in pd.get("pluginConfig", [])},
        ))
    return SchedulerConfiguration(
        profiles=profiles or [Profile()],
        percentage_of_nodes_to_score=data.get("percentageOfNodesToScore", 0),
        pod_initial_backoff_seconds=data.get("podInitialBackoffSeconds", 1.0),
        pod_max_backoff_seconds=data.get("podMaxBackoffSeconds", 10.0),
        gang_scheduling=data.get("gangScheduling", True),
        commit_mode=data.get("commitMode", "rounds"),
        pad_existing=int(data.get("padExisting", 0)),
        pad_pods_per_node=int(data.get("padPodsPerNode", 0)),
        pad_ma=int(data.get("padMa", 0)),
        pad_mc=int(data.get("padMc", 0)),
        forced_sync=bool(data.get("forcedSync", False)),
        flight_recorder_size=int(data.get("flightRecorderSize", 512)),
        health_max_cycle_age_seconds=_duration_seconds(data.get("healthMaxCycleAge", 0.0)),
        slo_p99_ms=float(data.get("sloP99Ms", 0.0)),
        slo_window_cycles=int(data.get("sloWindowCycles", 1024)),
        multi_cycle_k=int(data.get("multiCycleK", 1)),
        multi_cycle_max_wait_ms=float(data.get("multiCycleMaxWaitMs", 5.0)),
        pad_hysteresis_pct=float(data.get("padHysteresisPct", 0.0)),
        compile_cache_dir=str(data.get("compileCacheDir", "")),
        shard_devices=int(data.get("shardDevices", 0)),
        speculative_compile=bool(data.get("speculativeCompile", True)),
        speculative_dispatch=bool(data.get("speculativeDispatch", True)),
        incremental_encode=bool(data.get("incrementalEncode", False)),
        dispatch_deadline_ms=float(data.get("dispatchDeadlineMs", 0.0)),
        degrade_promote_cycles=int(data.get("degradePromoteCycles", 8)),
        fault_spec=str(data.get("faultSpec", "")),
        admission_queue_depth=int(data.get("admissionQueueDepth", 65536)),
        admission_retry_after_ms=float(data.get("admissionRetryAfterMs", 250.0)),
        trace_sample_rate=float(data.get("traceSampleRate", 1.0 / 64.0)),
        state_dir=str(data.get("stateDir", "")),
        snapshot_interval_seconds=_duration_seconds(data.get("snapshotInterval", 60.0)),
        metrics_history_samples=int(data.get("metricsHistorySamples", 512)),
        metrics_ticker_seconds=float(data.get("metricsTickerSeconds", 2.0)),
        alert_rules_file=str(data.get("alertRulesFile", "")),
        blackbox_retention=int(data.get("blackboxRetention", 8)),
        debug_dashboard=bool(data.get("debugDashboard", True)),
        extenders=[
            Extender(
                url_prefix=e["urlPrefix"],
                filter_verb=e.get("filterVerb", ""),
                prioritize_verb=e.get("prioritizeVerb", ""),
                bind_verb=e.get("bindVerb", ""),
                weight=e.get("weight", 1),
                http_timeout_seconds=_duration_seconds(e.get("httpTimeout", 5.0)),
                ignorable=e.get("ignorable", False),
                carry_verdicts=e.get("carryVerdicts", False),
            )
            for e in data.get("extenders", [])
        ],
    )


def to_dict(cfg: SchedulerConfiguration) -> dict:
    return dataclasses.asdict(cfg)
