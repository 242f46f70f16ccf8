"""Config API subset: the part of `k8s_scheduler_tpu/config/types.py` the
port reads — profiles with per-extension-point plugin sets and args
(queueSort, filter, postFilter, score), the default plugin sets and
weights, `commit_mode`, `gang_scheduling` and
`percentage_of_nodes_to_score`, and `load_config` for those fields under
their upstream names. The port keeps its own copy; the serving knobs wait
for the host slice (ROADMAP A10)."""

from __future__ import annotations

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
    filter: PluginSet = field(default_factory=PluginSet)
    post_filter: PluginSet = field(default_factory=PluginSet)
    score: PluginSet = field(default_factory=PluginSet)


@dataclass
class Profile:
    scheduler_name: str = "default-scheduler"
    plugins: Plugins = field(default_factory=Plugins)
    plugin_config: dict[str, dict[str, Any]] = field(default_factory=dict)


@dataclass
class SchedulerConfiguration:
    profiles: list[Profile] = field(default_factory=lambda: [Profile()])
    percentage_of_nodes_to_score: int = 0  # 0 = adaptive (upstream default)
    gang_scheduling: bool = True
    # in-cycle commitment engine: "rounds" or "scan" (build_cycle_fn's
    # commit_mode)
    commit_mode: str = "rounds"

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


def _plugin_set_from_dict(d: dict) -> PluginSet:
    return PluginSet(
        enabled=[PluginEntry(e["name"], e.get("weight", 1)) for e in d.get("enabled", [])],
        disabled=[e["name"] if isinstance(e, dict) else e for e in d.get("disabled", [])],
    )


# (upstream extension-point name, Plugins attribute) for the points the port reads
_POINTS = (("queueSort", "queue_sort"), ("filter", "filter"),
           ("postFilter", "post_filter"), ("score", "score"))


def load_config(source: "str | dict") -> SchedulerConfiguration:
    """A configuration from a dict (or a YAML string or file path, where
    PyYAML is installed) with upstream field names, as the reference's
    `load_config` reads them, for the fields this subset has."""
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
        gang_scheduling=data.get("gangScheduling", True),
        commit_mode=data.get("commitMode", "rounds"),
    )
