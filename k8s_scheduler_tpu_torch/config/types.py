"""Config API subset: the part of `k8s_scheduler_tpu/config/types.py` the
rounds-engine slice reads — profiles with per-extension-point plugin
sets and args, the default plugin sets and weights, `commit_mode`,
`gang_scheduling` and `percentage_of_nodes_to_score`. The port keeps its
own copy; YAML loading and the serving knobs wait for the host slice."""

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
    # in-cycle commitment engine; the port has only the rounds engine
    # ("scan" waits for ROADMAP item A8)
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
