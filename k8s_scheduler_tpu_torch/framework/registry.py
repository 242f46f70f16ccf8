"""Plugin registry: name -> factory (`k8s_scheduler_tpu/framework/
registry.py`)."""

from __future__ import annotations

from typing import Callable

from .interfaces import PluginBase

Factory = Callable[[dict], PluginBase]


class Registry:
    def __init__(self) -> None:
        self._factories: dict[str, Factory] = {}

    def register(self, name: str, factory: Factory) -> None:
        if name in self._factories:
            raise ValueError(f"plugin {name!r} already registered")
        self._factories[name] = factory

    def make(self, name: str, args: dict | None = None) -> PluginBase:
        if name not in self._factories:
            raise KeyError(f"unknown plugin {name!r}; registered: "
                           f"{sorted(self._factories)}")
        return self._factories[name](args or {})

    def names(self) -> list[str]:
        return sorted(self._factories)


def default_registry() -> Registry:
    from . import plugins as p

    r = Registry()
    for cls in (
        p.NodeUnschedulable,
        p.NodeName,
        p.NodePorts,
        p.NodeResourcesFit,
        p.NodeResourcesBalancedAllocation,
        p.VolumeBinding,
        p.NodeAffinity,
        p.TaintToleration,
        p.ImageLocality,
        p.InterPodAffinity,
        p.PodTopologySpread,
        p.DefaultPreemption,
    ):
        r.register(cls.name, lambda args, _cls=cls: _cls(args))
    return r
