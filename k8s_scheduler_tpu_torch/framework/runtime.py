"""Framework runtime (`k8s_scheduler_tpu/framework/runtime.py`): asks each
enabled plugin for its batched mask/score fragments and ANDs / weighted-
sums them.

Weighted sums reproduce the reference's compiled arithmetic: XLA contracts
`score + w * v` into one fused multiply-add, so each term here is folded
with `resources._fma` (a weight of 1 makes it a plain add either way)."""

from __future__ import annotations

from typing import Any

import torch

from ..config import SchedulerConfiguration, default_plugins
from ..ops.resources import _fma
from .interfaces import CycleContext, PluginBase
from .registry import Registry, default_registry


def _accumulate(total, weight: float, value: torch.Tensor) -> torch.Tensor:
    """total + weight * value with one rounding (total None = 0)."""
    if total is None:
        total = torch.zeros_like(value, dtype=torch.float32)
    if weight == 1.0:  # the fused form of a unit weight is a plain add
        return total + value
    return _fma(value, weight, total)


class Framework:
    def __init__(
        self,
        filters: list[PluginBase],
        scores: list[tuple[PluginBase, float]],
        post_filters: list[PluginBase] = (),
    ):
        self.filters = list(filters)
        self.scores = list(scores)
        self.post_filters = list(post_filters)

    @staticmethod
    def from_config(
        config: SchedulerConfiguration | None = None,
        scheduler_name: str = "default-scheduler",
        registry: Registry | None = None,
    ) -> "Framework":
        config = config or SchedulerConfiguration()
        registry = registry or default_registry()
        profile = config.profile(scheduler_name)
        defaults = default_plugins()
        args = profile.plugin_config

        def make(entries):
            # unknown names fail loudly (Registry.make raises KeyError)
            return [(registry.make(e.name, args.get(e.name)), e.weight)
                    for e in entries]

        filters = [p for p, _ in make(profile.plugins.filter.resolve(defaults["filter"]))]
        scores = [
            (p, float(w))
            for p, w in make(profile.plugins.score.resolve(defaults["score"]))
        ]
        post_filters = [
            p for p, _ in make(profile.plugins.post_filter.resolve(defaults["post_filter"]))
        ]
        return Framework(filters, scores, post_filters)

    def static_lean(self, ctx: CycleContext) -> tuple[torch.Tensor, torch.Tensor]:
        """Static filters ANDed (mask [P, N]) and static scores weighted and
        summed in plugin order (score [P, N])."""
        snap = ctx.snap
        mask = snap.node_valid[None, :].expand(snap.P, snap.N)
        for f in self.filters:
            m = f.static_mask(ctx)
            if m is not None:
                mask = mask & m
        score = torch.zeros((snap.P, snap.N), dtype=torch.float32,
                            device=snap.device)
        for s, w in self.scores:
            v = s.static_score(ctx)
            if v is not None:
                score = _accumulate(score, w, v)
        return mask, score

    def _stateful_plugins(self) -> list[PluginBase]:
        # a plugin enabled at several points owns ONE extra-state slot
        seen: dict[str, PluginBase] = {}
        for p in self.filters + [s for s, _ in self.scores]:
            seen.setdefault(p.name, p)
        return list(seen.values())

    def extra_init(self, ctx: CycleContext) -> dict[str, Any]:
        extra = {}
        for p in self._stateful_plugins():
            e = p.extra_init(ctx)
            if e is not None:
                extra[p.name] = e
        return extra

    def dyn_batched(self, ctx: CycleContext, node_requested, extra,
                    static_mask):
        """Returns (mask [P, N], score [P, N]) against the running state."""
        snap = ctx.snap
        shared: dict = {}
        mask = static_mask
        for f in self.filters:
            m = f.dyn_mask_batched(ctx, node_requested, extra, shared)
            if m is not None:
                mask = mask & m
        score = torch.zeros((snap.P, snap.N), dtype=torch.float32,
                            device=snap.device)
        for s, w in self.scores:
            v = s.dyn_score_batched(ctx, node_requested, extra, mask, shared)
            if v is not None:
                score = _accumulate(score, w, v)
        return mask, score

    def score_anchor(self, ctx: CycleContext, node_requested):
        """Weighted sum of the score plugins' node-local capacity components
        (f32 [N]), or None when no plugin has one."""
        total = None
        for s, w in self.scores:
            a = s.score_node_anchor(ctx, node_requested)
            if a is not None:
                total = _accumulate(total, w, a)
        return total

    def extra_update_batched(self, ctx: CycleContext, extra, accepted,
                             node_of):
        out = dict(extra)
        for pl in self._stateful_plugins():
            if pl.name in out:
                out[pl.name] = pl.extra_update_batched(
                    ctx, out[pl.name], accepted, node_of
                )
        return out

    def post_filter(self, ctx: CycleContext, assignment, node_requested,
                    gate_rows, excluded=None):
        """Run PostFilter plugins in order; the first non-None result wins
        (upstream RunPostFilterPlugins stops at the first nomination)."""
        for p in self.post_filters:
            r = p.post_filter(ctx, assignment, node_requested, gate_rows,
                              excluded)
            if r is not None:
                return r
        return None
