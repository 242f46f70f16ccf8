"""Framework runtime (`k8s_scheduler_tpu/framework/runtime.py`): asks each
enabled plugin for its mask/score fragments — batched for the rounds
engine, per pod for the scan engine — and ANDs / weighted-sums them.

Weighted sums reproduce the reference's compiled arithmetic: XLA contracts
`score + w * v` into one fused multiply-add, so each term here is folded
with `resources._fma` (a weight of 1 makes it a plain add either way). A
dynamic score that ends in a multiply by a constant (BalancedAllocation's
`* 100`, the resource scores' `* 1 / weight sum`) comes as its factors, a
`commit.Product`, and `_sum_terms` fuses that multiply where the compiled
program does, in the batched and the per-pod sums alike."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..config import SchedulerConfiguration, default_plugins
from ..ops.commit import Product
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


def _sum_terms(terms):
    """Weighted sum of score terms, each (value, weight) with value a
    tensor, a `commit.Product` or None, in the reference's compiled
    arithmetic: each add fuses a multiply feeding it — the running sum's
    while that is still a bare product (a first term given as factors,
    with the weight folded into its constant), else the new term's (a
    weight other than 1, or factors). Returns None (no term), a tensor, or
    a `commit.Product` when the whole sum is one bare product."""
    acc, held = None, None  # the running sum; a bare product (x, c)
    for v, w in terms:
        if v is None:
            continue
        if isinstance(v, Product):
            x, c = v.x, float(np.float32(v.c) * np.float32(w))
        else:
            x, c = (v, None) if w == 1.0 else (v, float(w))
        if acc is None and held is None:
            if c is None:
                acc = x
            else:
                held = (x, c)
        elif held is not None:
            acc = _fma(held[0], held[1], x if c is None else x * c)
            held = None
        elif c is None:
            acc = acc + x
        else:
            acc = _fma(x, c, acc)
    return Product(*held) if held is not None else acc


def _rounded(v):
    """A sum of `_sum_terms` as a tensor (a bare product rounded once)."""
    return v.x * v.c if isinstance(v, Product) else v


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

    def dyn(self, ctx: CycleContext, p, node_requested, extra, static_row):
        """(mask [N], score [N]) of pod `p` (i32 0-d) against the running
        state, at one scan step: the dynamic filters ANDed onto the static
        row in filter order, then every dynamic score, fed the full
        feasibility row, weighted and summed in score order (a
        `commit.Product` when the sum is one bare product, which the
        reference's scan step fuses into the static score's add). (The
        reference's per-filter reject counts belong to the full outputs,
        ROADMAP A9; its latency program drops them.)"""
        mask = static_row
        for f in self.filters:
            m = f.dyn_mask(ctx, p, node_requested, extra)
            if m is not None:
                mask = mask & m
        dyn = _sum_terms((s.dyn_score(ctx, p, node_requested, extra, mask), w)
                         for s, w in self.scores)
        if dyn is None:
            dyn = torch.zeros((ctx.snap.N,), dtype=torch.float32,
                              device=static_row.device)
        return mask, dyn

    def extra_update(self, ctx: CycleContext, extra, p, node, committed):
        """Fold one scan step into every stateful plugin's extra state."""
        out = dict(extra)
        for pl in self._stateful_plugins():
            if pl.name in out:
                out[pl.name] = pl.extra_update(ctx, out[pl.name], p, node,
                                               committed)
        return out

    def dyn_batched(self, ctx: CycleContext, node_requested, extra,
                    static_mask):
        """Returns (mask [P, N], score [P, N]) against the running state,
        the score summed by `_sum_terms`: a tensor, or a `commit.Product`
        when the sum is one bare product, which the rounds engine's base
        add fuses (`commit.add_static`), as the reference's round program
        does."""
        snap = ctx.snap
        shared: dict = {}
        mask = static_mask
        for f in self.filters:
            m = f.dyn_mask_batched(ctx, node_requested, extra, shared)
            if m is not None:
                mask = mask & m
        score = _sum_terms(
            (s.dyn_score_batched(ctx, node_requested, extra, mask, shared), w)
            for s, w in self.scores)
        if score is None:
            score = torch.zeros((snap.P, snap.N), dtype=torch.float32,
                                device=snap.device)
        return mask, score

    def score_anchor(self, ctx: CycleContext, node_requested):
        """Weighted sum of the score plugins' node-local capacity components
        (f32 [N]), or None when no plugin has one."""
        return _rounded(_sum_terms((s.score_node_anchor(ctx, node_requested), w)
                                   for s, w in self.scores))

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
