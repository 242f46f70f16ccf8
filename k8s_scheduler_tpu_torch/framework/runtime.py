"""Framework runtime (`k8s_scheduler_tpu/framework/runtime.py`): asks each
enabled plugin for its mask/score fragments — batched for the rounds
engine, per pod for the scan engine — and ANDs / weighted-sums them.

Weighted sums reproduce the reference's compiled arithmetic: XLA contracts
`score + w * v` into one fused multiply-add, so each term here is folded
with `resources._fma` (a weight of 1 makes it a plain add either way). A
dynamic score that ends in a multiply by a constant (BalancedAllocation's
`* 100`, the resource scores' `* 1 / weight sum`) comes as its factors, a
`commit.Product`, and `dyn_round.sum_terms` fuses that multiply where the
compiled program does. The batched path (the rounds engine's) runs in two
stages, K14 `dyn_mask` and K15 `dyn_score` (`ops/dyn_round.py`, the
context's `dyn_kernels`), whose round program also fuses
BalancedAllocation's multiply in preference to a held one
(`dyn_round.dyn_score_plain`)."""

from __future__ import annotations

from typing import Any

import torch

from ..config import SchedulerConfiguration, default_plugins
from ..ops import static_base as static_base_ops
from ..ops.dyn_round import first_rejects, sum_terms
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

    @property
    def filter_names(self) -> list[str]:
        """Column names of the per-pod reject-count tables: the filter
        order, which is the first-rejector attribution order."""
        return [f.name for f in self.filters]

    def static(self, ctx: CycleContext
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """`static_lean`'s (mask [P, N], score [P, N]) and rejects i32 [P, F]:
        rejects[p, i] counts the valid nodes that static filter i rejects
        first for pod p (K16 `static_rejects` on the card, its plain
        version on the CPU)."""
        mask, score = self.static_lean(ctx)
        rejects = static_base_ops.static_rejects(
            static_base_ops.static_base_inputs(self, ctx))
        return mask, score, rejects

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

    def dyn(self, ctx: CycleContext, p, node_requested, extra, static_row,
            rejects: bool = True):
        """(mask [N], score [N], rejects i32 [F]) of pod `p` (i32 0-d)
        against the running state, at one scan step: the dynamic filters
        ANDed onto the static row in filter order, then every dynamic
        score, fed the full feasibility row, weighted and summed in score
        order (a `commit.Product` when the sum is one bare product, which
        the reference's scan step fuses into the static score's add).
        rejects[i] counts the nodes that filter i's dynamic mask rejects
        first (0 for a filter without one; the static rejections are
        `static`'s). With `rejects=False` (the latency outputs, whose
        reference program drops the counts) it is None."""
        mask = static_row
        counts = []
        for f in self.filters:
            m = f.dyn_mask(ctx, p, node_requested, extra)
            if m is None:
                if rejects:
                    counts.append(torch.zeros((), dtype=torch.int32,
                                              device=static_row.device))
            else:
                if rejects:
                    counts.append((mask & ~m).sum(dtype=torch.int32))
                mask = mask & m
        dyn = sum_terms((s.dyn_score(ctx, p, node_requested, extra, mask), w)
                        for s, w in self.scores)
        if dyn is None:
            dyn = torch.zeros((ctx.snap.N,), dtype=torch.float32,
                              device=static_row.device)
        return mask, dyn, torch.stack(counts) if rejects else None

    def extra_update(self, ctx: CycleContext, extra, p, node, committed):
        """Fold one scan step into every stateful plugin's extra state."""
        out = dict(extra)
        for pl in self._stateful_plugins():
            if pl.name in out:
                out[pl.name] = pl.extra_update(ctx, out[pl.name], p, node,
                                               committed)
        return out

    def dyn_parts(self, ctx: CycleContext, node_requested, extra, shared: dict
                  ) -> tuple[tuple[int, Any], ...]:
        """Every filter's dynamic part against the running state (a bool
        [B, N] plane, `dyn_round.FitMask` or `dyn_round.PortMask`), in
        filter order, each with its column: the filter's index."""
        return tuple((i, m) for i, f in enumerate(self.filters)
                     if (m := f.dyn_mask_batched(ctx, node_requested, extra, shared))
                     is not None)

    def dyn_rejects(self, ctx: CycleContext, node_requested, extra, start, rows=None):
        """i32 [B, F] first-rejector counts of the dynamic filters of every
        pod row of the view against the running state, from the start mask
        `start` (bool [B, N]); rows where `rows` (bool [B]) is False count
        nothing (the context's `dyn_kernels`: K17 `dyn_rejects` on the
        card)."""
        parts = self.dyn_parts(ctx, node_requested, extra, {})
        return ctx.dyn_kernels.dyn_rejects(start, parts, len(self.filters), rows)

    def attribute_rejects(self, base_mask, per_filter, rows=None):
        """First-rejector attribution over a chain of filter masks in
        filter order (plain torch, `dyn_round.first_rejects`): i32 [P, F]."""
        return first_rejects(base_mask, per_filter, rows)

    def dyn_batched(self, ctx: CycleContext, node_requested, extra, vsbase,
                    act_v=None):
        """(mask, base), bool and f32 [B, N], of every pod row of the view
        against the running state, as the reference's round program forms
        them (`ops/rounds.py:577-581`), in two stages (the context's
        `dyn_kernels`, K14 and K15 on the card): feasible = the static row
        (vsbase > NEG_INF / 2) AND every filter's dynamic mask, mask =
        feasible & act_v (None: every row); base = vsbase + the dynamic
        scores, fed `feasible`, weighted and summed in score order
        (`dyn_round.sum_terms`; a lone bare product fuses into the add)."""
        shared: dict = {}
        parts = tuple(m for _, m in self.dyn_parts(ctx, node_requested, extra, shared))
        mask, feasible = ctx.dyn_kernels.dyn_mask(vsbase, parts, act_v)
        terms = tuple((v, w) for s, w in self.scores
                      if (v := s.dyn_score_batched(ctx, node_requested, extra, feasible,
                                                   shared)) is not None)
        return mask, ctx.dyn_kernels.dyn_score(vsbase, terms)

    def score_anchor(self, ctx: CycleContext, node_requested):
        """Weighted sum of the score plugins' node-local capacity components
        (f32 [N]; K15 on one zero-request pod row), or None when no plugin
        has one."""
        terms = tuple((v.reshape(1, -1) if isinstance(v, torch.Tensor) else v, w)
                      for s, w in self.scores
                      if (v := s.score_node_anchor(ctx, node_requested)) is not None)
        return ctx.dyn_kernels.dyn_score(None, terms)[0] if terms else None

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
