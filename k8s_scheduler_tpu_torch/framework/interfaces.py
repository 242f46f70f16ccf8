"""Scheduler-framework extension points (`k8s_scheduler_tpu/framework/
interfaces.py`), batched form only: the rounds engine is the one commit
engine of this slice, so plugins implement the whole-pending-set hooks.

- PreFilter -> `CycleContext`: shared per-cycle precomputes, computed once.
- Filter    -> `static_mask` ([P, N], independent of in-cycle commitments)
               and `dyn_mask_batched` ([P, N] against the running state).
- Score     -> `static_score` / `dyn_score_batched`, each 0..100; the
               runtime applies the configured plugin weight.
"""

from __future__ import annotations

from typing import Any

import torch

from ..ops import interpod, labels


class CycleContext:
    """Shared per-cycle precomputes (the PreFilter-state analogue), computed
    lazily and cached for the cycle."""

    def __init__(self, snap):
        self.snap = snap
        self._cache: dict[str, Any] = {}

    def get(self, key: str, compute) -> Any:
        if key not in self._cache:
            self._cache[key] = compute(self.snap)
        return self._cache[key]

    @property
    def expr_node_mask(self) -> torch.Tensor:  # bool [Ex, N]
        return self.get("expr_node_mask", labels.expr_node_mask)

    @property
    def matched_pending(self) -> torch.Tensor:  # bool [S, P]
        return self.get("matched_pending", interpod.matched_pending)

    def view(self, vsnap, vmp) -> "CycleContext":
        """A context for a pod-axis view of the snapshot: it shares the
        node-side precomputes and swaps in the view's matched-pending
        columns."""
        vctx = CycleContext(vsnap)
        vctx._cache.update(self._cache)
        vctx._cache["matched_pending"] = vmp
        return vctx


class PluginBase:
    name: str = ""

    def __init__(self, args: dict | None = None):
        self.args = args or {}

    # --- Filter ---
    def static_mask(self, ctx: CycleContext) -> torch.Tensor | None:
        return None

    # --- Score (0..100; runtime applies weight) ---
    def static_score(self, ctx: CycleContext) -> torch.Tensor | None:
        return None

    # --- per-cycle plugin state carried through the rounds ---
    def extra_init(self, ctx: CycleContext) -> Any | None:
        return None

    # --- batched dynamic path (ops/rounds.py) ---
    def dyn_mask_batched(self, ctx: CycleContext, node_requested, extra,
                         shared: dict) -> torch.Tensor | None:
        """`shared` is a per-round scratch dict for precomputes that
        co-enabled plugins reuse."""
        return None

    def dyn_score_batched(self, ctx: CycleContext, node_requested, extra,
                          feasible, shared: dict) -> torch.Tensor | None:
        return None

    def extra_update_batched(self, ctx: CycleContext, extra, accepted,
                             node_of):
        """Fold a round's placements (accepted bool [P], node_of i32 [P])
        into this plugin's extra state."""
        return extra

    def score_node_anchor(self, ctx: CycleContext,
                          node_requested) -> torch.Tensor | None:
        """Node-local component of this plugin's dynamic score at the given
        node_requested (f32 [N]), used only to re-rank claims between
        acceptance passes."""
        return None
