"""Scheduler-framework extension points (`k8s_scheduler_tpu/framework/
interfaces.py`). Two commit engines call the dynamic hooks: the rounds
engine the whole-pending-set (batched) ones, the scan engine the per-pod
ones (one pod's [N] row per step).

- PreFilter -> `CycleContext`: shared per-cycle precomputes, computed once.
- Filter    -> `static_mask` ([P, N], independent of in-cycle commitments),
               `dyn_mask` ([N] for one pod) and `dyn_mask_batched` ([P, N]),
               both against the running state.
- Score     -> `static_score` / `dyn_score` / `dyn_score_batched`, each
               0..100; the runtime applies the configured plugin weight.
- PostFilter -> `post_filter` (DefaultPreemption), after the cycle.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..ops import affinity_update as update_ops
from ..ops import dyn_round, interpod, labels
from ..ops import interpod_terms as terms_ops
from ..ops import preempt_claim, preempt_prefilter, preempt_whatif
from ..ops import pv_choice, pv_fold, volume_mask, volumes


@dataclasses.dataclass(frozen=True)
class AffinityKernels:
    """The functions the InterPodAffinity / PodTopologySpread hooks call:
    by default the dispatching wrappers of K3 and K4 (the kernel for CUDA
    tensors, the plain version for CPU ones); `plain()` forces the plain
    versions on any device."""

    interpod_terms: Callable = terms_ops.interpod_terms
    interpod_norm: Callable = terms_ops.interpod_norm
    affinity_update: Callable = update_ops.affinity_update

    @staticmethod
    def plain() -> "AffinityKernels":
        return AffinityKernels(terms_ops.interpod_terms_plain,
                               terms_ops.interpod_norm_plain,
                               update_ops.affinity_update_plain)


@dataclasses.dataclass(frozen=True)
class PreemptionKernels:
    """The three stages DefaultPreemption runs: by default the dispatching
    wrappers of K7-K9 (`build_preemption_fn`'s arguments select others)."""

    prefilter: Callable = preempt_prefilter.preempt_prefilter
    whatif: Callable = preempt_whatif.preempt_whatif
    claim: Callable = preempt_claim.preempt_claim


@dataclasses.dataclass(frozen=True)
class VolumeKernels:
    """The functions the VolumeBinding hooks call: by default the
    dispatching wrappers of K10-K12; `plain()` forces the plain versions."""

    volume_mask: Callable = volume_mask.volume_mask
    pv_choice: Callable = pv_choice.pv_choice
    pv_fold: Callable = pv_fold.pv_fold

    @staticmethod
    def plain() -> "VolumeKernels":
        return VolumeKernels(volumes.volume_mask_plain, volumes.pv_choice_plain,
                             volumes.pv_fold_plain)


@dataclasses.dataclass(frozen=True)
class DynKernels:
    """The rounds engine's two dynamic stages (`Framework.dyn_batched`,
    `score_anchor`) and the dynamic reject attribution
    (`Framework.dyn_rejects`): by default the dispatching wrappers of K14
    `dyn_mask`, K15 `dyn_score` and K17 `dyn_rejects`; `plain()` forces the
    plain versions."""

    dyn_mask: Callable = dyn_round.dyn_mask
    dyn_score: Callable = dyn_round.dyn_score
    dyn_rejects: Callable = dyn_round.dyn_rejects

    @staticmethod
    def plain() -> "DynKernels":
        return DynKernels(dyn_round.dyn_mask_plain, dyn_round.dyn_score_plain,
                          dyn_round.dyn_rejects_plain)


class CycleContext:
    """Shared per-cycle precomputes (the PreFilter-state analogue), computed
    lazily and cached for the cycle."""

    def __init__(self, snap, kernels: AffinityKernels | None = None,
                 preemption_kernels: PreemptionKernels | None = None,
                 volume_kernels: VolumeKernels | None = None,
                 dyn_kernels: DynKernels | None = None):
        self.snap = snap
        self.kernels = kernels or AffinityKernels()
        self.preemption_kernels = preemption_kernels or PreemptionKernels()
        self.volume_kernels = volume_kernels or VolumeKernels()
        self.dyn_kernels = dyn_kernels or DynKernels()
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

    @property
    def matched_existing(self) -> torch.Tensor:  # bool [S, E]
        return self.get("matched_existing", interpod.matched_existing)

    @property
    def requirement_rows(self) -> torch.Tensor:  # bool [Rq, N]
        """Every node-affinity requirement (pods', PVs', storage classes')
        against every node (node-side: shared by pod views)."""
        return self.get("requirement_rows", lambda s: labels.requirement_mask(
            s.rq_exprs, self.expr_node_mask))

    @property
    def volume_tables(self) -> volumes.VolumeTables:
        """The requirement rows and per-node lists of available PVs the
        volume kernels read (node-side: shared by pod views)."""
        return self.get("volume_tables",
                        lambda s: volumes.volume_tables(s, self.requirement_rows))

    def initial_affinity_state(self) -> interpod.AffinityState:
        return self.get(
            "initial_affinity_state",
            lambda s: interpod.initial_state(s, self.matched_existing),
        )

    def view(self, vsnap, vmp) -> "CycleContext":
        """A context for a pod-axis view of the snapshot: it shares the
        node-side precomputes and swaps in the view's matched-pending
        columns."""
        vctx = CycleContext(vsnap, self.kernels, self.preemption_kernels,
                            self.volume_kernels, self.dyn_kernels)
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

    def dyn_mask(self, ctx: CycleContext, p, node_requested,
                 extra) -> torch.Tensor | None:
        """bool [N] for pod `p` (an i32 0-d tensor) against the running
        state, at one step of the scan engine."""
        return None

    # --- Score (0..100; runtime applies weight) ---
    def static_score(self, ctx: CycleContext) -> torch.Tensor | None:
        return None

    def dyn_score(self, ctx: CycleContext, p, node_requested, extra,
                  feasible) -> torch.Tensor | None:
        """f32 [N] for pod `p`; `feasible` is the pod's full feasibility row
        [N] (static & every dynamic mask), for upstream-style normalize-
        over-feasible scoring. A score that is x * c may return the
        factors as a `commit.Product` instead, so the runtime can fuse the
        multiply into the score sum as the reference's compiled scan step
        does (`Framework.dyn`)."""
        return None

    # --- per-cycle plugin state carried through the commit ---
    def extra_init(self, ctx: CycleContext) -> Any | None:
        return None

    def extra_update(self, ctx: CycleContext, extra, p, node, committed):
        """Fold one scan step (pod `p` to `node`, i32 0-d tensors, when the
        bool 0-d `committed` holds) into this plugin's extra state."""
        return extra

    # --- batched dynamic path (ops/rounds.py) ---
    def dyn_mask_batched(self, ctx: CycleContext, node_requested, extra,
                         shared: dict) -> Any | None:
        """bool [P, N] of the view's pods, or operands that K14 evaluates
        itself (`dyn_round.FitMask`, `dyn_round.PortMask`). `shared` is a
        per-round scratch dict for precomputes that co-enabled plugins
        reuse."""
        return None

    def dyn_score_batched(self, ctx: CycleContext, node_requested, extra,
                          feasible, shared: dict) -> Any | None:
        """f32 [P, N], or operands that K15 evaluates itself
        (`dyn_round.FitScore`, `dyn_round.BalancedScore`); `feasible` is
        the static row AND every dynamic mask."""
        return None

    def extra_update_batched(self, ctx: CycleContext, extra, accepted,
                             node_of):
        """Fold a round's placements (accepted bool [P], node_of i32 [P])
        into this plugin's extra state."""
        return extra

    def score_node_anchor(self, ctx: CycleContext,
                          node_requested) -> Any | None:
        """Node-local component of this plugin's dynamic score at the given
        node_requested (f32 [N], or a one-row score operand of K15), used
        only to re-rank claims between acceptance passes."""
        return None

    # --- PostFilter ---
    def post_filter(self, ctx: CycleContext, assignment, node_requested,
                    gate_rows, excluded=None):
        """Nominations for the pods the cycle left unplaced (a
        PreemptionResult), or None."""
        return None
