"""The default plugin set (`k8s_scheduler_tpu/framework/plugins.py`).

Ported: NodeUnschedulable, NodeName, NodePorts, NodeResourcesFit,
NodeResourcesBalancedAllocation, NodeAffinity, TaintToleration,
ImageLocality, VolumeBinding, InterPodAffinity, PodTopologySpread and
DefaultPreemption, with their batched hooks (the rounds engine's) and their
per-pod hooks (the scan engine's), except VolumeBinding's per-pod hooks
(ROADMAP A8b: the scan refuses a snapshot with volumes)."""

from __future__ import annotations

import torch

from ..ops import dyn_round
from ..ops import images as images_ops
from ..ops import interpod as interpod_ops
from ..ops import labels as labels_ops
from ..ops import ports as ports_ops
from ..ops import preemption as preemption_ops
from ..ops import resources as res_ops
from ..ops import taints as taints_ops
from ..ops import volumes as volumes_ops
from ..ops.commit import Constant, OneResourceFit, Product
from ..ops.interpod import take_row
from .interfaces import CycleContext, PluginBase


def _score_resource_weights(snap, args: dict) -> tuple[float, ...]:
    """score_resources arg -> one-hot [R] weights (cpu+memory by default)."""
    score_resources = args.get("score_resources", ("cpu", "memory"))
    w = [0.0] * len(snap.resource_names)
    for r in score_resources:
        if r in snap.resource_names:
            w[snap.resource_names.index(r)] = 1.0
    return tuple(w)


def _zero_pod(snap) -> torch.Tensor:
    """The score anchor's pod row: no request (f32 [1, R]; one per cycle
    context, so that the resource scores' anchors share it)."""
    return torch.zeros((1, snap.node_allocatable.shape[1]), dtype=torch.float32,
                       device=snap.device)


class NodeUnschedulable(PluginBase):
    """Excludes cordoned nodes (`spec.unschedulable`) unconditionally, as
    the reference does."""

    name = "NodeUnschedulable"

    def static_mask(self, ctx: CycleContext):
        snap = ctx.snap
        return (~snap.node_unschedulable)[None, :].expand(snap.P, snap.N)


class NodeName(PluginBase):
    name = "NodeName"

    def static_mask(self, ctx: CycleContext):
        snap = ctx.snap
        pinned = snap.pod_node_name[:, None]  # [P, 1]
        node_ids = torch.arange(snap.N, dtype=torch.int32, device=snap.device)
        mask = torch.where(pinned >= 0, node_ids[None, :] == pinned, True)
        return mask & (pinned != -2)  # named node unknown


class NodePorts(PluginBase):
    """hostPort conflicts: against EXISTING pods via the static mask, and
    against pods placed earlier in this cycle via an [N, Q] port-claim
    bitmap carried through the commit (Q = distinct pending ports)."""

    name = "NodePorts"

    def static_mask(self, ctx: CycleContext):
        snap = ctx.snap
        return ~ports_ops.ports_conflict_mask(snap.pod_ports, snap.node_used_ports)

    def extra_init(self, ctx: CycleContext):
        snap = ctx.snap
        return torch.zeros((snap.N, snap.num_distinct_ports), dtype=torch.bool,
                           device=snap.device)

    def dyn_mask(self, ctx: CycleContext, p, node_requested, extra):
        claimed = extra[self.name]  # [N, Q]
        ids = take_row(ctx.snap.pod_port_ids, p)  # [MPorts]
        want = claimed[:, ids.clamp(0, claimed.shape[1] - 1).long()]  # [N, MPorts]
        return ~(want & (ids >= 0)[None, :]).any(dim=1)

    def extra_update(self, ctx: CycleContext, extra, p, node, committed):
        ids = take_row(ctx.snap.pod_port_ids, p)
        Q = extra.shape[1]
        q = torch.arange(Q, device=ids.device)
        # the pod's claimed ports as one [Q] row (pad slots clamp onto
        # real ids, so a scatter of the slots would race with them)
        hit = ((q[None, :] == ids.clamp(0, Q - 1)[:, None])
               & (committed & (ids >= 0))[:, None]).any(dim=0)
        row = node.long().reshape(1)
        out = extra.clone()
        out.index_copy_(0, row, out.index_select(0, row) | hit[None, :])
        return out

    def dyn_mask_batched(self, ctx: CycleContext, node_requested, extra,
                         shared):
        return dyn_round.PortMask(ctx.snap.pod_port_ids, extra[self.name])

    def extra_update_batched(self, ctx: CycleContext, extra, accepted,
                             node_of):
        # the reference's `.at[].max` scatter as a scatter of True into a
        # flat [N * Q + 1] buffer whose last slot takes the pad entries:
        # no size is read from the device
        ids = ctx.snap.pod_port_ids  # [P, MPorts]
        N, Q = extra.shape
        add = accepted[:, None] & (ids >= 0)
        cell = node_of.clamp(0, N - 1).long()[:, None] * Q + ids.clamp(0, max(Q - 1, 0))
        flat = torch.cat([extra.reshape(-1), extra.new_zeros(1)])
        flat.index_fill_(0, torch.where(add, cell, N * Q).reshape(-1).long(), True)
        return flat[:N * Q].reshape(N, Q)


class NodeResourcesFit(PluginBase):
    """Filter: resource fit against the RUNNING requested state. Score:
    LeastAllocated (default) or MostAllocated."""

    name = "NodeResourcesFit"

    def _score(self, snap, pod_requested, node_requested):
        """The strategy's score as its factors (sum, 1 / weight sum), so
        that the runtime fuses the multiply into the score sum as the
        reference's compiled program does; over a snapshot's one resource
        the fraction and 100 (`commit.OneResourceFit`)."""
        most = self.args.get("scoring_strategy", "LeastAllocated") == "MostAllocated"
        weights = _score_resource_weights(snap, self.args)
        if dyn_round.one_resource_fit(snap.node_allocatable, weights):
            return OneResourceFit(res_ops.fit_fraction(
                pod_requested, snap.node_allocatable, node_requested, most)[..., 0],
                res_ops.MAX_NODE_SCORE)
        return Product(*res_ops.requested_score_factors(
            pod_requested, snap.node_allocatable, node_requested, weights, most=most))

    def dyn_mask(self, ctx: CycleContext, p, node_requested, extra):
        snap = ctx.snap
        return res_ops.fit_mask_single(
            take_row(snap.pod_requested, p), snap.node_allocatable, node_requested
        )

    def dyn_score(self, ctx: CycleContext, p, node_requested, extra, feasible):
        snap = ctx.snap
        return self._score(snap, take_row(snap.pod_requested, p), node_requested)

    def _batched_score(self, snap, pod_requested, node_requested):
        return dyn_round.FitScore(
            pod_requested, snap.node_allocatable, node_requested,
            _score_resource_weights(snap, self.args),
            self.args.get("scoring_strategy", "LeastAllocated") == "MostAllocated")

    def dyn_mask_batched(self, ctx: CycleContext, node_requested, extra,
                         shared):
        snap = ctx.snap
        return dyn_round.FitMask(snap.pod_requested, snap.node_allocatable,
                                 node_requested)

    def dyn_score_batched(self, ctx: CycleContext, node_requested, extra,
                          feasible, shared):
        return self._batched_score(ctx.snap, ctx.snap.pod_requested, node_requested)

    def score_node_anchor(self, ctx: CycleContext, node_requested):
        return self._batched_score(ctx.snap, ctx.get("zero_pod", _zero_pod), node_requested)


class NodeResourcesBalancedAllocation(PluginBase):
    name = "NodeResourcesBalancedAllocation"

    def dyn_score(self, ctx: CycleContext, p, node_requested, extra, feasible):
        # the factors of (1 - std) * 100, so that the runtime fuses the
        # multiply into the score sum as the reference's scan step does;
        # over one resource the constant 100 it folds to
        snap = ctx.snap
        if dyn_round.balanced_is_constant(snap.node_allocatable):
            return Constant((snap.N,), node_requested.device, res_ops.MAX_NODE_SCORE)
        return Product(res_ops.balanced_allocation_factor(
            take_row(snap.pod_requested, p), snap.node_allocatable, node_requested,
            _score_resource_weights(snap, self.args),
        ), res_ops.MAX_NODE_SCORE)

    def dyn_score_batched(self, ctx: CycleContext, node_requested, extra,
                          feasible, shared):
        snap = ctx.snap
        return dyn_round.BalancedScore(snap.pod_requested, snap.node_allocatable,
                                       node_requested,
                                       _score_resource_weights(snap, self.args))

    def score_node_anchor(self, ctx: CycleContext, node_requested):
        snap = ctx.snap
        return dyn_round.BalancedScore(ctx.get("zero_pod", _zero_pod), snap.node_allocatable,
                                       node_requested,
                                       _score_resource_weights(snap, self.args))


class NodeAffinity(PluginBase):
    name = "NodeAffinity"

    def static_mask(self, ctx: CycleContext):
        return labels_ops.pod_requirement_mask(ctx.snap, ctx.expr_node_mask,
                                               ctx.requirement_rows)

    def static_score(self, ctx: CycleContext):
        return labels_ops.preferred_score(ctx.snap, ctx.expr_node_mask)


class TaintToleration(PluginBase):
    name = "TaintToleration"

    def static_mask(self, ctx: CycleContext):
        return taints_ops.taint_filter_mask(ctx.snap)

    def static_score(self, ctx: CycleContext):
        return taints_ops.taint_score(ctx.snap)


class ImageLocality(PluginBase):
    name = "ImageLocality"

    def static_score(self, ctx: CycleContext):
        return images_ops.image_locality_score(ctx.snap)


class VolumeBinding(PluginBase):
    """PVC/PV feasibility (ops/volumes.py): bound-PV node affinity, static-
    PV candidacy and dynamic-provisioning topology for WaitForFirstConsumer
    claims, joint over a pod's slots. The static mask (K10) covers pre-
    cycle availability; a `pv_claimed` bitmap in the extra state carries
    the cycle's claims (K12 folds each round's placements into it) and the
    unbound residue (K10 again) re-checks unbound slots against it every
    round. Inert on snapshots without volumes."""

    name = "VolumeBinding"

    def static_mask(self, ctx: CycleContext):
        if not ctx.snap.has_volumes:
            return None
        return ctx.volume_kernels.volume_mask(ctx.snap, ctx.volume_tables, None, False)

    def _has_static_claims(self, snap) -> bool:
        # claim tracking matters only when volumes and static PVs exist
        return bool(snap.has_volumes and snap.pv_avail.shape[0] > 0)

    def extra_init(self, ctx: CycleContext):
        if not self._has_static_claims(ctx.snap):
            return None
        return torch.zeros((ctx.snap.pv_avail.shape[0],), dtype=torch.bool,
                           device=ctx.snap.device)

    def dyn_mask(self, ctx: CycleContext, p, node_requested, extra):
        # the scan step's row of the unbound residue (the batched form
        # would redo [P, N] work at each of P steps)
        if not self._has_static_claims(ctx.snap):
            return None
        return volumes_ops.volume_mask_unbound_row(
            ctx.snap, ctx.volume_tables, extra[self.name], p)

    def dyn_mask_batched(self, ctx: CycleContext, node_requested, extra,
                         shared):
        if not self._has_static_claims(ctx.snap):
            return None
        return ctx.volume_kernels.volume_mask(ctx.snap, ctx.volume_tables,
                                              extra[self.name], True)

    def extra_update(self, ctx: CycleContext, extra, p, node, committed):
        """One scan step's claims: slots in index order, a multi-volume pod
        by the SDR-safe choice, each claim seen by the next slot; a step
        that does not commit claims nothing."""
        if extra is None:
            return extra
        snap = ctx.snap
        tables = ctx.volume_tables
        V = extra.shape[0]
        multi = volumes_ops._multi(snap)
        claimed = extra
        pending = take_row(snap.pod_vol_mode, p) == 1  # [MVol]
        for t in range(snap.pod_vol_mode.shape[1]):
            if multi:
                ch = volumes_ops.chosen_pv_sdr_row(snap, tables, claimed, node, p, pending, t)
            else:
                ch = volumes_ops.chosen_pv_row(snap, tables, claimed, node, p, t)
            ch = torch.where(committed, ch, -1).reshape(1)
            at = ch.clamp(0, V - 1).long()
            claimed = claimed.index_copy(0, at, claimed.index_select(0, at) | (ch >= 0))
            pending = pending.clone()
            pending[t] = False
        return claimed

    def extra_update_batched(self, ctx: CycleContext, extra, accepted,
                             node_of):
        if extra is None:
            return extra
        # fixed-point fold, exact for any batch; under the rounds engine's
        # PV guard the batch is claim-disjoint and one pass suffices
        snap = ctx.snap
        return ctx.volume_kernels.pv_fold(snap, ctx.volume_tables, extra, accepted,
                                          node_of, snap.pod_order.to(torch.int32))


# --- shared affinity-state plumbing -----------------------------------------
# InterPodAffinity and PodTopologySpread both consume the per-(selector,
# domain) count state; whichever is initialized FIRST (filter order) owns
# the carried slot and maintains it, the other reads it.

_AFFINITY_OWNER_KEY = "__affinity_state_owner__"


def _claim_affinity_state(ctx: CycleContext, name: str):
    snap = ctx.snap
    if not (snap.has_inter_pod_affinity or snap.has_topology_spread):
        return None
    owner = ctx._cache.get(_AFFINITY_OWNER_KEY)
    if owner is not None and owner != name:
        return None  # someone else owns the slot
    ctx._cache[_AFFINITY_OWNER_KEY] = name
    return ctx.initial_affinity_state()


def _affinity_state(ctx: CycleContext, extra):
    return extra[ctx._cache[_AFFINITY_OWNER_KEY]]


def _update_affinity_state(ctx: CycleContext, name, state, p, node, committed):
    if ctx._cache.get(_AFFINITY_OWNER_KEY) != name:
        return state
    return interpod_ops.affinity_update(
        ctx.snap, state, ctx.matched_pending, p, node, committed
    )


def _update_affinity_state_batched(ctx: CycleContext, name, state, accepted,
                                   node_of):
    if ctx._cache.get(_AFFINITY_OWNER_KEY) != name:
        return state
    return ctx.kernels.affinity_update(
        ctx.snap, state, ctx.matched_pending, accepted, node_of
    )


def _shared_terms(ctx: CycleContext, state, shared):
    """The round's affinity and spread terms (K3), computed once and shared
    between InterPodAffinity and PodTopologySpread; `spread_minc` rides
    along once per round too."""
    if "interpod_terms" not in shared:
        snap = ctx.snap
        minc = None
        if snap.has_topology_spread:
            minc = shared["spread_minc"] = interpod_ops.spread_minc(snap, state)
        shared["interpod_terms"] = ctx.kernels.interpod_terms(
            snap, state, ctx.matched_pending, minc
        )
    return shared["interpod_terms"]


class InterPodAffinity(PluginBase):
    """Required and preferred inter-pod affinity and required anti-
    affinity, as counts over (selector, topology-domain) instead of pairwise
    pod comparisons (ops/interpod.py)."""

    name = "InterPodAffinity"

    def extra_init(self, ctx: CycleContext):
        return _claim_affinity_state(ctx, self.name)

    def dyn_mask(self, ctx: CycleContext, p, node_requested, extra):
        if not ctx.snap.has_inter_pod_affinity:
            return None
        return interpod_ops.affinity_dyn_mask(
            ctx.snap, _affinity_state(ctx, extra), ctx.matched_pending, p
        )

    def dyn_score(self, ctx: CycleContext, p, node_requested, extra, feasible):
        if not ctx.snap.has_inter_pod_affinity:
            return None
        return interpod_ops.affinity_dyn_score(
            ctx.snap, _affinity_state(ctx, extra), ctx.matched_pending, p, feasible
        )

    def extra_update(self, ctx: CycleContext, extra, p, node, committed):
        return _update_affinity_state(ctx, self.name, extra, p, node, committed)

    def dyn_mask_batched(self, ctx: CycleContext, node_requested, extra,
                         shared):
        if not ctx.snap.has_inter_pod_affinity:
            return None
        return _shared_terms(ctx, _affinity_state(ctx, extra), shared).aff_mask

    def dyn_score_batched(self, ctx: CycleContext, node_requested, extra,
                          feasible, shared):
        if not ctx.snap.has_inter_pod_affinity:
            return None
        terms = _shared_terms(ctx, _affinity_state(ctx, extra), shared)
        return ctx.kernels.interpod_norm(terms.aff_raw, feasible, False)

    def extra_update_batched(self, ctx: CycleContext, extra, accepted,
                             node_of):
        return _update_affinity_state_batched(
            ctx, self.name, extra, accepted, node_of
        )


class PodTopologySpread(PluginBase):
    name = "PodTopologySpread"

    def extra_init(self, ctx: CycleContext):
        return _claim_affinity_state(ctx, self.name)

    def dyn_mask(self, ctx: CycleContext, p, node_requested, extra):
        if not ctx.snap.has_topology_spread:
            return None
        return interpod_ops.spread_dyn_mask(ctx.snap, _affinity_state(ctx, extra), p)

    def dyn_score(self, ctx: CycleContext, p, node_requested, extra, feasible):
        if not ctx.snap.has_topology_spread:
            return None
        return interpod_ops.spread_dyn_score(
            ctx.snap, _affinity_state(ctx, extra), p, feasible
        )

    def extra_update(self, ctx: CycleContext, extra, p, node, committed):
        return _update_affinity_state(ctx, self.name, extra, p, node, committed)

    def dyn_mask_batched(self, ctx: CycleContext, node_requested, extra,
                         shared):
        if not ctx.snap.has_topology_spread:
            return None
        return _shared_terms(ctx, _affinity_state(ctx, extra), shared).spread_mask

    def dyn_score_batched(self, ctx: CycleContext, node_requested, extra,
                          feasible, shared):
        if not ctx.snap.has_topology_spread:
            return None
        terms = _shared_terms(ctx, _affinity_state(ctx, extra), shared)
        return ctx.kernels.interpod_norm(terms.spread_raw, feasible, True)

    def extra_update_batched(self, ctx: CycleContext, extra, accepted,
                             node_of):
        return _update_affinity_state_batched(
            ctx, self.name, extra, accepted, node_of
        )


class DefaultPreemption(PluginBase):
    """PostFilter: batched what-if preemption (ops/preemption.py), its three
    stages the context's `preemption_kernels` (K7-K9 by default).

    Config args: `budget` (candidates prefiltered per cycle, default 256)
    and `scan_budget` (nominations per cycle, default 64) — the per-cycle
    latency budgets; pods beyond them retry next cycle."""

    name = "DefaultPreemption"

    def post_filter(self, ctx: CycleContext, assignment, node_requested,
                    gate_rows, excluded=None):
        kw = {k: int(self.args[k]) for k in ("budget", "scan_budget")
              if k in self.args}
        stages = ctx.preemption_kernels
        return preemption_ops.run_preemption(
            ctx, assignment=assignment, node_requested=node_requested,
            gate_rows=gate_rows, excluded=excluded,
            prefilter_fn=stages.prefilter, whatif_fn=stages.whatif,
            claim_fn=stages.claim, **kw)
