"""The default plugin set (`k8s_scheduler_tpu/framework/plugins.py`).

Ported: NodeUnschedulable, NodeName, NodePorts, NodeResourcesFit,
NodeResourcesBalancedAllocation, NodeAffinity, TaintToleration,
ImageLocality, VolumeBinding, InterPodAffinity, PodTopologySpread and
DefaultPreemption, with their batched hooks (the rounds engine's); the
per-pod hooks of the scan engine are ROADMAP A8."""

from __future__ import annotations

import torch

from ..ops import images as images_ops
from ..ops import interpod as interpod_ops
from ..ops import labels as labels_ops
from ..ops import ports as ports_ops
from ..ops import preemption as preemption_ops
from ..ops import resources as res_ops
from ..ops import taints as taints_ops
from .interfaces import CycleContext, PluginBase


def _score_resource_weights(snap, args: dict) -> tuple[float, ...]:
    """score_resources arg -> one-hot [R] weights (cpu+memory by default)."""
    score_resources = args.get("score_resources", ("cpu", "memory"))
    w = [0.0] * len(snap.resource_names)
    for r in score_resources:
        if r in snap.resource_names:
            w[snap.resource_names.index(r)] = 1.0
    return tuple(w)


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
    bitmap carried through the rounds (Q = distinct pending ports)."""

    name = "NodePorts"

    def static_mask(self, ctx: CycleContext):
        snap = ctx.snap
        return ~ports_ops.ports_conflict_mask(snap.pod_ports, snap.node_used_ports)

    def extra_init(self, ctx: CycleContext):
        snap = ctx.snap
        return torch.zeros((snap.N, snap.num_distinct_ports), dtype=torch.bool,
                           device=snap.device)

    @staticmethod
    def _port_onehot(snap) -> torch.Tensor:  # bool [P, Q]
        Q = snap.num_distinct_ports
        ids = snap.pod_port_ids  # [P, MPorts]
        oh = torch.zeros((snap.P, Q), dtype=torch.bool, device=snap.device)
        rows, slots = torch.nonzero(ids >= 0, as_tuple=True)
        oh[rows, ids[rows, slots].long()] = True
        return oh

    def dyn_mask_batched(self, ctx: CycleContext, node_requested, extra,
                         shared):
        snap = ctx.snap
        claimed = extra[self.name]  # [N, Q]
        if "port_onehot" not in shared:
            shared["port_onehot"] = self._port_onehot(snap)
        oh = shared["port_onehot"]
        # 0/1 products with small sums: exact in f32
        conflict = (oh.to(torch.float32) @ claimed.T.to(torch.float32)) > 0.0
        return ~conflict

    def extra_update_batched(self, ctx: CycleContext, extra, accepted,
                             node_of):
        ids = ctx.snap.pod_port_ids  # [P, MPorts]
        add = accepted[:, None] & (ids >= 0)
        rows, slots = torch.nonzero(add, as_tuple=True)
        out = extra.clone()
        out[node_of[rows].long(), ids[rows, slots].long()] = True
        return out


class NodeResourcesFit(PluginBase):
    """Filter: resource fit against the RUNNING requested state. Score:
    LeastAllocated (default) or MostAllocated."""

    name = "NodeResourcesFit"

    def _strategy_fn(self):
        strategy = self.args.get("scoring_strategy", "LeastAllocated")
        return (
            res_ops.most_requested_score
            if strategy == "MostAllocated"
            else res_ops.least_requested_score
        )

    def dyn_mask_batched(self, ctx: CycleContext, node_requested, extra,
                         shared):
        snap = ctx.snap
        return res_ops.fit_mask(
            snap.pod_requested, snap.node_allocatable, node_requested
        )

    def dyn_score_batched(self, ctx: CycleContext, node_requested, extra,
                          feasible, shared):
        snap = ctx.snap
        return self._strategy_fn()(
            snap.pod_requested[:, None, :],
            snap.node_allocatable,
            node_requested,
            _score_resource_weights(snap, self.args),
        )

    def score_node_anchor(self, ctx: CycleContext, node_requested):
        snap = ctx.snap
        return self._strategy_fn()(
            torch.zeros((1, 1), dtype=torch.float32, device=snap.device),
            snap.node_allocatable,
            node_requested,
            _score_resource_weights(snap, self.args),
        )


class NodeResourcesBalancedAllocation(PluginBase):
    name = "NodeResourcesBalancedAllocation"

    def dyn_score_batched(self, ctx: CycleContext, node_requested, extra,
                          feasible, shared):
        snap = ctx.snap
        return res_ops.balanced_allocation_score(
            snap.pod_requested[:, None, :], snap.node_allocatable,
            node_requested, _score_resource_weights(snap, self.args),
        )

    def score_node_anchor(self, ctx: CycleContext, node_requested):
        snap = ctx.snap
        return res_ops.balanced_allocation_score(
            torch.zeros((1, 1), dtype=torch.float32, device=snap.device),
            snap.node_allocatable, node_requested,
            _score_resource_weights(snap, self.args),
        )


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

    def dyn_mask_batched(self, ctx: CycleContext, node_requested, extra,
                         shared):
        if not self._has_static_claims(ctx.snap):
            return None
        return ctx.volume_kernels.volume_mask(ctx.snap, ctx.volume_tables,
                                              extra[self.name], True)

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
