"""The default plugin set (`k8s_scheduler_tpu/framework/plugins.py`).

Ported: NodeUnschedulable, NodeName, NodePorts, NodeResourcesFit,
NodeResourcesBalancedAllocation, NodeAffinity, TaintToleration and
ImageLocality. InterPodAffinity, PodTopologySpread, VolumeBinding and
DefaultPreemption are in the default set but not ported yet: each is
inert exactly where the reference's is (its capability flag is off) and
raises NotImplementedError naming its ROADMAP item where it would act,
so it can never return a wrong answer."""

from __future__ import annotations

import torch

from ..ops import images as images_ops
from ..ops import labels as labels_ops
from ..ops import ports as ports_ops
from ..ops import resources as res_ops
from ..ops import taints as taints_ops
from .interfaces import CycleContext, PluginBase


def _not_ported(plugin: str, what: str, item: str):
    return NotImplementedError(
        f"{plugin}: {what} is not ported to the torch package yet "
        f"(ROADMAP {item})"
    )


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
        return labels_ops.pod_requirement_mask(ctx.snap, ctx.expr_node_mask)

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
    """PVC/PV feasibility: inert on snapshots without volumes."""

    name = "VolumeBinding"

    def _check(self, ctx: CycleContext):
        if ctx.snap.has_volumes:
            raise _not_ported(self.name, "PVC/PV binding", "A4")

    def static_mask(self, ctx: CycleContext):
        self._check(ctx)
        return None

    def extra_init(self, ctx: CycleContext):
        self._check(ctx)
        return None

    def dyn_mask_batched(self, ctx: CycleContext, node_requested, extra,
                         shared):
        self._check(ctx)
        return None


class _AffinityStatePlugin(PluginBase):
    """InterPodAffinity / PodTopologySpread: both consume the reference's
    per-(selector, domain) count state, which exists only when a snapshot
    carries affinity or spread terms."""

    flag = ""
    item = "A4"

    def _active(self, snap) -> bool:
        return bool(getattr(snap, self.flag))

    def extra_init(self, ctx: CycleContext):
        snap = ctx.snap
        if snap.has_inter_pod_affinity or snap.has_topology_spread:
            raise _not_ported(self.name, "the affinity count state", self.item)
        return None

    def dyn_mask_batched(self, ctx: CycleContext, node_requested, extra,
                         shared):
        if self._active(ctx.snap):
            raise _not_ported(self.name, "the batched mask", self.item)
        return None

    def dyn_score_batched(self, ctx: CycleContext, node_requested, extra,
                          feasible, shared):
        if self._active(ctx.snap):
            raise _not_ported(self.name, "the batched score", self.item)
        return None


class InterPodAffinity(_AffinityStatePlugin):
    name = "InterPodAffinity"
    flag = "has_inter_pod_affinity"


class PodTopologySpread(_AffinityStatePlugin):
    name = "PodTopologySpread"
    flag = "has_topology_spread"


class DefaultPreemption(PluginBase):
    """PostFilter: batched what-if preemption. The latency cycle of this
    slice never runs PostFilter; preemption is ROADMAP item A6."""

    name = "DefaultPreemption"

    def post_filter(self, ctx: CycleContext, *args, **kwargs):
        raise _not_ported(self.name, "preemption", "A6")
