"""The scheduling cycle (`k8s_scheduler_tpu/core/cycle.py`): a snapshot in,
placements out, on one device.

Per cycle, for the whole pending set:

    CycleContext precomputes -> VolumeBinding's static mask (K10
    `volume_mask`) -> static base (K1 `static_base`: static filters, static
    scores, node sampling) -> rounds engine: per round the inter-pod
    affinity / spread terms (K3 `interpod_terms`, `interpod_norm`) and the
    volumes' unbound residue (K10), per pass the claim (K2 `claim_pass`)
    and capacity resolution (K5 `capacity`), at round end the PV guard key
    (K11 `pv_choice`), the guard sweep (K6 `guard_sweep`), the affinity-
    state fold (K4 `affinity_update`) and the PV claim fold (K12
    `pv_fold`) -> gang unwind

and, when the cycle leaves pods unplaced, the PostFilter
(`build_preemption_fn`): DefaultPreemption's prefilter (K7
`preempt_prefilter`), non-resource what-if (K8 `preempt_whatif`) and
serial claim loop (K9 `preempt_claim`), a separate call so a cycle that
places every pod pays nothing for it; its static gate ANDs VolumeBinding's
static mask (K10) over the candidates.

The scan engine (`commit_mode="scan"`, the strict one-pod-at-a-time
ScheduleOne commit) replaces the rounds engine with one launch of K13
`scan_commit` over the same static base; volumes are not in it yet
(ROADMAP A8b).

This package builds the latency cycle of both engines
(`build_cycle_fn(commit_mode=..., outputs="latency")`), with inter-pod
affinity, topology spread and (rounds only) volumes, and preemption after
either. Full outputs (with `_pv_claimed_after_unwind`) and the carry/
packed/multi-cycle/arena builders are ROADMAP items A5, A7 and A9-A13."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..framework.interfaces import (AffinityKernels, CycleContext, PreemptionKernels,
                                    VolumeKernels)
from ..framework.runtime import Framework
from ..ops import affinity_update as affinity_update_ops
from ..ops import capacity as capacity_ops
from ..ops import claim_pass as claim_pass_ops
from ..ops import commit as commit_ops
from ..ops import guard_sweep as guard_sweep_ops
from ..ops import interpod_terms as interpod_terms_ops
from ..ops import preempt_claim as preempt_claim_ops
from ..ops import preempt_prefilter as preempt_prefilter_ops
from ..ops import preempt_whatif as preempt_whatif_ops
from ..ops import pv_choice as pv_choice_ops
from ..ops import pv_fold as pv_fold_ops
from ..ops import rounds as rounds_ops
from ..ops import scan_commit as scan_commit_ops
from ..ops import static_base as static_base_ops
from ..ops import volume_mask as volume_mask_ops
from ..ops.argsel import wrap_i32
from ..utils.device import resolve_device


@dataclasses.dataclass
class CycleDecision:
    """The latency-critical outputs of a cycle."""

    assignment: torch.Tensor  # i32 [P] node index or -1
    node_requested: torch.Tensor  # f32 [N, R] post-cycle
    unschedulable: torch.Tensor  # bool [P] valid pod that found no node
    gang_dropped: torch.Tensor  # bool [P] placed, then unwound
    placed_round: torch.Tensor  # i32 [P] rounds-engine round of each
    # placement (-1 unplaced or unwound); validity checks replay the rounds.
    # The scan engine reports 0 for every placement (the reference's
    # rounds_used is 0 in scan mode): its steps follow the queue rank


def sampling_window(snap, pct: int) -> tuple[torch.Tensor, int, int] | None:
    """percentageOfNodesToScore as a per-pod rotating window of candidate
    nodes: (offset i32 [P], window length k, modulus n) with node c a
    candidate of pod p iff (c - offset[p]) mod n < k; None when every node
    is a candidate (pct >= 100).

    Upstream numFeasibleNodesToFind semantics: k = n * pct / 100 (adaptive
    pct = max(50 - n/125, 5) when the knob is 0), floored at 100 nodes. The
    window rotates with the pod's queue rank and the cycle index."""
    if pct >= 100:
        return None
    n = int(snap.num_nodes)
    adaptive = max(50 - n // 125, 5) if pct <= 0 else pct
    k = max(n * adaptive // 100, 100)
    mod = max(n, 1)
    off = wrap_i32(
        snap.pod_order.to(torch.int64) * 75347
        + int(snap.cycle_index) * 31337
    ) % mod
    return off.to(torch.int32), k, mod


def sampling_mask(snap, pct: int) -> torch.Tensor:
    """bool [P, N] form of `sampling_window` (the reference's
    `sampling_mask`)."""
    win = sampling_window(snap, pct)
    if win is None:
        return torch.ones((snap.P, snap.N), dtype=torch.bool, device=snap.device)
    off, k, mod = win
    col = torch.arange(snap.N, dtype=torch.int32, device=snap.device)[None, :]
    return ((col - off[:, None]) % mod) < k


def _gang_unwind(snap, assignment, node_requested):
    """All-or-nothing gang rollback: groups whose placed-this-cycle count
    plus already-running members stays below minMember get every
    this-cycle placement unwound. Returns (assignment, node_requested,
    dropped bool [P])."""
    placed = snap.pod_valid & (assignment >= 0)
    G = snap.group_min_member.shape[0]
    gid = snap.pod_group.clamp(0, G - 1).long()
    in_group = snap.pod_group >= 0
    counts = snap.group_existing_count.clone()
    counts.index_add_(0, gid, (in_group & placed).to(counts.dtype))
    fail = counts < snap.group_min_member
    dropped = in_group & fail[gid] & placed
    res = commit_ops.unwind_assignments(
        commit_ops.CommitResult(assignment, node_requested, None), dropped,
        snap.pod_requested)
    return res.assignment, res.node_requested, dropped


def build_cycle_fn(
    framework: Framework | None = None,
    gang_scheduling: bool = True,
    commit_mode: str = "scan",
    max_rounds: int = 64,
    percentage_of_nodes_to_score: int = 0,  # 0 = adaptive (upstream default)
    rounds_kw: dict | None = None,  # compact / passes / passes_round0
    outputs: str = "latency",
    device=None,
    static_base_fn: Callable = static_base_ops.static_base,
    claim_pass_fn: Callable = claim_pass_ops.claim_pass,
    interpod_terms_fn: Callable = interpod_terms_ops.interpod_terms,
    interpod_norm_fn: Callable = interpod_terms_ops.interpod_norm,
    affinity_update_fn: Callable = affinity_update_ops.affinity_update,
    capacity_fn: Callable = capacity_ops.capacity,
    guard_sweep_fn: Callable = guard_sweep_ops.guard_sweep,
    volume_mask_fn: Callable = volume_mask_ops.volume_mask,
    pv_choice_fn: Callable = pv_choice_ops.pv_choice,
    pv_fold_fn: Callable = pv_fold_ops.pv_fold,
    scan_commit_fn: Callable = scan_commit_ops.scan_commit,
) -> Callable:
    """The cycle for a framework (default: the default plugin set) on one
    device: `cycle(snapshot) -> CycleDecision`.

    `device` None means the card (raises without one). The default
    kernel functions (`static_base_fn`, `claim_pass_fn`, `interpod_terms_fn`,
    `interpod_norm_fn`, `affinity_update_fn`, `capacity_fn`,
    `guard_sweep_fn`, `volume_mask_fn`, `pv_choice_fn`, `pv_fold_fn`,
    `scan_commit_fn`) run the hand-written kernels on CUDA and their plain
    torch versions on CPU; passing the plain versions (`*_plain`) runs them
    on the card too — the run the kernels are held against.

    `commit_mode` "scan" (the default, as in the reference) runs the strict
    sequential engine: K1, then K13 `scan_commit` once. "rounds" runs the
    rounds engine, the one serving runs (`config/types.py` commitMode): K1,
    then per round K3/K10, K2 and K5 per pass, K11/K6/K4/K12 at round end.
    `outputs` stays "latency" here where the reference defaults to "full"
    (ROADMAP A9). Placements follow the reference's engine of the same name:
    bit-equal assignment / node_requested / unschedulable / gang_dropped
    (held by tests/test_torch_cycle*.py)."""
    if commit_mode not in ("rounds", "scan"):
        raise ValueError(f"commit_mode {commit_mode!r}: 'rounds' or 'scan'")
    if outputs != "latency":
        raise NotImplementedError(
            f"outputs {outputs!r}: only the latency outputs are ported "
            "(diagnosis outputs are ROADMAP A9)"
        )
    kw = dict(rounds_kw or {})
    unknown = set(kw) - {"compact", "passes", "passes_round0"}
    if unknown:
        raise NotImplementedError(f"rounds options not ported: {sorted(unknown)}")
    dev = resolve_device(device)
    fw = framework or Framework.from_config()
    kernels = AffinityKernels(interpod_terms_fn, interpod_norm_fn,
                              affinity_update_fn)
    vkernels = VolumeKernels(volume_mask_fn, pv_choice_fn, pv_fold_fn)

    def cycle(snap) -> CycleDecision:
        if snap.device.type != dev.type:
            raise ValueError(
                f"snapshot on {snap.device}, cycle built for {dev}"
            )
        ctx = CycleContext(snap, kernels, volume_kernels=vkernels)
        if commit_mode == "scan":
            return scan_cycle(snap, ctx)
        sbase = static_base_fn(static_base_ops.static_base_inputs(
            fw, ctx, fit=True,
            sampling=sampling_window(snap, percentage_of_nodes_to_score),
        ))
        extra = fw.extra_init(ctx)

        def dyn_batched_view_fn(vsnap, vmp, node_req, ext, vsmask):
            return fw.dyn_batched(ctx.view(vsnap, vmp), node_req, ext, vsmask)

        def update_batched_view_fn(vsnap, vmp, ext, accepted, node_of):
            return fw.extra_update_batched(
                ctx.view(vsnap, vmp), ext, accepted, node_of
            )

        rres = rounds_ops.rounds_commit(
            snap=snap,
            sbase=sbase,
            m_pending=ctx.matched_pending,
            dyn_batched_view_fn=dyn_batched_view_fn,
            update_batched_view_fn=update_batched_view_fn,
            extra=extra,
            max_rounds=max_rounds,
            score_anchor_fn=lambda nr: fw.score_anchor(ctx, nr),
            claim_pass_fn=claim_pass_fn,
            capacity_fn=capacity_fn,
            guard_sweep_fn=guard_sweep_fn,
            pv_choice_fn=_make_pv_choice_fn(ctx),
            **kw,
        )
        assignment, node_req = rres.assignment, rres.node_requested
        dropped = torch.zeros_like(snap.pod_valid)
        if gang_scheduling:
            assignment, node_req, dropped = _gang_unwind(snap, assignment, node_req)
        unsched = snap.pod_valid & (assignment < 0)
        placed_round = torch.where(assignment >= 0, rres.placed_round, -1)
        return CycleDecision(assignment, node_req, unsched, dropped, placed_round)

    def scan_cycle(snap, ctx) -> CycleDecision:
        if snap.has_volumes and any(f.name == "VolumeBinding" for f in fw.filters):
            raise NotImplementedError(
                "commit_mode 'scan' on a snapshot with volumes: VolumeBinding's "
                "per-pod hooks are ROADMAP A8b (the rounds engine covers volumes)")
        # K1's fit test against the cycle-start state only removes nodes the
        # scan's fit test would reject at every step (node_requested only
        # grows during the scan); its clip to +-1e6 is the identity on the
        # default plugins' static scores (held by tests/test_torch_commit.py)
        sbase = static_base_fn(static_base_ops.static_base_inputs(
            fw, ctx, fit=True,
            sampling=sampling_window(snap, percentage_of_nodes_to_score),
        ))
        res = scan_commit_fn(scan_commit_ops.scan_commit_inputs(
            fw, ctx, sbase, fw.extra_init(ctx)))
        assignment, node_req = res.assignment, res.node_requested
        dropped = torch.zeros_like(snap.pod_valid)
        if gang_scheduling:
            assignment, node_req, dropped = _gang_unwind(snap, assignment, node_req)
        unsched = snap.pod_valid & (assignment < 0)
        placed_round = torch.where(assignment >= 0, 0, -1).to(torch.int32)
        return CycleDecision(assignment, node_req, unsched, dropped, placed_round)

    return cycle


def _make_pv_choice_fn(ctx: CycleContext) -> Callable | None:
    """The rounds engine's PV guard hook: the PV per (claimant, slot)
    against the live claim bitmap in VolumeBinding's extra state (K11).
    None when the snapshot has no volumes."""
    if not ctx.snap.has_volumes:
        return None

    def pv_choice_fn(vsnap, node_of, live, ext_state):
        claimed = ext_state.get("VolumeBinding")
        if claimed is None:  # plugin disabled in this profile
            return torch.full((node_of.shape[0], vsnap.pod_vol_mode.shape[1]), -1,
                              dtype=torch.int32, device=node_of.device)
        return ctx.volume_kernels.pv_choice(vsnap, ctx.volume_tables, claimed,
                                            node_of, live)

    return pv_choice_fn


def _preemption_gate_rows(fw: Framework, ctx: CycleContext) -> Callable:
    """Per-candidate static gate for preemption: every static filter EXCEPT
    NodePorts (conflicts with running pods' ports are exactly what eviction
    can free; the what-if checks them per victim prefix), on the pod view of
    the candidates. Returns gate_rows(ids i32 [C]) -> bool [C, N]."""

    def gate_rows(ids):
        snap = ctx.snap
        vctx = CycleContext(rounds_ops._pod_view(snap, ids), ctx.kernels,
                            ctx.preemption_kernels, ctx.volume_kernels)
        vctx._cache.update(ctx._cache)
        base = snap.node_valid[None, :].expand(ids.shape[0], snap.N)
        for f in fw.filters:
            if f.name == "NodePorts":
                continue
            m = f.static_mask(vctx)
            if m is not None:
                base = base & m
        return base

    return gate_rows


def build_preemption_fn(
    framework: Framework | None = None,
    device=None,
    prefilter_fn: Callable = preempt_prefilter_ops.preempt_prefilter,
    whatif_fn: Callable = preempt_whatif_ops.preempt_whatif,
    claim_fn: Callable = preempt_claim_ops.preempt_claim,
    volume_mask_fn: Callable = volume_mask_ops.volume_mask,
) -> Callable | None:
    """The PostFilter pass, called with the cycle's decision when pods stay
    unplaced: `post_filter(snapshot, decision) -> PreemptionResult`
    (nominated i32 [P], victims bool [E], num_preemptors i32 []). None when
    no PostFilter plugin is enabled.

    `device` None means the card. The default stage functions run K7-K9
    (and K10 for VolumeBinding's part of the static gate) on CUDA and their
    plain versions on CPU; passing the plain versions
    (`preemption.prefilter_plain`, `nonresource_ok_plain`,
    `claim_loop_plain`, `volumes.volume_mask_plain`) runs them on the card
    too. Results are bit-equal to
    the reference's `build_preemption_fn` on the same snapshot and decision
    (held by tests/test_torch_preemption.py)."""
    dev = resolve_device(device)
    fw = framework or Framework.from_config()
    if not fw.post_filters:
        return None
    stages = PreemptionKernels(prefilter_fn, whatif_fn, claim_fn)

    def post_filter(snap, decision):
        if snap.device.type != dev.type:
            raise ValueError(
                f"snapshot on {snap.device}, preemption built for {dev}"
            )
        ctx = CycleContext(snap, preemption_kernels=stages,
                           volume_kernels=VolumeKernels(volume_mask=volume_mask_fn))
        return fw.post_filter(
            ctx, decision.assignment, decision.node_requested,
            _preemption_gate_rows(fw, ctx), excluded=decision.gang_dropped,
        )

    return post_filter
