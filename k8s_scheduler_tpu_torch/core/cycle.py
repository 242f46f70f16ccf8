"""The scheduling cycle (`k8s_scheduler_tpu/core/cycle.py`): a snapshot in,
placements out, on one device.

Per cycle, for the whole pending set:

    CycleContext precomputes -> VolumeBinding's static mask (K10
    `volume_mask`) -> static base (K1 `static_base`: static filters, static
    scores, node sampling) -> rounds engine: per round the inter-pod
    affinity / spread terms (K3 `interpod_terms`, `interpod_norm`), the
    volumes' unbound residue (K10) and the dynamic masks and claim base
    (K14 `dyn_mask`, K15 `dyn_score`), per pass the claim (K2 `claim_pass`)
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
`scan_commit` over the same static base, VolumeBinding's per-pod hooks
included (the unbound residue against the claim bitmap, which the kernel
keeps in each CTA's shared memory, and each placement's claims).

This package builds the cycle of both engines, with inter-pod affinity,
topology spread and volumes, and preemption after either:
its latency outputs (`outputs="latency"`, a `CycleDecision`) and its full
outputs (`outputs="full"`, the default as in the reference: a
`CycleResult` with the per-filter reject counts, the PV claim bitmap and
the rounds engine's convergence counters; the static attribution by K16
`static_rejects`, the dynamic one by K17 `dyn_rejects` over the rounds
cycle's final window of unplaced pods or by K13's full mode at every scan
step). Then the device-carry latency path that serving runs (reference
`core/cycle.py:1050-1583`): a packed frame (`SnapshotEncoder.
encode_packed`, `models/packing.py`), the stable tables
(`build_stable_state_fn`), the [P, N] static base and [S, P] matched-
pending carried on the device and updated for the changed pod rows only
(`build_carry_fns`, `CarryKeeper`: K1 at the dirty bucket's row count),
the rounds cycle over the carry (`build_packed_cycle_carry_fn`),
preemption on the packed frame (`build_packed_preemption_fn`) and the
off-path diagnosis program (`build_diagnosis_fn`: every unplaced pod's
FailedScheduling attribution, K16 and K17 over windows of them). The
packed full cycle `build_packed_cycle_fn` (what serving runs when the
carry path is off: the scan engine) and the `_Resilient` retry wrapper
with its failure classes (`classify_failure`) serve the `Scheduler`
(`core/scheduler.py`). HTTP-extender verdicts enter the fresh cycle
through the snapshot (`pod_extender_mask` / `pod_extender_score`: K1's
extender operands), the carry cycle and the diagnosis program through
device planes that `ExtenderVerdictKeeper` keeps (K18 `extender_merge`
over the carried base; K16's per-pod base). The multi-cycle / arena
builders are ROADMAP items A11-A13."""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..framework.interfaces import (AffinityKernels, CycleContext, DynKernels,
                                    PreemptionKernels, VolumeKernels)
from ..framework.runtime import Framework
from ..ops import affinity_update as affinity_update_ops
from ..ops import capacity as capacity_ops
from ..ops import claim_pass as claim_pass_ops
from ..ops import commit as commit_ops
from ..ops import dyn_round as dyn_round_ops
from ..ops import extender_merge as extender_merge_ops
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


@dataclasses.dataclass
class CycleResult:
    """The full outputs of a cycle (the reference's `CycleResult`), and the
    port's `placed_round`."""

    assignment: torch.Tensor  # i32 [P] node index or -1
    node_requested: torch.Tensor  # f32 [N, R] post-cycle
    unschedulable: torch.Tensor  # bool [P] valid pod that found no node
    gang_dropped: torch.Tensor  # bool [P] placed, then unwound
    reject_counts: torch.Tensor  # i32 [P, F] nodes first rejected per filter,
    # static + dynamic (columns `Framework.filter_names`); zeros from the
    # carry cycle, whose attribution is the diagnosis program's
    pv_claimed: torch.Tensor  # bool [V] static PVs claimed by the placements
    rounds_used: torch.Tensor  # i32 [] rounds run (0 in scan mode)
    accepted_per_round: torch.Tensor  # i32 [max_rounds] (zeros in scan mode)
    diag_per_round: torch.Tensor  # i32 [max_rounds, 3] a round's (live
    # claims, capacity rejections, guard revocations), summed over passes
    placed_round: torch.Tensor  # i32 [P] as CycleDecision's


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


def sampling_params(snap, pct: int):
    """`sampling_window` on the device: (offset i32 [P], window length i64
    [], modulus i64 []) computed from the snapshot's node count and cycle
    index (no host sync); None when every node is a candidate."""
    if pct >= 100:
        return None
    n = snap.num_nodes.to(torch.int64)
    adaptive = torch.clamp(50 - n // 125, min=5) if pct <= 0 else pct
    k = torch.clamp(n * adaptive // 100, min=100)
    mod = torch.clamp(n, min=1)
    off = wrap_i32(
        snap.pod_order.to(torch.int64) * 75347
        + snap.cycle_index.to(torch.int64) * 31337
    ) % mod
    return off.to(torch.int32), k, mod


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


# failure signatures of a device or dispatch error (the reference's
# classes, `core/cycle.py:206-265`): a transport flake of a remote dispatch
# (nothing corrupted: re-invoke), and a wedged device — on the card CUDA's
# sticky errors, which leave the process's context unusable until a
# restart (the reference's wedge: fail fast). The reference's third class,
# a corrupt cached XLA executable, has no counterpart here.
_WEDGE_MARKERS = (
    "illegal memory access",
    "unspecified launch failure",
    "device-side assert",
)
_TRANSPORT_MARKERS = (
    "remote_compile",
    "remote_execute",
    "response body closed",
    "read body",
    "connection reset",
    "broken pipe",
    "connection refused",
    "unexpected eof",
)


def is_transport_error(e: BaseException) -> bool:
    """True when `e` looks like a transport flake (retryable) rather than
    a program error."""
    msg = str(e).lower()
    return any(m in msg for m in _TRANSPORT_MARKERS)


def classify_failure(e: BaseException) -> str:
    """Failure class of a device/dispatch error, by the precedence
    `_Resilient` recovers with: transport, then wedge, else other. Feeds
    `scheduler_fetch_failures_total{class}` and the degradation ladder's
    transition reasons."""
    if is_transport_error(e):
        return "transport"
    if any(m in str(e) for m in _WEDGE_MARKERS):
        return "wedge"
    return "other"


# per-process strike log: (program name, kind) -> count, mirrored into
# global_metrics()'s scheduler_program_retry_strikes_total
RESILIENT_STRIKES: dict[tuple[str, str], int] = {}


def _record_strike(program: str, kind: str) -> None:
    key = (program, kind)
    RESILIENT_STRIKES[key] = RESILIENT_STRIKES.get(key, 0) + 1
    try:
        from ..metrics.metrics import global_metrics

        global_metrics().program_retry_strikes.labels(program=program, kind=kind).inc()
    except Exception:
        # the strike itself is the trace; a broken registry must not break
        # the serving path it observes
        pass


class _Resilient:
    """Retry wrapper for a built program (reference `core/cycle.py:273`),
    around a plain callable: a transport flake re-invokes after a short
    backoff (at most three attempts); a wedge records its strike and
    raises at once; anything else raises. Every strike is counted in
    `RESILIENT_STRIKES`."""

    def __init__(self, fn: Callable, name: str) -> None:
        self._fn = fn
        self.__name__ = name

    def __call__(self, *a, **k):
        for attempt in range(3):
            try:
                return self._fn(*a, **k)
            except Exception as e:
                cls = classify_failure(e)
                if cls == "wedge":
                    _record_strike(self.__name__, "backend_wedge")
                if cls != "transport" or attempt == 2:
                    raise
                _record_strike(self.__name__, "transport")
                import time

                time.sleep(0.5 * (attempt + 1))


def build_cycle_fn(
    framework: Framework | None = None,
    gang_scheduling: bool = True,
    commit_mode: str = "scan",
    max_rounds: int = 64,
    percentage_of_nodes_to_score: int = 0,  # 0 = adaptive (upstream default)
    rounds_kw: dict | None = None,  # compact / passes / passes_round0
    outputs: str = "full",  # "full" -> CycleResult, "latency" -> CycleDecision
    device=None,
    static_base_fn: Callable = static_base_ops.static_base,
    static_rejects_fn: Callable = static_base_ops.static_rejects,
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
    dyn_mask_fn: Callable = dyn_round_ops.dyn_mask,
    dyn_score_fn: Callable = dyn_round_ops.dyn_score,
    dyn_rejects_fn: Callable = dyn_round_ops.dyn_rejects,
) -> Callable:
    """The cycle for a framework (default: the default plugin set) on one
    device: `cycle(snapshot, stable=None) -> CycleResult`
    (`outputs="full"`, the default, as in the reference) or
    `CycleDecision` (`"latency"`); `stable`, the output of
    `build_stable_state_fn` for the snapshot's frame, seeds the context's
    stable tables instead of computing them again.

    `device` None means the card (raises without one). The default
    kernel functions (`static_base_fn`, `claim_pass_fn`, `interpod_terms_fn`,
    `interpod_norm_fn`, `affinity_update_fn`, `capacity_fn`,
    `guard_sweep_fn`, `volume_mask_fn`, `pv_choice_fn`, `pv_fold_fn`,
    `scan_commit_fn`, `dyn_mask_fn`, `dyn_score_fn`, and for the full
    outputs `static_rejects_fn`, `dyn_rejects_fn`) run the hand-written
    kernels on CUDA and their plain
    torch versions on CPU; passing the plain versions (`*_plain`) runs them
    on the card too — the run the kernels are held against.

    `commit_mode` "scan" (the default, as in the reference) runs the strict
    sequential engine: K1, then K13 `scan_commit` once. "rounds" runs the
    rounds engine, the one serving runs (`config/types.py` commitMode): K1,
    then per round K3/K10 and K14/K15 (the dynamic masks and the claim
    base), K2 and K5 per pass (K15 also for the score anchor),
    K11/K6/K4/K12 at round end.
    The full outputs add, after the decisions: K16 over every pod row for
    the static attribution; in the rounds engine K17 over the final window
    of unplaced pods (`compact_window(P)` of them, preemption-eligible ones
    first by rank, against the final state, from their sampled static
    mask: K1 on the window's rows) for the dynamic one, in the scan K13's
    full mode (its static base then without the fit test); and the claim
    bitmap of the surviving placements. Placements follow the reference's
    engine of the same name and do not depend on `outputs`: bit-equal
    assignment / node_requested / unschedulable / gang_dropped, and the
    full outputs bit-equal to the reference's (held by
    tests/test_torch_cycle*.py and tests/test_torch_diagnosis.py)."""
    if commit_mode not in ("rounds", "scan"):
        raise ValueError(f"commit_mode {commit_mode!r}: 'rounds' or 'scan'")
    if outputs not in ("full", "latency"):
        raise ValueError(f"outputs {outputs!r}: 'full' or 'latency'")
    lean = outputs == "latency"
    kw = dict(rounds_kw or {})
    unknown = set(kw) - {"compact", "passes", "passes_round0"}
    if unknown:
        raise NotImplementedError(f"rounds options not ported: {sorted(unknown)}")
    dev = resolve_device(device)
    fw = framework or Framework.from_config()
    kernels = AffinityKernels(interpod_terms_fn, interpod_norm_fn,
                              affinity_update_fn)
    vkernels = VolumeKernels(volume_mask_fn, pv_choice_fn, pv_fold_fn)
    dkernels = DynKernels(dyn_mask_fn, dyn_score_fn, dyn_rejects_fn)
    engine = dict(kw, claim_pass_fn=claim_pass_fn, capacity_fn=capacity_fn,
                  guard_sweep_fn=guard_sweep_fn)
    pct = percentage_of_nodes_to_score

    def cycle(snap, stable=None):
        if snap.device.type != dev.type:
            raise ValueError(
                f"snapshot on {snap.device}, cycle built for {dev}"
            )
        ctx = CycleContext(snap, kernels, volume_kernels=vkernels,
                           dyn_kernels=dkernels)
        if stable is not None:
            # the stable tables (build_stable_state_fn) seed the context
            # instead of being computed again
            ctx._cache.update(stable)
        if commit_mode == "scan":
            return scan_cycle(snap, ctx)
        x = static_base_ops.static_base_inputs(fw, ctx, fit=True,
                                               sampling=sampling_window(snap, pct))
        d, rres = _rounds_decision(fw, ctx, static_base_fn(x), gang_scheduling, max_rounds,
                                   engine)
        if lean:
            return d
        srej = static_rejects_fn(static_base_ops.reject_inputs(x))
        dyn_aux = _final_window_rejects(fw, ctx, rres, pct, static_base_fn)
        return CycleResult(
            d.assignment, d.node_requested, d.unschedulable, d.gang_dropped,
            reject_counts=srej + dyn_aux,
            pv_claimed=_pv_claimed_after_unwind(snap, ctx, rres.extra, d.assignment,
                                                d.gang_dropped),
            rounds_used=rres.rounds_used, accepted_per_round=rres.accepted_per_round,
            diag_per_round=rres.diag_per_round, placed_round=d.placed_round)

    def scan_cycle(snap, ctx):
        # K1's fit test against the cycle-start state only removes nodes the
        # scan's fit test would reject at every step (node_requested only
        # grows during the scan); no clip, as the reference's scan takes the
        # static score (with the extenders' added) as it is. The full
        # outputs leave the fit test to the scan: the reference counts
        # those nodes under NodeResourcesFit at every step
        x = static_base_ops.static_base_inputs(fw, ctx, fit=lean, clip=False,
                                               sampling=sampling_window(snap, pct))
        res = scan_commit_fn(scan_commit_ops.scan_commit_inputs(
            fw, ctx, static_base_fn(x), fw.extra_init(ctx), rejects=not lean))
        assignment, node_req = res.assignment, res.node_requested
        dropped = torch.zeros_like(snap.pod_valid)
        if gang_scheduling:
            assignment, node_req, dropped = _gang_unwind(snap, assignment, node_req)
        unsched = snap.pod_valid & (assignment < 0)
        placed_round = torch.where(assignment >= 0, 0, -1).to(torch.int32)
        if lean:
            return CycleDecision(assignment, node_req, unsched, dropped, placed_round)
        srej = static_rejects_fn(static_base_ops.reject_inputs(x))
        i32 = torch.int32
        return CycleResult(
            assignment, node_req, unsched, dropped,
            reject_counts=srej + res.rejects,
            pv_claimed=_pv_claimed_after_unwind(
                snap, ctx, {} if res.pv_claimed is None else {"VolumeBinding": res.pv_claimed},
                assignment, dropped),
            rounds_used=torch.zeros((), dtype=i32, device=snap.device),
            accepted_per_round=torch.zeros((max_rounds,), dtype=i32, device=snap.device),
            diag_per_round=torch.zeros((max_rounds, 3), dtype=i32, device=snap.device),
            placed_round=placed_round)

    return cycle


def _rounds_decision(fw: Framework, ctx: CycleContext, sbase: torch.Tensor,
                     gang_scheduling: bool, max_rounds: int,
                     kw: dict) -> tuple[CycleDecision, rounds_ops.RoundsResult]:
    """The rounds engine over the static base `sbase` and the context's
    matched-pending table, then the gang unwind: (decision, the engine's
    result: its final plugin state and counters). `kw` goes to
    `rounds_commit` (its pass counts and the K2 / K5 / K6 functions)."""
    snap = ctx.snap

    def dyn_batched_view_fn(vsnap, vmp, node_req, ext, vsbase, act_v):
        return fw.dyn_batched(ctx.view(vsnap, vmp), node_req, ext, vsbase, act_v)

    def update_batched_view_fn(vsnap, vmp, ext, accepted, node_of):
        return fw.extra_update_batched(ctx.view(vsnap, vmp), ext, accepted, node_of)

    rres = rounds_ops.rounds_commit(
        snap=snap,
        sbase=sbase,
        m_pending=ctx.matched_pending,
        dyn_batched_view_fn=dyn_batched_view_fn,
        update_batched_view_fn=update_batched_view_fn,
        extra=fw.extra_init(ctx),
        max_rounds=max_rounds,
        score_anchor_fn=lambda nr: fw.score_anchor(ctx, nr),
        pv_choice_fn=_make_pv_choice_fn(ctx),
        **kw,
    )
    assignment, node_req = rres.assignment, rres.node_requested
    dropped = torch.zeros_like(snap.pod_valid)
    if gang_scheduling:
        assignment, node_req, dropped = _gang_unwind(snap, assignment, node_req)
    unsched = snap.pod_valid & (assignment < 0)
    placed_round = torch.where(assignment >= 0, rres.placed_round, -1)
    return CycleDecision(assignment, node_req, unsched, dropped, placed_round), rres


def _final_window_rejects(fw: Framework, ctx: CycleContext, rres, pct: int,
                          static_base_fn: Callable) -> torch.Tensor:
    """The rounds cycle's dynamic attribution (reference
    `core/cycle.py:638-665`), i32 [P, F]: the pods the engine left unplaced,
    `compact_window(P)` of them (preemption-eligible ones first by rank,
    then the others), against the final state and plugin state, from their
    sampled static mask (K1 on the window's rows without the fit test),
    counted by K17 at their rows; zero elsewhere."""
    snap = ctx.snap
    unplaced = snap.pod_valid & (rres.assignment < 0)
    rank = snap.pod_order.to(torch.int32)
    big = torch.iinfo(torch.int32).max
    ukey = torch.where(unplaced & snap.pod_can_preempt, rank,
                       torch.where(unplaced, rank + (1 << 24), big))
    ugid = torch.argsort(ukey, stable=True)[:rounds_ops.compact_window(snap.P)]
    uact = unplaced[ugid]
    uvsnap = rounds_ops._pod_view(snap, ugid)
    uvctx = ctx.view(uvsnap, ctx.matched_pending[:, ugid])
    start = static_base_fn(static_base_ops.static_base_inputs(
        fw, uvctx, sampling=sampling_window(uvsnap, pct))) > static_base_ops.NEG_INF / 2
    urej = fw.dyn_rejects(uvctx, rres.node_requested, rres.extra, start, rows=uact)
    out = torch.zeros((snap.P, len(fw.filters)), dtype=torch.int32, device=snap.device)
    return out.index_copy_(0, ugid, urej)  # ugid: distinct pods


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


def build_packed_cycle_fn(spec, **kw) -> Callable:
    """`build_cycle_fn` on packed buffers (reference `core/cycle.py:784`):
    `packed(wbuf, bbuf, stable=None)` unpacks the frame (`models/
    packing.py`) and runs the cycle of `build_cycle_fn(**kw)` on it (the
    full outputs by default), the stable tables seeding its context. The
    `Scheduler` serves with it when the carry path is off (the scan
    engine). Wrapped in `_Resilient`."""
    from ..models import packing

    cycle = build_cycle_fn(**kw)

    def packed(wbuf, bbuf, stable=None):
        return cycle(packing.unpack(wbuf, bbuf, spec), stable)

    return _Resilient(packed, "packed_cycle")


# --------------------------------------------------------------------------
# the device-carry latency path (reference core/cycle.py:1050-1583): packed
# buffers in, the [P, N] static base and [S, P] matched-pending carried on
# the device across cycles and rebuilt only for changed pod rows
# --------------------------------------------------------------------------


def _on_device(snap, dev, what: str) -> None:
    if snap.device.type != dev.type:
        raise ValueError(f"snapshot on {snap.device}, {what} built for {dev}")


def _pv_claimed_of(snap, extra) -> torch.Tensor:
    """The VolumeBinding claim bitmap out of the engine's final plugin
    state (all False when the plugin carries none)."""
    pv = extra.get("VolumeBinding")
    if pv is None:
        return torch.zeros(snap.pv_avail.shape, dtype=torch.bool, device=snap.device)
    return pv


def _pv_claimed_after_unwind(snap, ctx: CycleContext, extra, assignment, dropped):
    """The claim bitmap with the gang-unwound pods' static-PV claims
    released: when a pod was dropped, the claims of the surviving
    placements refolded in rank order from empty (K12 `pv_fold` on the
    card; reference `core/cycle.py:480`). The test for a drop reads one
    device value."""
    pv = _pv_claimed_of(snap, extra)
    if "VolumeBinding" not in extra or not snap.has_volumes or not bool(dropped.any()):
        return pv
    accepted = snap.pod_valid & (assignment >= 0)  # post-unwind
    return ctx.volume_kernels.pv_fold(
        snap, ctx.volume_tables, torch.zeros_like(pv), accepted,
        assignment.clamp(min=0), snap.pod_order.to(torch.int32))


def build_stable_state_fn(spec, device=None) -> Callable:
    """`stable(wbuf, bbuf) -> dict` of the tables valid while the nodes and
    the existing pods stay: the label expressions against the nodes, and
    when the snapshot has inter-pod affinity or spread the existing pods'
    selector matches and the initial affinity state. The carry and the
    packed cycle and preemption take it to seed their contexts."""
    from ..models import packing

    dev = resolve_device(device)

    def stable(wbuf, bbuf):
        snap = packing.unpack(wbuf, bbuf, spec)
        _on_device(snap, dev, "stable state")
        ctx = CycleContext(snap)
        out = {"expr_node_mask": ctx.expr_node_mask}
        if snap.has_inter_pod_affinity or snap.has_topology_spread:
            out["matched_existing"] = ctx.matched_existing
            out["initial_affinity_state"] = ctx.initial_affinity_state()
        return out

    return stable


def build_carry_fns(spec, framework: Framework | None = None, device=None):
    """(carry_init, carry_update_for_bucket): the device-resident static
    carry `{"sbase": f32 [P, N], "mp": bool [S, P]}`. `sbase` is
    where(static mask, clip(static score, +-1e6), NEG_INF) of the
    framework's static plugins (K1 without the fit test and without
    sampling, which the cycle applies), `mp` the pending pods' selector
    matches. Both depend on pod rows x node tables x interning dims only,
    so a frame updates the rows of its changed slots.

    `carry_update_for_bucket(n)` gives `update(wbuf, bbuf, stable, carry,
    dirty)` for `n` slot ids (pad entries repeat a real slot: the same row
    written twice): K1 on the pod view of the slots, `index_copy_` of the
    rows into the carried `sbase` and of their selector matches into the
    columns of `mp`. It updates the carry in place (the reference returns
    new arrays) and returns it."""
    from ..models import packing
    from ..ops import interpod as interpod_ops

    dev = resolve_device(device)
    fw = framework or Framework.from_config()

    def context(snap, stable):
        ctx = CycleContext(snap)
        ctx._cache.update(stable)
        return ctx

    def carry_init(wbuf, bbuf, stable):
        snap = packing.unpack(wbuf, bbuf, spec)
        _on_device(snap, dev, "carry")
        ctx = context(snap, stable)
        sbase = static_base_ops.static_base(static_base_ops.static_base_inputs(fw, ctx, fit=False))
        return {"sbase": sbase, "mp": ctx.matched_pending}

    def carry_update_for_bucket(n_bucket: int):
        def carry_update(wbuf, bbuf, stable, carry, dirty):
            idx = rounds_ops._host_table([int(i) for i in dirty], dev)
            if idx.shape[0] != n_bucket:
                raise ValueError(f"carry update for {n_bucket} slots got {idx.shape[0]}")
            snap = packing.unpack(wbuf, bbuf, spec)
            _on_device(snap, dev, "carry")
            vsnap = rounds_ops._pod_view(snap, idx)
            rows = static_base_ops.static_base(static_base_ops.static_base_inputs(
                fw, context(vsnap, stable), fit=False))
            cols = interpod_ops.matched_pending(vsnap)
            carry["sbase"].index_copy_(0, idx.long(), rows)
            carry["mp"].index_copy_(1, idx.long(), cols)
            return carry

        return carry_update

    return carry_init, carry_update_for_bucket


class CarryKeeper:
    """Host-side carry maintenance (reference `core/cycle.py:1148`): one
    fixed dirty bucket, min(P, next_pow2(max(256, P // 4))) slots, so every
    update launches K1 at one row count; a rebuild through carry_init
    whenever the regime key changes, the frame's dirty set is None, or it
    overflows the bucket. One keeper serves every frame of one pack layout
    (`PackSpec.layout_key`); the carry programs read no other aux field."""

    def __init__(self, spec, framework: Framework | None = None, device=None):
        self.spec = spec
        self.ci, self._cu = build_carry_fns(spec, framework, device)
        P = spec.shape_of("pod_priority")[0]
        self.bucket = min(P, 1 << (max(256, P // 4) - 1).bit_length())
        self.key = None
        self.carry = None
        self.last = None  # "init", "update" or "none": what the last state() ran

    def state(self, wbuf, bbuf, stable, dirty, regime_key):
        """The carry for this frame (`dirty` and `regime_key` from the
        frame's `encode_packed`: its `dirty` and the encoder's
        `_carry_key`)."""
        if self.key != regime_key or dirty is None or len(dirty) > self.bucket:
            self.carry = self.ci(wbuf, bbuf, stable)
            self.key = regime_key
            self.last = "init"
        elif len(dirty):
            idx = np.full(self.bucket, dirty[0], np.int32)
            idx[: len(dirty)] = dirty
            self.carry = self._cu(self.bucket)(wbuf, bbuf, stable, self.carry, idx)
            self.last = "update"
        else:
            self.last = "none"
        return self.carry


class ExtenderVerdictKeeper:
    """The HTTP-extender verdicts kept on the device across cycles
    (reference `core/cycle.py:1201-1301`): emask bool [P, N] and escore
    f32 [P, N], re-consulting the webhooks only for the changed pod slots
    (the encoder's dirty set), the behaviour `Extender.carry_verdicts`
    opts into (the operator asserts the verdicts are deterministic per
    pod and node set). Pad rows and columns hold mask True and score 0, as
    the packed path's planes. A regime-key change, a missing dirty set or
    one over the bucket makes a full sweep. Per-slot error messages are
    carried with the verdicts, and every errored slot is consulted again
    each cycle (its pod is requeued with backoff, not parked behind an
    all-False row). An update is an `index_copy_` of the re-consulted
    rows alone into the planes (the reference pads them to the bucket for
    its static shapes; the bucket stays the sweep threshold)."""

    def __init__(self, spec, device=None):
        P = N = None
        for name, _dt, shape, _off in spec.words:
            if name == "pod_priority":
                P = shape[0]
            elif name == "node_taintset":
                N = shape[0]
        self.P, self.N = P, N
        self.device = resolve_device(device)
        self.bucket = min(P, 1 << (max(256, P // 4) - 1).bit_length())
        self.key = None
        self.emask = self.escore = None
        self.errors: dict[int, str] = {}
        self.last = None  # "sweep", "update" or "none": what the last state() ran
        self.consulted = 0  # pod rows the last state() sent to the webhooks
        self.last_ms = 0.0  # host ms of the last state(): webhooks and uploads

    def _rows(self, extenders, pods, nodes):
        from ..framework.host import run_extender_prepass

        m, s, errs = run_extender_prepass(extenders, pods, nodes)
        n_real = len(nodes)
        mrows = np.ones((len(pods), self.N), bool)
        srows = np.zeros((len(pods), self.N), np.float32)
        if m is not None:
            mrows[:, :n_real] = m
            srows[:, :n_real] = s
        self.consulted = len(pods)
        return mrows, srows, errs

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def state(self, extenders, pending, nodes, dirty, regime_key):
        """(emask, escore) on the device for this frame: `dirty` the
        frame's changed slots (None: all), `regime_key` the pack layout and
        the encoder's carry key."""
        import time

        t0 = time.perf_counter()
        try:
            return self._state(extenders, pending, nodes, dirty, regime_key)
        finally:
            self.last_ms = (time.perf_counter() - t0) * 1e3

    def _state(self, extenders, pending, nodes, dirty, regime_key):
        self.consulted = 0
        full = (
            self.key != regime_key
            or self.emask is None
            or dirty is None
            or len(dirty) > self.bucket
        )
        if full:
            mrows, srows, errs = self._rows(extenders, pending, nodes)
            em = np.ones((self.P, self.N), bool)
            es = np.zeros((self.P, self.N), np.float32)
            em[: len(pending)] = mrows
            es[: len(pending)] = srows
            self.emask, self.escore = self._upload(em), self._upload(es)
            self.errors = dict(errs)
            self.key = regime_key
            self.last = "sweep"
            return self.emask, self.escore
        # the changed slots and every slot with a carried error: a
        # transient webhook failure is retried each cycle
        rows_idx = sorted(
            {int(i) for i in dirty if i < len(pending)}
            | {i for i in self.errors if i < len(pending)}
        )
        self.last = "none"
        if rows_idx:
            mrows, srows, errs = self._rows(
                extenders, [pending[i] for i in rows_idx], nodes)
            for i in rows_idx:
                self.errors.pop(i, None)
            for j, msg in errs.items():
                self.errors[rows_idx[j]] = msg
            ix = self._upload(np.asarray(rows_idx, np.int64))
            self.emask.index_copy_(0, ix, self._upload(mrows))
            self.escore.index_copy_(0, ix, self._upload(srows))
            self.last = "update"
        return self.emask, self.escore


def build_packed_cycle_carry_fn(
    spec,
    framework: Framework | None = None,
    gang_scheduling: bool = True,
    max_rounds: int = 64,
    percentage_of_nodes_to_score: int = 0,
    rounds_kw: dict | None = None,  # compact / passes / passes_round0
    extender_args: bool = False,
    device=None,
) -> Callable:
    """The latency-path cycle (reference `core/cycle.py:1304`):
    `cycle(wbuf, bbuf, stable, carry, emask=None, escore=None) ->
    CycleResult`. The static base and matched-pending come from the carry
    (`build_carry_fns`, `CarryKeeper`) instead of being rebuilt; the cycle
    merges the HTTP-extender verdicts into the carried base (with
    `extender_args` the device planes `emask` / `escore` of
    `ExtenderVerdictKeeper`, else a snapshot's own, when it has them) and
    applies the node-sampling window to it in one pass (K18
    `extender_merge`; its plain version on the CPU),
    then runs the rounds engine with the same kernels as
    `build_cycle_fn(commit_mode="rounds")` (K2-K6, K10-K12, K14, K15 on
    the card, their plain versions on the CPU) and the gang unwind,
    and returns the claim bitmap of the surviving placements and the
    engine's round counters; its reject counts are zeros, as the
    reference's (attribution is `build_diagnosis_fn`'s, off the decision
    path). Decisions are bit-equal to the reference's carry cycle and to
    the fresh rounds cycle on the same frame (tests/test_torch_carry.py,
    tests/test_torch_extenders.py)."""
    from ..models import packing

    kw = dict(rounds_kw or {})
    unknown = set(kw) - {"compact", "passes", "passes_round0"}
    if unknown:
        raise NotImplementedError(f"rounds options not ported: {sorted(unknown)}")
    dev = resolve_device(device)
    fw = framework or Framework.from_config()

    def cycle(wbuf, bbuf, stable, carry, emask=None, escore=None) -> CycleResult:
        snap = packing.unpack(wbuf, bbuf, spec)
        _on_device(snap, dev, "cycle")
        ctx = CycleContext(snap)
        ctx._cache.update(stable)
        ctx._cache["matched_pending"] = carry["mp"]
        if extender_args:
            if emask is None or escore is None:
                raise ValueError("carry cycle built with extender_args takes emask and escore")
        elif snap.has_extender:
            emask, escore = snap.pod_extender_mask, snap.pod_extender_score
        else:
            emask = escore = None
        samp = sampling_params(snap, percentage_of_nodes_to_score)
        sbase = carry["sbase"]
        if emask is not None or samp is not None:
            sbase = extender_merge_ops.extender_merge(sbase, emask, escore, samp)
        d, rres = _rounds_decision(fw, ctx, sbase, gang_scheduling, max_rounds, kw)
        return CycleResult(
            d.assignment, d.node_requested, d.unschedulable, d.gang_dropped,
            reject_counts=torch.zeros((snap.P, len(fw.filters)), dtype=torch.int32,
                                      device=snap.device),
            pv_claimed=_pv_claimed_after_unwind(snap, ctx, rres.extra, d.assignment,
                                                d.gang_dropped),
            rounds_used=rres.rounds_used, accepted_per_round=rres.accepted_per_round,
            diag_per_round=rres.diag_per_round, placed_round=d.placed_round)

    return cycle


def build_packed_preemption_fn(spec, framework: Framework | None = None,
                               device=None) -> Callable | None:
    """`build_preemption_fn` on packed buffers (reference
    `core/cycle.py:1554`): `packed(wbuf, bbuf, result, stable=None) ->
    PreemptionResult`, its context seeded with the stable tables the
    cycle used instead of computing them again. Same stages (K7-K9, and
    K10 in the static gate, on the card) and results as
    `build_preemption_fn` on the frame's snapshot. None when no PostFilter
    plugin is enabled."""
    from ..models import packing

    dev = resolve_device(device)
    fw = framework or Framework.from_config()
    if not fw.post_filters:
        return None

    def packed(wbuf, bbuf, result, stable=None):
        snap = packing.unpack(wbuf, bbuf, spec)
        _on_device(snap, dev, "preemption")
        ctx = CycleContext(snap)
        if stable is not None:
            ctx._cache.update(stable)
        return fw.post_filter(ctx, result.assignment, result.node_requested,
                              _preemption_gate_rows(fw, ctx), excluded=result.gang_dropped)

    return packed


def build_diagnosis_fn(
    spec,
    framework: Framework | None = None,
    window: int = 2048,
    extender_args: bool = False,
    donate: bool = False,
    device=None,
    static_rejects_fn: Callable = static_base_ops.static_rejects,
    dyn_rejects_fn: Callable = dyn_round_ops.dyn_rejects,
    interpod_terms_fn: Callable = interpod_terms_ops.interpod_terms,
    affinity_update_fn: Callable = affinity_update_ops.affinity_update,
    volume_mask_fn: Callable = volume_mask_ops.volume_mask,
    pv_fold_fn: Callable = pv_fold_ops.pv_fold,
) -> Callable:
    """The diagnosis program (reference `core/cycle.py:1425`), off the
    decision path: `diagnose(wbuf, bbuf, stable, assignment, node_requested,
    pv_claimed=None, emask=None) -> i32 [P, F]`, the FailedScheduling attribution of
    every valid unplaced pod (static + dynamic against the cycle's final
    state; other rows zero).

    The cycle's placements replay into the plugins' state (K4, K12 and
    NodePorts' fold), the engine's claim bitmap `pv_claimed` replacing the
    replayed one where given. Then rank-ordered windows of `window` unplaced
    pods (the last clamped to end at P, so it may repeat earlier pods, whose
    rows come out the same): per window K16 from node_valid for the static
    filters, with the chain's remainder (node_valid and every static filter,
    the reference's start mask) over every row of the window, and K17 over
    the dynamic parts (K3, K10) from that mask. With `extender_args` the
    window starts from node_valid & emask[ids] (the carried verdicts, the
    reference's `:1482-1485`): K16's per-pod base, the plane's rows read in
    place; without it a snapshot's own verdicts are ignored, as in the
    reference. The host reads the unplaced count once. `device` None means
    the card; the `*_fn` arguments select other kernel functions (the plain
    versions: the run the kernels are held against). `donate` is accepted
    and changes nothing (the reference's buffer donation has no
    counterpart here)."""
    del donate
    from ..models import packing

    dev = resolve_device(device)
    fw = framework or Framework.from_config()
    F = len(fw.filters)
    kernels = AffinityKernels(interpod_terms=interpod_terms_fn,
                              affinity_update=affinity_update_fn)
    vkernels = VolumeKernels(volume_mask=volume_mask_fn, pv_fold=pv_fold_fn)
    dkernels = DynKernels(dyn_rejects=dyn_rejects_fn)

    def diagnose(wbuf, bbuf, stable, assignment, node_requested, pv_claimed=None,
                 emask=None):
        snap = packing.unpack(wbuf, bbuf, spec)
        _on_device(snap, dev, "diagnosis")
        if extender_args and emask is None:
            raise ValueError("diagnosis built with extender_args takes emask")
        P = snap.P
        B = min(window, P)
        ctx = CycleContext(snap, kernels, volume_kernels=vkernels, dyn_kernels=dkernels)
        ctx._cache.update(stable)
        mp = ctx.matched_pending
        placed = snap.pod_valid & (assignment >= 0)
        extra = fw.extra_update_batched(ctx, fw.extra_init(ctx), placed,
                                        torch.where(placed, assignment, 0))
        if pv_claimed is not None and "VolumeBinding" in extra:
            extra = dict(extra, VolumeBinding=pv_claimed)
        unplaced = snap.pod_valid & (assignment < 0)
        order = torch.argsort(torch.where(unplaced, snap.pod_order.to(torch.int32),
                                          torch.iinfo(torch.int32).max), stable=True)
        rej = torch.zeros((P, F), dtype=torch.int32, device=snap.device)
        n_un = int(unplaced.sum())  # the program's one host read
        for w in range(-(-n_un // B)):
            start = min(w * B, P - B)
            ids = order[start:start + B]
            act = unplaced[ids]
            vsnap = rounds_ops._pod_view(snap, ids)
            vctx = ctx.view(vsnap, mp[:, ids])
            x = static_base_ops.reject_inputs(static_base_ops.static_base_inputs(fw, vctx))
            if extender_args:
                srej, smask = static_rejects_fn(x, act, True,
                                               base=(emask, ids.to(torch.int32)))
            else:
                srej, smask = static_rejects_fn(x, act, True)
            drej = fw.dyn_rejects(vctx, node_requested, extra, smask, rows=act)
            rej.index_copy_(0, ids, srej + drej)
        return rej

    return diagnose
