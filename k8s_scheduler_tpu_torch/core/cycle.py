"""The scheduling cycle (`k8s_scheduler_tpu/core/cycle.py`): a snapshot in,
placements out, on one device.

Per cycle, for the whole pending set:

    CycleContext precomputes -> static base (K1 `static_base`: static
    filters, static scores, node sampling) -> rounds engine (K2
    `claim_pass` inside every acceptance pass) -> gang unwind

This slice builds the latency cycle of the rounds engine
(`build_cycle_fn(commit_mode="rounds", outputs="latency")`). The scan
engine, full outputs, the carry/packed/multi-cycle/arena builders and
preemption are ROADMAP items A5-A13."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..framework.interfaces import CycleContext
from ..framework.runtime import Framework
from ..ops import claim_pass as claim_pass_ops
from ..ops import rounds as rounds_ops
from ..ops import static_base as static_base_ops
from ..utils.device import resolve_device


@dataclasses.dataclass
class CycleDecision:
    """The latency-critical outputs of a cycle."""

    assignment: torch.Tensor  # i32 [P] node index or -1
    node_requested: torch.Tensor  # f32 [N, R] post-cycle
    unschedulable: torch.Tensor  # bool [P] valid pod that found no node
    gang_dropped: torch.Tensor  # bool [P] placed, then unwound


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 two's-complement value (the reference's i32
    arithmetic wraps)."""
    return ((x + 2**31) % 2**32) - 2**31


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
    off = _wrap_i32(
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
    node_requested = rounds_ops.index_add_exact(
        node_requested, assignment[dropped], -snap.pod_requested[dropped]
    )
    assignment = torch.where(dropped, -1, assignment)
    return assignment, node_requested, dropped


def build_cycle_fn(
    framework: Framework | None = None,
    gang_scheduling: bool = True,
    commit_mode: str = "rounds",
    max_rounds: int = 64,
    percentage_of_nodes_to_score: int = 0,  # 0 = adaptive (upstream default)
    rounds_kw: dict | None = None,  # compact / passes / passes_round0
    outputs: str = "latency",
    device=None,
    static_base_fn: Callable = static_base_ops.static_base,
    claim_pass_fn: Callable = claim_pass_ops.claim_pass,
) -> Callable:
    """The cycle for a framework (default: the default plugin set) on one
    device: `cycle(snapshot) -> CycleDecision`.

    `device` None means the card (raises without one). The default
    `static_base_fn` / `claim_pass_fn` run the hand-written kernels on CUDA
    and their plain torch versions on CPU; passing the plain versions
    (`static_base_plain`, `claim_pass_plain`) runs them on the card too —
    the run the kernels are held against.

    Placements follow the reference's rounds engine: bit-equal
    assignment / node_requested / unschedulable / gang_dropped (held by
    tests/test_torch_cycle.py)."""
    if commit_mode != "rounds":
        raise NotImplementedError(
            f"commit_mode {commit_mode!r}: only the rounds engine is ported "
            "(the scan engine is ROADMAP A8)"
        )
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

    def cycle(snap) -> CycleDecision:
        if snap.device.type != dev.type:
            raise ValueError(
                f"snapshot on {snap.device}, cycle built for {dev}"
            )
        ctx = CycleContext(snap)
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
            **kw,
        )
        assignment, node_req = rres.assignment, rres.node_requested
        dropped = torch.zeros_like(snap.pod_valid)
        if gang_scheduling:
            assignment, node_req, dropped = _gang_unwind(snap, assignment, node_req)
        unsched = snap.pod_valid & (assignment < 0)
        return CycleDecision(assignment, node_req, unsched, dropped)

    return cycle
