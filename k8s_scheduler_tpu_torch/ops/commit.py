"""The scan engine's sequential commit (`k8s_scheduler_tpu/ops/commit.py`):
one pod decision per step, in priority order, against the requested state
and plugin state that every earlier decision left — upstream ScheduleOne's
semantics.

`greedy_commit` is the plain version: a Python loop over the ranks of the
valid pods (a pad pod changes nothing, so it is skipped), each step a few
dozen small tensor operations through the caller's `dyn_fn` / `update_fn`,
indices kept as tensors so no step synchronises with the host. K13
`scan_commit` (`ops/scan_commit.py`) runs the same steps in one launch on
the card.

Tie-breaking: the lowest node index among equal scores
(`argsel.argmax_first`), as in the reference."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from . import argsel
from .resources import _fma

NEG_INF = -1e9

class Product(NamedTuple):
    """A dynamic score x * c [N] left unrounded (`Framework.dyn` when the
    whole sum is one product): the static score's add fuses it, as the
    reference's compiled scan step does."""

    x: torch.Tensor
    c: float


class Constant(NamedTuple):
    """A dynamic score that the reference's compiled program folds to the
    constant c times its weight: BalancedAllocation over one resource, whose
    std is 0 (ROADMAP C7). A bare value in the score sum, never a product,
    so a held product fuses into the add that takes it."""

    shape: tuple[int, ...]
    device: torch.device
    c: float


class OneResourceFit(NamedTuple):
    """NodeResourcesFit's score over a snapshot's one resource, x * c (x the
    clamped free or used fraction, c = 100): the compiled program folds
    the weight into c. Beside a `Constant` the product fuses into the score
    sum; without one it is rounded alone, a bare value (ROADMAP C7)."""

    x: torch.Tensor
    c: float


def add_static(static_row: torch.Tensor, dyn) -> torch.Tensor:
    """static + dynamic score, with the reference's rounding: one scan
    step's row, or a rounds-engine round's [B, N] base, whose compiled add
    fuses a dynamic sum that is one bare product all the same."""
    if isinstance(dyn, Product):
        return _fma(dyn.x, dyn.c, static_row)
    return static_row + dyn


# dyn_fn(p i32 0-d, node_requested [N, R], extra, static_row bool [N])
#   -> (feasibility mask [N] bool, dynamic score [N] f32 or a Product[,
#   per-filter rejects i32 [F]])
DynFn = Callable[[torch.Tensor, torch.Tensor, Any, torch.Tensor],
                 tuple[torch.Tensor, torch.Tensor]]
# update_fn(extra, p, node, committed) -> extra (p, node i32 0-d; committed bool 0-d)
UpdateFn = Callable[[Any, torch.Tensor, torch.Tensor, torch.Tensor], Any]


@dataclasses.dataclass
class CommitResult:
    assignment: torch.Tensor  # i32 [P] node index or -1
    node_requested: torch.Tensor  # f32 [N, R] post-commit
    extra: Any  # final plugin state
    dyn_aux: torch.Tensor | None = None  # i32 [P, F] per-step rejects (or None)


def greedy_commit(
    *,
    order: torch.Tensor,  # i32 [P]: the pod scheduled at each rank
    static_mask: torch.Tensor,  # bool [P, N]
    static_score: torch.Tensor,  # f32 [P, N]
    pod_requested: torch.Tensor,  # f32 [P, R]
    pod_valid: torch.Tensor,  # bool [P]
    pod_nominated: torch.Tensor,  # i32 [P] node index (-1 none)
    node_requested: torch.Tensor,  # f32 [N, R] at cycle start
    dyn_fn: DynFn,
    extra: Any = None,
    update_fn: UpdateFn | None = None,
    rejects: int | None = None,
) -> CommitResult:
    """Per step, for pod p = order[rank]: feasible = dyn mask & static row;
    score = static + dynamic where feasible, NEG_INF elsewhere; the
    nominated node when it is feasible, else the first-index argmax;
    committed when that node is feasible; node_requested[best] += request
    (f32, committed only); update_fn on every step.

    `rejects` (F) collects the third output of `dyn_fn` of each step into
    `dyn_aux` i32 [P, F] at the step's pod (reference `ops/commit.py:84`,
    `:114-117`); the walk then takes every rank, an invalid pod's step too,
    as the reference's scan does."""
    P, N = static_mask.shape
    dev = static_mask.device
    ranked = order.long()
    if rejects is None:
        ranked = ranked[pod_valid[ranked]]  # the valid pods in rank order
    dyn_aux = (torch.zeros((P, rejects), dtype=torch.int32, device=dev)
               if rejects is not None else None)
    node_req = node_requested.clone()
    assignment = torch.full((P,), -1, dtype=torch.int32, device=dev)
    neg_inf = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(ranked.shape[0]):
        pi = ranked[i:i + 1]  # [1]
        p = pi[0].to(torch.int32)
        srow = static_mask.index_select(0, pi)[0]
        out = dyn_fn(p, node_req, extra, srow)
        feasible, dyn_score = out[0], out[1]
        if dyn_aux is not None:
            dyn_aux.index_copy_(0, pi, out[2][None, :])
        # AND the static row again: a dyn_fn that ignores it cannot bypass
        # the static filters
        feasible = feasible & srow
        score = torch.where(
            feasible, add_static(static_score.index_select(0, pi)[0], dyn_score), neg_inf)
        # a nominated node (from an earlier preemption) wins when feasible
        nom_raw = pod_nominated.index_select(0, pi)  # [1]
        nom = nom_raw.clamp(0, N - 1).long()
        nom_ok = (nom_raw >= 0) & feasible.index_select(0, nom)
        best = torch.where(nom_ok, nom, argsel.argmax_first(score).long().reshape(1))  # [1]
        ok = feasible.index_select(0, best) & pod_valid.index_select(0, pi)  # [1]
        assignment.index_copy_(0, pi, torch.where(ok, best, -1).to(torch.int32))
        node_req.index_add_(0, best, torch.where(
            ok[:, None], pod_requested.index_select(0, pi), zero))
        if update_fn is not None:
            extra = update_fn(extra, p, best[0].to(torch.int32), ok[0])
    return CommitResult(assignment, node_req, extra, dyn_aux)


def unwind_assignments(result: CommitResult, drop: torch.Tensor,
                       pod_requested: torch.Tensor) -> CommitResult:
    """Roll back the placements of the pods in `drop` (bool [P]; gang
    all-or-nothing): their requests leave their nodes and their assignment
    becomes -1.

    The reference subtracts in one f32 scatter-add, pod by pod in index
    order. Here every node's dropped pods are subtracted in that same order
    — the j-th dropped pod of every node in one vectorised step — so the
    roundings are the reference's on every device."""
    a = result.assignment
    undo = drop & (a >= 0)
    node_req = result.node_requested
    idx = torch.nonzero(undo, as_tuple=True)[0]  # ascending pod index
    if idx.numel():
        node = a[idx].long()
        order = torch.argsort(node, stable=True)  # per node, pod index order
        idx, node = idx[order], node[order]
        first = torch.ones_like(node, dtype=torch.bool)
        first[1:] = node[1:] != node[:-1]
        start = torch.cummax(torch.where(first, torch.arange(
            node.shape[0], device=node.device), 0), dim=0).values
        pos = torch.arange(node.shape[0], device=node.device) - start
        node_req = node_req.clone()
        for j in range(int(pos.max()) + 1):
            at = pos == j  # at most one pod per node
            node_req.index_add_(0, node[at], -pod_requested[idx[at]])
    assignment = torch.where(undo, -1, a)
    return CommitResult(assignment, node_req, result.extra, result.dyn_aux)
