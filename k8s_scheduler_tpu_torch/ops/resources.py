"""Resource-fit mask and resource-based scores (`k8s_scheduler_tpu/ops/
resources.py`). Quantities are float32 (cpu in millicores, memory in
bytes) and comparisons carry the reference's relative slack.

Numerics: the reference runs under XLA, which contracts `a * b + c` into
one fused multiply-add. Where such a contraction feeds a comparison or a
score, `_fma` reproduces it: the product of two f32 values is exact in
f64, so the f64 sum rounded once to f32 is the fused result (up to a
double rounding that needs an f64 tie, which these magnitudes never
produce)."""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

MAX_NODE_SCORE = 100.0
_REL_EPS = 1e-5


def _fma(a, b, c) -> torch.Tensor:
    """f32 fused multiply-add a * b + c with one rounding."""
    if (isinstance(b, float) and isinstance(c, torch.Tensor)
            and math.frexp(b)[0] in (0.5, -0.5)):
        # a power-of-two factor: the f32 product is exact (scores and
        # quantities never reach the subnormal range), so the f32 add is
        # the one rounding, without f64 temporaries
        return a * b + c
    def f64(v):
        if isinstance(v, torch.Tensor):
            return v.double()
        return float(np.float32(v))
    return (f64(a) * f64(b) + f64(c)).float()


def fit_slack(node_allocatable: torch.Tensor) -> torch.Tensor:
    """Relative-epsilon slack of every fit comparison: eps * alloc + eps."""
    return _fma(node_allocatable, _REL_EPS, _REL_EPS)


def fit_mask(
    pod_requested: torch.Tensor,  # f32 [P, R]
    node_allocatable: torch.Tensor,  # f32 [N, R]
    node_requested: torch.Tensor,  # f32 [N, R]
) -> torch.Tensor:  # bool [P, N]
    """NodeResourcesFit: pod fits iff for every resource
    requested_pod + requested_node <= allocatable (+ slack). One [P, N]
    pass per resource keeps the temporaries at [P, N]."""
    room = (node_allocatable - node_requested) + fit_slack(node_allocatable)
    out = None
    for r in range(pod_requested.shape[1]):
        ok = pod_requested[:, r, None] <= room[None, :, r]
        out = ok if out is None else out & ok
    return out


def fit_mask_single(
    pod_requested: torch.Tensor,  # f32 [R]
    node_allocatable: torch.Tensor,  # f32 [N, R]
    node_requested: torch.Tensor,  # f32 [N, R]
) -> torch.Tensor:  # bool [N]
    room = (node_allocatable - node_requested) + fit_slack(node_allocatable)
    return torch.all(pod_requested[None, :] <= room, dim=-1)


def _used_fraction(pod_requested, node_allocatable, node_requested):
    """(node_requested + pod) / allocatable per resource, 1.0 where
    allocatable is 0 (a zero-capacity resource is fully used)."""
    after = node_requested + pod_requested
    return torch.where(
        node_allocatable > 0,
        after / torch.clamp(node_allocatable, min=1e-9),
        torch.ones((), dtype=after.dtype, device=after.device),
    )


def least_requested_score(
    pod_requested: torch.Tensor,  # f32 [R] (single pod) or [P, 1, R]
    node_allocatable: torch.Tensor,  # f32 [N, R]
    node_requested: torch.Tensor,  # f32 [N, R]
    resource_weights: Sequence[float],  # [R] (0 excludes a resource)
) -> torch.Tensor:  # f32 [N] or [P, N]
    """LeastRequested: weighted mean over resources of
    (allocatable - requested_after) / allocatable * 100."""
    acc, c = requested_score_factors(pod_requested, node_allocatable,
                                     node_requested, resource_weights)
    return acc * c


def most_requested_score(
    pod_requested, node_allocatable, node_requested,
    resource_weights: Sequence[float],
) -> torch.Tensor:
    """MostRequested (bin-packing variant of LeastRequested)."""
    acc, c = requested_score_factors(pod_requested, node_allocatable,
                                     node_requested, resource_weights, most=True)
    return acc * c


def fit_fraction(pod_requested, node_allocatable, node_requested, most: bool = False):
    """The clamped used fraction (MostRequested) or 1 minus it
    (LeastRequested) per resource: what the fit score weights by 100."""
    frac = torch.clamp(
        _used_fraction(pod_requested, node_allocatable, node_requested), 0.0, 1.0)
    return frac if most else 1.0 - frac


def requested_score_factors(
    pod_requested, node_allocatable, node_requested,
    resource_weights: Sequence[float], most: bool = False,
) -> tuple[torch.Tensor, float]:
    """LeastRequested (MostRequested with `most`) as two factors, the
    weighted sum and the f32 reciprocal of the weight sum, whose product is
    the score: the reference's compiled program divides by the constant
    weight sum as a multiply, which the score sum may fuse.

    The sum is sum_r(x_r * 100 * w_r) in the reference's compiled op order:
    the 100 folds into the constant weights and the reduction accumulates
    left to right with fused multiply-adds, or, when every weight is 1 and
    the weight multiply folds away, adds the rounded `x_r * 100` terms."""
    x = fit_fraction(pod_requested, node_allocatable, node_requested, most)
    ones = all(w == 1.0 for w in resource_weights)
    acc = None
    for r, w in enumerate(resource_weights):
        if w == 0.0:  # a zero weight adds an exact 0 to the sum
            continue
        c = MAX_NODE_SCORE if ones else float(np.float32(w) * np.float32(MAX_NODE_SCORE))
        if acc is None:  # 0 + x * c rounds once, fused or not (x * c >= 0)
            acc = x[..., r] * c
        elif ones:
            acc = acc + x[..., r] * c
        else:
            acc = _fma(x[..., r], c, acc)
    if acc is None:
        acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    return acc, _reciprocal(max(float(np.float32(sum(resource_weights))), 1e-9))


def _reciprocal(d: float) -> float:
    """f32(1 / d), rounded once: XLA rewrites a division by a compile-time
    constant as a multiply by this."""
    return float(np.float32(1.0) / np.float32(d))


def balanced_allocation_score(
    pod_requested: torch.Tensor,
    node_allocatable: torch.Tensor,
    node_requested: torch.Tensor,
    resource_weights: Sequence[float],  # [R] — which resources participate
) -> torch.Tensor:
    """NodeResourcesBalancedAllocation: (1 - std(fractions)) * 100 over the
    participating resources."""
    return balanced_allocation_factor(
        pod_requested, node_allocatable, node_requested, resource_weights
    ) * MAX_NODE_SCORE


def balanced_allocation_factor(
    pod_requested: torch.Tensor,
    node_allocatable: torch.Tensor,
    node_requested: torch.Tensor,
    resource_weights: Sequence[float],
) -> torch.Tensor:
    """1 - std(fractions): the balanced-allocation score before its final
    multiply by 100. The divisions by the constant resource count are
    multiplies by its f32 reciprocal, as compiled; the masked sum of
    squares is not contracted, but over every resource (no mask) it is."""
    frac = torch.clamp(
        _used_fraction(pod_requested, node_allocatable, node_requested), 0.0, 1.0
    )
    cols = [r for r, w in enumerate(resource_weights) if w > 0]
    rn = _reciprocal(max(len(cols), 1))
    shape = frac.shape[:-1]
    total = torch.zeros(shape, dtype=torch.float32, device=frac.device)
    for r in cols:
        total = total + frac[..., r]
    mean = total * rn
    fused = len(cols) == len(resource_weights)
    var = torch.zeros(shape, dtype=torch.float32, device=frac.device)
    for r in cols:
        d = frac[..., r] - mean
        var = _fma(d, d, var) if fused else var + d * d
    # sqrt through f64: correctly rounded on every backend (the CPU f32
    # kernel is not)
    std = torch.sqrt((var * rn).double()).float()
    return 1.0 - std
