"""K14 `dyn_mask` and K15 `dyn_score`: the rounds engine's per-round dynamic
feasibility and claim base, for every pod row of the round's view.

Reference: `k8s_scheduler_tpu/framework/runtime.py:202 Framework.dyn_batched`
as `k8s_scheduler_tpu/ops/rounds.py:577-581` uses it:

    vsmask = vsbase > NEG_INF / 2
    mask, score = dyn_batched(..., vsmask)   # filters ANDed, scores summed
    mask = mask & vsmask & act_v[:, None]
    base = vsbase + score

Two stages, because the inter-pod scores normalise over the feasibility
that every filter gives (K3 `interpod_norm` runs between them):

- `dyn_mask(vsbase, parts, act_v)` -> (mask, feasible), bool [B, N]:
  feasible = the static row (vsbase > NEG_INF / 2) AND each filter's part:
  a bool [B, N] plane (K3's affinity and spread masks, K10's volume mask),
  a `FitMask` (NodeResourcesFit: the request fits allocatable - requested
  + slack) or a `PortMask` (NodePorts: no host port of the pod claimed at
  the node this cycle); mask = feasible & act_v (feasible when act_v is
  None). The norms take `feasible`, as the reference's do.
- `dyn_score(vsbase, terms)` -> base, f32 [B, N]: vsbase plus the weighted
  dynamic scores in score-plugin order, each term a `FitScore`
  (LeastAllocated / MostAllocated), a `BalancedScore` or an f32 [B, N]
  plane (the K3 norms), summed as the reference's round program sums them
  (`dyn_score_plain`) and added as `commit.add_static` adds them. With
  vsbase None it is the score anchor (`Framework.score_anchor`): one pod
  row, a lone product rounded once.

- `dyn_rejects(start, parts, F, rows)` -> i32 [B, F] (K17): first-rejector
  attribution over the same parts, each with its column (the filter's
  index, `Framework.dyn_parts`): column c counts the nodes of `start`
  (bool [B, N]) that no part of a smaller column rejects and part c does
  (the reference's `Framework.attribute_rejects` over `dyn_batched`'s
  per-filter masks, `core/cycle.py:657-660`, `:1492-1495`); rows where
  `rows` (bool [B]) is False count nothing.

The plain versions (`dyn_mask_plain`, `dyn_score_plain`, `dyn_rejects_plain`) are the plugin
arithmetic of `ops/resources.py` and the one-hot port test; the kernels
(csrc/dyn_round.cu) compute the same per element in one pass each, bit for
bit. Bound on an H100: bytes of the [B, N] planes (vsbase, the plane
inputs, the outputs)."""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .commit import NEG_INF, Constant, OneResourceFit, Product, add_static
from .kernel_build import (checked, count_launch, load_cuda_library, ptr,
                           raise_on_error, stream_of)
from .resources import (MAX_NODE_SCORE, _fma, _reciprocal, balanced_allocation_factor,
                        fit_fraction, fit_mask, requested_score_factors)

MAX_RESOURCES = 8  # csrc/dyn_round.cu kMaxR
MAX_PLANES = 8  # kMaxPlanes: plane parts of a mask, plane terms of a score
MAX_TERMS = 8  # kMaxTerms

# csrc/dyn_round.cu mirrors these
M_FIT, M_PORTS, M_ACT = 1, 2, 4
S_MOST, S_FIT_ONES, S_BAL_ALL, S_STATIC = 1, 2, 4, 8
T_FIT, T_BALANCED, T_PLANE, T_CONST = 1, 2, 3, 4
P_BARE, P_PRODUCT, P_PREFERRED = 0, 1, 2


class FitMask(NamedTuple):
    """NodeResourcesFit's filter: pod b's request fits
    (allocatable - requested) + slack at node n, every resource."""

    pod_requested: torch.Tensor  # f32 [B, R]
    node_allocatable: torch.Tensor  # f32 [N, R]
    node_requested: torch.Tensor  # f32 [N, R]


class PortMask(NamedTuple):
    """NodePorts against this cycle's earlier placements: no port id >= 0
    of pod b is claimed at node n."""

    pod_port_ids: torch.Tensor  # i32 [B, MPorts], -1 pad
    claimed: torch.Tensor  # bool [N, Q]


class FitScore(NamedTuple):
    """NodeResourcesFit's score: the `requested_score_factors` product."""

    pod_requested: torch.Tensor  # f32 [B, R]
    node_allocatable: torch.Tensor  # f32 [N, R]
    node_requested: torch.Tensor  # f32 [N, R]
    weights: tuple[float, ...]  # [R] (0 excludes a resource)
    most: bool  # MostAllocated


class BalancedScore(NamedTuple):
    """NodeResourcesBalancedAllocation: (1 - std) * 100 over the resources
    of positive weight."""

    pod_requested: torch.Tensor
    node_allocatable: torch.Tensor
    node_requested: torch.Tensor
    weights: tuple[float, ...]


def sum_terms(terms, prefer=frozenset()):
    """Weighted sum of score terms, each (value, weight) with value a
    tensor, a `commit.Product`, a `commit.Constant` (a bare value: its
    constant times the weight, folded), a `commit.OneResourceFit` (a
    product with the weight folded into its constant where a Constant is
    among the terms, else that product rounded, a bare value) or None, in
    the reference's compiled arithmetic: each add fuses a multiply feeding
    it — the running sum's while that is still a bare product (a first
    term given as factors, with the weight folded into its constant), else
    the new term's (a weight other than 1, or factors); but where the new
    term's index is in `prefer` and it is a product too, its multiply fuses
    and the held one is rounded (the round program's BalancedAllocation).
    Returns None (no term), a tensor, or a `commit.Product` when the whole
    sum is one bare product."""
    terms = list(terms)
    folded = any(isinstance(v, Constant) for v, _ in terms)
    acc, held = None, None  # the running sum; a bare product (x, c)
    for i, (v, w) in enumerate(terms):
        if v is None:
            continue
        if isinstance(v, Product):
            x, c = v.x, float(np.float32(v.c) * np.float32(w))
        elif isinstance(v, OneResourceFit):
            x, c = v.x, _times(v.c, w)
            if not folded:
                x, c = x * c, None
        elif isinstance(v, Constant):
            x, c = torch.full(v.shape, _times(v.c, w), dtype=torch.float32,
                              device=v.device), None
        else:
            x, c = (v, None) if w == 1.0 else (v, float(w))
        if acc is None and held is None:
            if c is None:
                acc = x
            else:
                held = (x, c)
        elif held is not None:
            if i in prefer and c is not None:
                acc = _fma(x, c, held[0] * held[1])
            else:
                acc = _fma(held[0], held[1], x if c is None else x * c)
            held = None
        elif c is None:
            acc = acc + x
        else:
            acc = _fma(x, c, acc)
    return Product(*held) if held is not None else acc


def rounded(v):
    """A sum of `sum_terms` as a tensor (a bare product rounded once)."""
    return v.x * v.c if isinstance(v, Product) else v


def port_onehot(pod_port_ids: torch.Tensor, Q: int) -> torch.Tensor:
    """bool [B, Q]: the ports each pod names (the reference's `.at[].max`
    scatter): a scatter of True into a flat [B * Q + 1] buffer whose last
    slot takes the pad slots, so no size is read from the device."""
    B = pod_port_ids.shape[0]
    flat = torch.zeros(B * Q + 1, dtype=torch.bool, device=pod_port_ids.device)
    rows = torch.arange(B, device=pod_port_ids.device)[:, None] * Q
    at = torch.where(pod_port_ids >= 0, rows + pod_port_ids.clamp(0, max(Q - 1, 0)),
                     B * Q)
    flat.index_fill_(0, at.reshape(-1).long(), True)
    return flat[:B * Q].reshape(B, Q)


def _plain_part(part) -> torch.Tensor:
    if isinstance(part, FitMask):
        return fit_mask(*part)
    if isinstance(part, PortMask):
        claimed = part.claimed
        oh = port_onehot(part.pod_port_ids, claimed.shape[1])
        # 0/1 products with small sums: exact in f32
        return ~((oh.to(torch.float32) @ claimed.T.to(torch.float32)) > 0.0)
    return part


def dyn_mask_plain(vsbase, parts, act_v=None):
    """(mask, feasible) bool [B, N]; see the module note."""
    feasible = vsbase > NEG_INF * 0.5
    for part in parts:
        feasible = feasible & _plain_part(part)
    mask = feasible if act_v is None else feasible & act_v[:, None]
    return mask, feasible


def first_rejects(base_mask, per_filter, rows=None):
    """First-rejector attribution over a chain of filter masks (the
    reference's `Framework.attribute_rejects`): i32 [B, F], column i the
    nodes still in the chain from `base_mask` that mask i rejects (a None
    entry counts none); rows where `rows` (bool [B]) is False count
    nothing."""
    mask = base_mask
    cols = []
    for m in per_filter:
        if m is None:
            cols.append(torch.zeros((base_mask.shape[0],), dtype=torch.int32,
                                    device=base_mask.device))
        else:
            c = (mask & ~m).sum(dim=1, dtype=torch.int32)
            cols.append(c if rows is None else torch.where(rows, c, 0))
            mask = mask & m
    return torch.stack(cols, dim=1)


def dyn_rejects_plain(start, parts, F: int, rows=None):
    """i32 [B, F]; see the module note."""
    per_filter = [None] * F
    for col, part in parts:
        per_filter[col] = _plain_part(part)
    return first_rejects(start, per_filter, rows)


def balanced_is_constant(node_allocatable: torch.Tensor) -> bool:
    """Over one resource BalancedAllocation's std is frac - frac = 0 and its
    score the constant 100: the reference's compiled program folds it, so
    a held product fuses into the add that takes it (ROADMAP C7). Over
    more resources, one of them weighted alone, it does not fold: the
    masked mean and variance stay computed."""
    return node_allocatable.shape[1] == 1


def one_resource_fit(node_allocatable: torch.Tensor, weights) -> bool:
    """The fit score over a snapshot's one resource, scored: the compiled
    program folds its weight sum and the weight into one constant
    (`commit.OneResourceFit`)."""
    return node_allocatable.shape[1] == 1 and tuple(weights) == (1.0,)


def _plain_value(v):
    if isinstance(v, FitScore) and one_resource_fit(v.node_allocatable, v.weights):
        return OneResourceFit(fit_fraction(v.pod_requested[:, None, :], v.node_allocatable,
                                           v.node_requested, v.most)[..., 0],
                              MAX_NODE_SCORE)
    if isinstance(v, FitScore):
        return Product(*requested_score_factors(
            v.pod_requested[:, None, :], v.node_allocatable, v.node_requested,
            v.weights, most=v.most))
    if isinstance(v, BalancedScore):
        if balanced_is_constant(v.node_allocatable):
            return Constant((v.pod_requested.shape[0], v.node_allocatable.shape[0]),
                            v.node_allocatable.device, MAX_NODE_SCORE)
        return Product(balanced_allocation_factor(
            v.pod_requested[:, None, :], v.node_allocatable, v.node_requested,
            v.weights), MAX_NODE_SCORE)
    return v


def dyn_score_plain(vsbase, terms):
    """f32 [B, N] base (vsbase None: the anchor, [B, N] of the terms); see
    the module note."""
    vals = [(_plain_value(v), w) for v, w in terms]
    # a product whose folded constant is 1 is no multiply in the compiled
    # program: a bare value
    vals = [(v.x, 1.0) if isinstance(v, Product) and _times(v.c, w) == 1.0 else (v, w)
            for v, w in vals]
    score = sum_terms(vals, {i for i, (v, _) in enumerate(terms)
                             if isinstance(v, BalancedScore)})
    if vsbase is None:
        return rounded(score)
    if score is None:
        score = torch.zeros_like(vsbase)
    return add_static(vsbase, score)


def _library():
    lib = load_cuda_library("dyn_round")
    if lib.dyn_mask_launch.argtypes is None:
        lib.dyn_mask_launch.argtypes = (
            [ctypes.c_int] * 6 + [ctypes.c_void_p] * 8 + [ctypes.c_int]
            + [ctypes.c_void_p] * 3)
        lib.dyn_mask_launch.restype = ctypes.c_int
        lib.dyn_score_launch.argtypes = (
            [ctypes.c_int] * 5 + [ctypes.c_void_p] * 10 + [ctypes.c_uint, ctypes.c_float]
            + [ctypes.c_void_p] * 2)
        lib.dyn_score_launch.restype = ctypes.c_int
        lib.dyn_rejects_launch.argtypes = (
            [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5 + [ctypes.c_void_p, ctypes.c_int]
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 3)
        lib.dyn_rejects_launch.restype = ctypes.c_int
    return lib


def _ptrs(tensors) -> ctypes.Array:
    """The plane pointers as a host array of MAX_PLANES (the launcher copies
    them into the kernel's arguments)."""
    return (ctypes.c_void_p * MAX_PLANES)(*[t.data_ptr() for t in tensors])


def dyn_mask_cuda(vsbase, parts, act_v=None):
    """Launch K14 of csrc/dyn_round.cu on the current stream."""
    c = "dyn_mask"
    B, N = vsbase.shape
    dev = vsbase.device
    fit = [p for p in parts if isinstance(p, FitMask)]
    port = [p for p in parts if isinstance(p, PortMask)]
    planes = [checked(c, p, torch.bool, (B, N), dev) for p in parts
              if isinstance(p, torch.Tensor)]
    if len(fit) > 1 or len(port) > 1 or len(planes) > MAX_PLANES:
        raise ValueError(f"{c}: at most one FitMask, one PortMask and {MAX_PLANES} planes")
    flags, R, MP, Q = 0, 0, 0, 0
    sb = checked(c, vsbase, torch.float32, (B, N), dev)
    act = req = alloc = nreq = ids = claimed = feasible = None
    mask = torch.empty((B, N), dtype=torch.bool, device=dev)
    if act_v is not None:
        act = checked(c, act_v, torch.bool, (B,), dev)
        feasible = torch.empty((B, N), dtype=torch.bool, device=dev)
        flags |= M_ACT
    if fit:
        R = fit[0].pod_requested.shape[1]
        if R > MAX_RESOURCES:
            raise ValueError(f"{c}: {R} resources > {MAX_RESOURCES}")
        req = checked(c, fit[0].pod_requested, torch.float32, (B, R), dev)
        alloc = checked(c, fit[0].node_allocatable, torch.float32, (N, R), dev)
        nreq = checked(c, fit[0].node_requested, torch.float32, (N, R), dev)
        flags |= M_FIT
    if port and port[0].claimed.shape[1] > 0:  # Q = 0: no port can conflict
        MP, Q = port[0].pod_port_ids.shape[1], port[0].claimed.shape[1]
        ids = checked(c, port[0].pod_port_ids, torch.int32, (B, MP), dev)
        claimed = checked(c, port[0].claimed, torch.bool, (N, Q), dev)
        flags |= M_PORTS
    err = _library().dyn_mask_launch(
        B, N, R, MP, Q, flags, ptr(sb), ptr(act), ptr(req), ptr(alloc), ptr(nreq),
        ptr(ids), ptr(claimed), _ptrs(planes), len(planes), ptr(mask), ptr(feasible),
        stream_of(dev))
    raise_on_error(c, err)
    count_launch(c)
    return mask, (mask if feasible is None else feasible)


def dyn_mask(vsbase, parts, act_v=None):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = dyn_mask_cuda if vsbase.device.type == "cuda" else dyn_mask_plain
    return fn(vsbase, parts, act_v)


MAX_FILTERS = 32  # csrc/dyn_round.cu kMaxF: columns of a reject table


def dyn_rejects_cuda(start, parts, F: int, rows=None):
    """Launch K17 of csrc/dyn_round.cu on the current stream."""
    c = "dyn_rejects"
    B, N = start.shape
    dev = start.device
    if not 0 < F <= MAX_FILTERS:
        raise ValueError(f"{c}: {F} columns; the kernel takes 1 to {MAX_FILTERS}")
    cols = [col for col, _ in parts]
    if len(set(cols)) != len(cols) or any(not 0 <= col < F for col in cols):
        raise ValueError(f"{c}: part columns {cols} are not distinct columns of {F}")
    fit = [(col, p) for col, p in parts if isinstance(p, FitMask)]
    port = [(col, p) for col, p in parts if isinstance(p, PortMask)]
    planes = [(col, checked(c, p, torch.bool, (B, N), dev)) for col, p in parts
              if isinstance(p, torch.Tensor)]
    if len(fit) > 1 or len(port) > 1 or len(planes) > MAX_PLANES:
        raise ValueError(f"{c}: at most one FitMask, one PortMask and {MAX_PLANES} planes")
    st = checked(c, start, torch.bool, (B, N), dev)
    rw = None if rows is None else checked(c, rows, torch.bool, (B,), dev)
    R = MP = Q = 0
    fit_col = port_col = -1
    req = alloc = nreq = ids = claimed = None
    if fit:
        fit_col, f = fit[0]
        R = f.pod_requested.shape[1]
        if R > MAX_RESOURCES:
            raise ValueError(f"{c}: {R} resources > {MAX_RESOURCES}")
        req = checked(c, f.pod_requested, torch.float32, (B, R), dev)
        alloc = checked(c, f.node_allocatable, torch.float32, (N, R), dev)
        nreq = checked(c, f.node_requested, torch.float32, (N, R), dev)
    if port and port[0][1].claimed.shape[1] > 0:  # Q = 0: no port can conflict
        port_col, pm = port[0]
        MP, Q = pm.pod_port_ids.shape[1], pm.claimed.shape[1]
        ids = checked(c, pm.pod_port_ids, torch.int32, (B, MP), dev)
        claimed = checked(c, pm.claimed, torch.bool, (N, Q), dev)
    out = torch.zeros((B, F), dtype=torch.int32, device=dev)
    err = _library().dyn_rejects_launch(
        B, N, R, MP, Q, ptr(req), ptr(alloc), ptr(nreq), ptr(ids), ptr(claimed),
        _ptrs([t for _, t in planes]), len(planes),
        (ctypes.c_int * MAX_PLANES)(*[col for col, _ in planes]), fit_col,
        ptr(st), port_col, F, ptr(rw), ptr(out), stream_of(dev))
    raise_on_error(c, err)
    count_launch(c)
    return out


def dyn_rejects(start, parts, F: int, rows=None):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = dyn_rejects_cuda if start.device.type == "cuda" else dyn_rejects_plain
    return fn(start, parts, F, rows)


def _f32(v: float) -> float:
    return float(np.float32(v))


def _times(a: float, b: float) -> float:
    return float(np.float32(a) * np.float32(b))


def score_program(terms):
    """K15's program of a term list: (terms, planes, the resource operands,
    flags, fit weights x 100 [R], balanced column bits, the balanced
    count's f32 reciprocal), each term (code, plane, constant, form) as
    `dyn_score_plain` folds it. The value and constant: a FitScore's
    (fit sum, f32(1 / weight sum) * w), over one resource the fraction
    and 100 * w (its fit sum's one constant 1) beside the folded
    BalancedAllocation, else the fraction times 100 * w (bare); a
    BalancedScore's (1 - std, 100 * w), over one resource the folded
    constant 100 * w itself (T_CONST, bare); a plane's (x, w). The form:
    P_BARE where the constant is 1 (no multiply), else P_PRODUCT, or
    P_PREFERRED for BalancedAllocation, whose multiply fuses into the add
    in preference to a held product's."""
    prog, planes, res, flags = [], [], None, 0
    w100, bal, rn = (), 0, 1.0
    folded = any(isinstance(v, BalancedScore) and balanced_is_constant(v.node_allocatable)
                 for v, _ in terms)
    for v, w in terms:
        if isinstance(v, (FitScore, BalancedScore)):
            ops = (v.pod_requested, v.node_allocatable, v.node_requested)
            if res is not None and any(a is not b for a, b in zip(ops, res)):
                raise ValueError("dyn_score: the resource scores read different operands")
            res = ops
        form = P_PRODUCT
        if isinstance(v, FitScore) and one_resource_fit(v.node_allocatable, v.weights):
            # the fraction times 100 * w: held as a product beside the
            # folded BalancedAllocation, else rounded as the fit sum's
            # one product
            c = _times(MAX_NODE_SCORE, w)
            w100, c = ((1.0,), c) if folded else ((c,), 1.0)
            flags |= S_MOST if v.most else 0
            code, plane = T_FIT, 0
        elif isinstance(v, FitScore):
            ones = all(x == 1.0 for x in v.weights)
            w100 = tuple(MAX_NODE_SCORE if ones else _times(x, MAX_NODE_SCORE)
                         for x in v.weights)
            flags |= (S_FIT_ONES if ones else 0) | (S_MOST if v.most else 0)
            rws = _reciprocal(max(_f32(sum(v.weights)), 1e-9))
            code, plane, c = T_FIT, 0, _times(rws, w)
        elif isinstance(v, BalancedScore) and balanced_is_constant(v.node_allocatable):
            code, plane, c, form = T_CONST, 0, _times(MAX_NODE_SCORE, w), P_BARE
        elif isinstance(v, BalancedScore):
            cols = [r for r, x in enumerate(v.weights) if x > 0]
            bal = sum(1 << r for r in cols)
            rn = _reciprocal(max(len(cols), 1))
            flags |= S_BAL_ALL if len(cols) == len(v.weights) else 0
            code, plane, c, form = T_BALANCED, 0, _times(MAX_NODE_SCORE, w), P_PREFERRED
        else:
            code, plane, c = T_PLANE, len(planes), _f32(w)
            planes.append(v)
        prog.append((code, plane, c, P_BARE if c == 1.0 or code == T_CONST else form))
    return prog, planes, res, flags, w100, bal, rn


def dyn_score_cuda(vsbase, terms):
    """Launch K15 of csrc/dyn_round.cu on the current stream."""
    c = "dyn_score"
    prog, planes, res, flags, w100, bal, rn = score_program(terms)
    if len(prog) > MAX_TERMS or len(planes) > MAX_PLANES:
        raise ValueError(f"{c}: {len(prog)} terms, {len(planes)} planes over the "
                         f"kernel's {MAX_TERMS} / {MAX_PLANES}")
    if vsbase is not None:
        (B, N), dev = vsbase.shape, vsbase.device
        flags |= S_STATIC
    elif res is not None:
        B, N, dev = res[0].shape[0], res[1].shape[0], res[1].device
    elif planes:
        (B, N), dev = planes[0].shape, planes[0].device
    else:
        raise ValueError(f"{c}: no static row and no term")
    sb = None if vsbase is None else checked(c, vsbase, torch.float32, (B, N), dev)
    planes = [checked(c, p, torch.float32, (B, N), dev) for p in planes]
    R = 0
    req = alloc = nreq = None
    if res is not None:
        R = res[0].shape[1]
        if R > MAX_RESOURCES:
            raise ValueError(f"{c}: {R} resources > {MAX_RESOURCES}")
        req = checked(c, res[0], torch.float32, (B, R), dev)
        alloc = checked(c, res[1], torch.float32, (N, R), dev)
        nreq = checked(c, res[2], torch.float32, (N, R), dev)
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    field = [[t[k] for t in prog] for k in range(4)]
    err = _library().dyn_score_launch(
        B, N, R, len(prog), flags, ptr(sb), ptr(req), ptr(alloc), ptr(nreq),
        _ptrs(planes), (ctypes.c_int * MAX_TERMS)(*field[0]),
        (ctypes.c_int * MAX_TERMS)(*field[1]), (ctypes.c_float * MAX_TERMS)(*field[2]),
        (ctypes.c_int * MAX_TERMS)(*field[3]), (ctypes.c_float * MAX_RESOURCES)(*w100),
        bal, rn, ptr(out), stream_of(dev))
    raise_on_error(c, err)
    count_launch(c)
    return out


def _device(vsbase, terms) -> torch.device:
    if vsbase is not None:
        return vsbase.device
    v = terms[0][0]
    return (v.node_allocatable if isinstance(v, (FitScore, BalancedScore)) else v).device


def dyn_score(vsbase, terms):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = dyn_score_cuda if _device(vsbase, terms).type == "cuda" else dyn_score_plain
    return fn(vsbase, terms)
