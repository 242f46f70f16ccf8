"""K3 `interpod_terms` + `interpod_norm`: the inter-pod affinity and
topology-spread masks and scores of one round, for every pod of the view.

Reference: the multi-hot products of `k8s_scheduler_tpu/ops/interpod.py`
:358-486 — `affinity_mask_batched`, `affinity_score_batched`,
`spread_mask_batched`, `spread_score_batched` over the [K*S, N]
counts-by-node table. A pod has at most MA (MC) terms, so instead of
multiplying a [B, K*S] multi-hot by [K*S, N], the kernel
(csrc/interpod_terms.cu) gives each (pod, 256-node tile) block the pod's
terms once (duplicate (selector, key) slots merged in slot order, rows
ascending: the reference's summation order) and reads the counts it needs
straight from the [S, D] table through each node's domain ids:

- required affinity: every needed term's count > 0, a term needed unless
  it bootstraps (`total[sel] == 0` and the pod matches `sel`);
- required anti-affinity: no term's count > 0, and no placed pod's anti
  term covers the node (symmetric; `sym_anti`);
- DoNotSchedule spread: count + 1 - minc <= maxSkew and the key present;
- raw preferred sum w * relu(count) plus the symmetric weights
  (`sym_pref`), and the raw ScheduleAnyway sum relu(count).

The two symmetric terms are [B, S] x [S, N] products of the pending match
table with the state's node tables: plain `torch.matmul` (TF32 off, 0/1
and integer operands: exact), as in the reference.

`interpod_norm` is the per-pod normalisation over the feasible nodes of
the COMBINED filter mask, so it runs after every filter, in its own
launch: hi = max over feasible of |raw| (raw for spread), then
raw / hi * 100 or (1 - raw / hi) * 100.

Bound on an H100: bytes — the [B, N] outputs (two masks, two raws) and the
symmetric inputs; the [S, D] counts stay in L2."""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..models import encoding as enc
from . import interpod as ip
from .kernel_build import (checked, count_launch, load_cuda_library, ptr,
                           raise_on_error, stream_of)

MAX_TERMS = 8  # csrc/interpod_terms.cu kMaxTerms (MA, MC)
MAX_KEYS = 8  # kMaxKeys (K)


@dataclasses.dataclass
class InterpodTerms:
    """One round's terms for every pod of the view; None where the
    snapshot has no affinity (aff_*) or no spread (spread_*)."""

    aff_mask: torch.Tensor | None  # bool [B, N]
    aff_raw: torch.Tensor | None  # f32 [B, N]
    spread_mask: torch.Tensor | None  # bool [B, N]
    spread_raw: torch.Tensor | None  # f32 [B, N]


def interpod_terms_plain(snap, state: ip.AffinityState, m_pending,
                         minc) -> InterpodTerms:
    """The reference's algebra over the counts-by-node table, computed once
    for both plugins."""
    cbn = ip.counts_by_node(snap, state)
    out = InterpodTerms(None, None, None, None)
    if snap.has_inter_pod_affinity:
        out.aff_mask = ip.affinity_mask_batched(snap, state, m_pending, cbn)
        out.aff_raw = ip.affinity_raw_batched(snap, state, m_pending, cbn)
    if snap.has_topology_spread:
        out.spread_mask = ip.spread_mask_batched(snap, state, cbn, minc)
        out.spread_raw = ip.spread_raw_batched(snap, cbn)
    return out


def _terms_library():
    lib = load_cuda_library("interpod_terms")
    if lib.interpod_terms_launch.argtypes is None:
        lib.interpod_terms_launch.argtypes = (
            [ctypes.c_int] * 10 + [ctypes.c_void_p] * 18
        )
        lib.interpod_terms_launch.restype = ctypes.c_int
        lib.interpod_norm_launch.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
        )
        lib.interpod_norm_launch.restype = ctypes.c_int
    return lib


def interpod_terms_cuda(snap, state: ip.AffinityState, m_pending,
                        minc) -> InterpodTerms:
    """Launch csrc/interpod_terms.cu on the current stream (the symmetric
    products first, as torch.matmul)."""
    B, N = snap.P, snap.N
    S, D = state.counts.shape
    K = snap.node_domains.shape[1]
    MA = snap.pod_aff_terms.shape[1]
    MC = snap.pod_tsc.shape[1]
    dev = state.counts.device
    if max(MA, MC) > MAX_TERMS or K > MAX_KEYS:
        raise ValueError(f"interpod_terms: MA={MA}, MC={MC}, K={K} over the "
                         f"kernel's limits ({MAX_TERMS} terms, {MAX_KEYS} keys)")
    aff, spread = bool(snap.has_inter_pod_affinity), bool(snap.has_topology_spread)
    c = "interpod_terms"
    keep = [
        checked(c, state.counts, torch.float32, (S, D), dev),
        checked(c, state.total, torch.float32, (S,), dev),
        checked(c, snap.node_domains, torch.int32, (N, K), dev),
        checked(c, minc, torch.float32, (K * S,), dev) if spread else None,
        checked(c, m_pending, torch.bool, (S, B), dev),
        checked(c, snap.pod_aff_terms, torch.int32, (B, MA, 2), dev),
        checked(c, snap.pod_anti_terms, torch.int32, (B, MA, 2), dev),
        checked(c, snap.pod_pref_aff, torch.int32, (B, MA, 2), dev),
        checked(c, snap.pod_pref_aff_w, torch.float32, (B, MA), dev),
        checked(c, snap.pod_tsc, torch.int32, (B, MC, 3), dev),
        checked(c, snap.pod_tsc_skew, torch.int32, (B, MC), dev),
    ]
    out = InterpodTerms(None, None, None, None)
    sym_anti = sym_pref = None
    if aff:
        sym_anti = ip.symmetric_anti(state, m_pending)
        sym_pref = ip.symmetric_pref(state, m_pending)
        out.aff_mask = torch.empty((B, N), dtype=torch.bool, device=dev)
        out.aff_raw = torch.empty((B, N), dtype=torch.float32, device=dev)
    if spread:
        out.spread_mask = torch.empty((B, N), dtype=torch.bool, device=dev)
        out.spread_raw = torch.empty((B, N), dtype=torch.float32, device=dev)
    err = _terms_library().interpod_terms_launch(
        B, N, S, D, K, MA, MC, int(aff), int(spread), enc.WHEN_DO_NOT_SCHEDULE,
        *[ptr(t) for t in keep], ptr(sym_anti), ptr(sym_pref),
        ptr(out.aff_mask), ptr(out.aff_raw), ptr(out.spread_mask),
        ptr(out.spread_raw), stream_of(dev),
    )
    raise_on_error(c, err)
    count_launch(c)
    return out


def interpod_terms(snap, state: ip.AffinityState, m_pending, minc) -> InterpodTerms:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if state.counts.device.type == "cuda":
        return interpod_terms_cuda(snap, state, m_pending, minc)
    return interpod_terms_plain(snap, state, m_pending, minc)


def interpod_norm_plain(raw, feasible, spread: bool) -> torch.Tensor:
    if spread:
        return ip.normalize_spread(raw, feasible)
    return ip.normalize_affinity(raw, feasible)


def interpod_norm_cuda(raw, feasible, spread: bool) -> torch.Tensor:
    """Launch the normalisation kernel of csrc/interpod_terms.cu."""
    B, N = raw.shape
    dev = raw.device
    keep = [checked("interpod_norm", raw, torch.float32, (B, N), dev),
            checked("interpod_norm", feasible, torch.bool, (B, N), dev)]
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    err = _terms_library().interpod_norm_launch(
        B, N, int(spread), ptr(keep[0]), ptr(keep[1]), ptr(out), stream_of(dev)
    )
    raise_on_error("interpod_norm", err)
    count_launch("interpod_norm")
    return out


def interpod_norm(raw, feasible, spread: bool) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = interpod_norm_cuda if raw.device.type == "cuda" else interpod_norm_plain
    return fn(raw, feasible, spread)
