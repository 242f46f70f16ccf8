"""K4 `affinity_update`: fold a round's accepted placements into the
affinity state.

Reference: `k8s_scheduler_tpu/ops/interpod.py:489-548
affinity_update_batched`, which does it with one-hot products ([S, P] x
[P, D] per key, [S, P] x [P, N] per term slot). For each accepted pod p on
node n the new tables are the old ones plus:

- counts[s, domain(n, k)] += 1 and total[s] += 1 for every selector s the
  pod matches and every key k where n has a domain;
- anti_presence[sel, m] = 1 for every node m in the domain of each of p's
  required anti terms (sel, k) (a hostname term touches one node, a zone
  term about N/6);
- pref_sym[sel, m] += w for every node m in the domain of each preferred
  term (sel, k, w).

csrc/affinity_update.cu does it in two launches: a pass that puts the
round's term updates into domain space ([S, D] scratch tables), then a
pass, a block per selector row, that writes each new row from the old one
in one stream: the counts row with the row's matching pods added, and the
anti and preferred rows with the row's domain tables folded in where the
round touched them. The sums use f32 atomics. Every added value is an
integer (counts, and the API's int32 preference weights) and every
table entry stays below 2^24, so each sum is exact in any order: the
result does not depend on the order the atomics land in (chip_smoke.py
checks max |pref_sym| < 2^24 on the card). The wrapper returns new tables,
as the reference does (and, as the reference does, the old anti and
preferred tables themselves when the snapshot has no inter-pod affinity).

The scratch tables ([S, D] anti marks and preferred sums, [2, S] touched
rows) come zeroed from the caching allocator on every call, one memset of
5 S D bytes (12.5 MB at S = 500, D = 5008; only the [2, S] rows without
inter-pod affinity): nothing is kept between calls, so calls on any
stream, or in a CUDA graph, are independent.

Bound on an H100: bytes — the [S, B] match table read once, the old
tables read once and the new ones written once."""

from __future__ import annotations

import ctypes

import torch

from . import interpod as ip
from .kernel_build import (checked, count_launch, load_cuda_library, ptr,
                           raise_on_error, stream_of)

affinity_update_plain = ip.affinity_update_batched


def _library():
    lib = load_cuda_library("affinity_update")
    if lib.affinity_update_fold.argtypes is None:
        lib.affinity_update_fold.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 19
        lib.affinity_update_fold.restype = ctypes.c_int
    return lib


SMEM_LIMIT = 232448  # csrc/affinity_update.cu kSmemLimit: the fold's [D] row, 5 B a domain


def _zeroed_scratch(dev, S: int, D: int) -> tuple[torch.Tensor, ...]:
    """(anti_dom [S, D] u8, pref_dom [S, D] f32, touched [2, S] u8), zero,
    from one allocation and one memset."""
    buf = torch.zeros(S * D * 5 + 2 * S, dtype=torch.uint8, device=dev)
    return (buf[S * D * 4:S * D * 5].view(S, D), buf[:S * D * 4].view(torch.float32).view(S, D),
            buf[S * D * 5:].view(2, S))


def affinity_update_cuda(snap, state: ip.AffinityState, m_pending, accepted,
                         node_of) -> ip.AffinityState:
    """Launch csrc/affinity_update.cu on the current stream: new tables
    from the old ones."""
    B, N = snap.P, snap.N
    S, D = state.counts.shape
    K = snap.node_domains.shape[1]
    MA = snap.pod_anti_terms.shape[1]
    dev = state.counts.device
    c = "affinity_update"
    if 5 * D > SMEM_LIMIT:
        raise ValueError(f"{c}: D={D} domains; the fold stages at most "
                         f"{SMEM_LIMIT // 5} a row")
    do_aff = bool(snap.has_inter_pod_affinity)
    keep = [
        checked(c, m_pending, torch.bool, (S, B), dev),
        checked(c, accepted, torch.bool, (B,), dev),
        checked(c, node_of, torch.int32, (B,), dev),
        checked(c, snap.node_domains, torch.int32, (N, K), dev),
        checked(c, snap.pod_anti_terms, torch.int32, (B, MA, 2), dev),
        checked(c, snap.pod_pref_aff, torch.int32, (B, MA, 2), dev),
        checked(c, snap.pod_pref_aff_w, torch.float32, (B, MA), dev),
        checked(c, state.counts, torch.float32, (S, D), dev),
        checked(c, state.total, torch.float32, (S,), dev),
        checked(c, state.anti_presence, torch.bool, (S, N), dev),
        checked(c, state.pref_sym, torch.float32, (S, N), dev),
    ]
    out = ip.AffinityState(
        torch.empty((S, D), dtype=torch.float32, device=dev),
        torch.empty((S,), dtype=torch.float32, device=dev),
        torch.empty((S, N), dtype=torch.bool, device=dev) if do_aff else state.anti_presence,
        torch.empty((S, N), dtype=torch.float32, device=dev) if do_aff else state.pref_sym,
    )
    err = _library().affinity_update_fold(
        B, N, S, D, K, MA, int(do_aff), *[ptr(t) for t in keep],
        ptr(out.counts), ptr(out.total), ptr(out.anti_presence if do_aff else None),
        ptr(out.pref_sym if do_aff else None),
        *[ptr(t) for t in _zeroed_scratch(dev, S, D if do_aff else 0)], stream_of(dev),
    )
    raise_on_error(c, err)
    count_launch(c)
    return out


def affinity_update(snap, state: ip.AffinityState, m_pending, accepted,
                    node_of) -> ip.AffinityState:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = affinity_update_cuda if state.counts.device.type == "cuda" else affinity_update_plain
    return fn(snap, state, m_pending, accepted, node_of)
