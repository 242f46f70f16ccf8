"""K4 `affinity_update`: fold a round's accepted placements into the
affinity state.

Reference: `k8s_scheduler_tpu/ops/interpod.py:489-548
affinity_update_batched`, which does it with one-hot products ([S, P] x
[P, D] per key, [S, P] x [P, N] per term slot). For each accepted pod p on
node n the kernel (csrc/affinity_update.cu) does the same sums directly:

- counts[s, domain(n, k)] += 1 and total[s] += 1 for every selector s the
  pod matches and every key k where n has a domain;
- anti_presence[sel, m] = 1 for every node m in the domain of each of p's
  required anti terms (sel, k) (a hostname term touches one node, a zone
  term about N/6);
- pref_sym[sel, m] += w for every node m in the domain of each preferred
  term (sel, k, w).

The sums use f32 atomics. Every added value is an integer (counts, and the
API's int32 preference weights) and every table entry stays below 2^24, so
each sum is exact in any order: the result does not depend on the order
the atomics land in (chip_smoke.py checks max |pref_sym| < 2^24 on the
card). The wrapper returns new tables, as the reference does.

Bound on an H100: bytes — the [S, B] match table and the touched table
entries, each read or written once."""

from __future__ import annotations

import ctypes

import torch

from . import interpod as ip
from .kernel_build import (checked, count_launch, load_cuda_library, ptr,
                           raise_on_error, stream_of)

affinity_update_plain = ip.affinity_update_batched


def _library():
    lib = load_cuda_library("affinity_update")
    if lib.affinity_update_launch.argtypes is None:
        lib.affinity_update_launch.argtypes = (
            [ctypes.c_int] * 7 + [ctypes.c_void_p] * 12
        )
        lib.affinity_update_launch.restype = ctypes.c_int
    return lib


def affinity_update_cuda(snap, state: ip.AffinityState, m_pending, accepted,
                         node_of) -> ip.AffinityState:
    """Launch csrc/affinity_update.cu on the current stream, on copies of
    the state tables."""
    B, N = snap.P, snap.N
    S, D = state.counts.shape
    K = snap.node_domains.shape[1]
    MA = snap.pod_anti_terms.shape[1]
    dev = state.counts.device
    c = "affinity_update"
    keep = [
        checked(c, m_pending, torch.bool, (S, B), dev),
        checked(c, accepted, torch.bool, (B,), dev),
        checked(c, node_of, torch.int32, (B,), dev),
        checked(c, snap.node_domains, torch.int32, (N, K), dev),
        checked(c, snap.pod_anti_terms, torch.int32, (B, MA, 2), dev),
        checked(c, snap.pod_pref_aff, torch.int32, (B, MA, 2), dev),
        checked(c, snap.pod_pref_aff_w, torch.float32, (B, MA), dev),
    ]
    out = ip.AffinityState(
        checked(c, state.counts, torch.float32, (S, D), dev).clone(),
        checked(c, state.total, torch.float32, (S,), dev).clone(),
        checked(c, state.anti_presence, torch.bool, (S, N), dev).clone(),
        checked(c, state.pref_sym, torch.float32, (S, N), dev).clone(),
    )
    err = _library().affinity_update_launch(
        B, N, S, D, K, MA, int(bool(snap.has_inter_pod_affinity)),
        *[ptr(t) for t in keep], ptr(out.counts), ptr(out.total),
        ptr(out.anti_presence), ptr(out.pref_sym), stream_of(dev),
    )
    raise_on_error(c, err)
    count_launch(c)
    return out


def affinity_update(snap, state: ip.AffinityState, m_pending, accepted,
                    node_of) -> ip.AffinityState:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = affinity_update_cuda if state.counts.device.type == "cuda" else affinity_update_plain
    return fn(snap, state, m_pending, accepted, node_of)
