"""K18 `extender_merge`: the carry cycle's base, f32 [P, N], from the carried
static base in one pass.

Reference: `k8s_scheduler_tpu/core/cycle.py:1349-1367`
(`build_packed_cycle_carry_fn`):

    sbase_all = where(emask, sbase + escore, NEG_INF)   # HTTP-extender verdicts
    sbase     = where(sampling_mask, sbase_all, NEG_INF)  # percentageOfNodesToScore

with the verdicts the `ExtenderVerdictKeeper`'s device planes (or a
snapshot's `pod_extender_mask` / `pod_extender_score`), and the sampling
window (the port's `core/cycle.py sampling_params`): node c is a
candidate of pod p iff (c - off[p]) mod n < k. Either part may be absent: without verdicts the
pass is the sampling window alone (the main path's carry cycle), without
the window the merge alone. The reference reads `sbase_all` nowhere else,
so the kernel writes the one output.

`extender_merge_triton` is a Triton kernel (added for the port; no
Pallas kernel existed, XLA fused the two `where`s): a program per (pod
row, 2048-node tile), the row's window offset and the window's length and
modulus read on the device (no host sync), the add in f32 as the
reference's. Bound on an H100: bytes — read sbase (4 B), emask (1 B) and
escore (4 B), write the base (4 B) a pair: 13 B, 1.745 GB at P=16384,
N=8192, 0.52 ms; 8 B a pair without the verdicts. `extender_merge_plain`
is the same function in torch. The wrapper runs the kernel for CUDA
tensors and the plain version for CPU tensors."""

from __future__ import annotations

import os

import torch

from .kernel_build import BUILD_DIR, checked, count_launch

NEG_INF = -1e9
BLOCK_N = 2048


def extender_merge_plain(sbase, emask=None, escore=None, sampling=None):
    """f32 [P, N]: `sbase` with the verdicts merged (`emask` bool [P, N],
    `escore` f32 [P, N], both or neither) and the sampling window applied
    (`sampling` = (off i32 [P], k i64 [], n i64 []) or None)."""
    P, N = sbase.shape
    dev = sbase.device
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    out = sbase
    if emask is not None:
        out = torch.where(emask, sbase + escore, neg)
    if sampling is not None:
        off, k, n = sampling
        col = torch.arange(N, dtype=torch.int64, device=dev)[None, :]
        out = torch.where(((col - off.to(torch.int64)[:, None]) % n) < k, out, neg)
    return out


_KERNEL = None


def _kernel():
    """Build the Triton kernel on first use (triton is imported here, never
    at module import: CPU-only machines have no triton)."""
    global _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def extender_merge_kernel(
        sbase_ptr, emask_ptr, escore_ptr, off_ptr, k_ptr, n_ptr, out_ptr, N,
        HAS_EXT: tl.constexpr, HAS_SAMPLE: tl.constexpr, BLOCK: tl.constexpr,
    ):
        row = tl.program_id(0)
        cols = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
        inb = cols < N
        idx = row.to(tl.int64) * N + cols
        s = tl.load(sbase_ptr + idx, mask=inb, other=0.0)
        if HAS_EXT:
            m = tl.load(emask_ptr + idx, mask=inb, other=0)
            e = tl.load(escore_ptr + idx, mask=inb, other=0.0)
            s = tl.where(m != 0, s + e, -1e9)
        if HAS_SAMPLE:
            off = tl.load(off_ptr + row)
            k = tl.load(k_ptr).to(tl.int32)
            n = tl.load(n_ptr).to(tl.int32)
            r = (cols - off) % n  # truncated: take it to the floor modulo
            r = tl.where(r < 0, r + n, r)
            s = tl.where(r < k, s, -1e9)
        tl.store(out_ptr + idx, s, mask=inb)

    _KERNEL = extender_merge_kernel
    return _KERNEL


def extender_merge_triton(sbase, emask=None, escore=None, sampling=None):
    """Launch K18 on the current stream."""
    if emask is None and sampling is None:
        raise ValueError("extender_merge: neither verdicts nor a sampling window")
    if (emask is None) != (escore is None):
        raise ValueError("extender_merge: emask and escore come together")
    P, N = sbase.shape
    dev = sbase.device
    k18 = "extender_merge"
    sbase = checked(k18, sbase, torch.float32, (P, N), dev)
    out = torch.empty((P, N), dtype=torch.float32, device=dev)
    if P == 0 or N == 0:
        return out
    if emask is not None:
        em = checked(k18, emask, torch.bool, (P, N), dev).view(torch.uint8)
        es = checked(k18, escore, torch.float32, (P, N), dev)
    else:
        em, es = sbase, sbase  # not read
    if sampling is not None:
        off, k, n = sampling
        off = checked(k18, off, torch.int32, (P,), dev)
        k = checked(k18, k, torch.int64, (), dev)
        n = checked(k18, n, torch.int64, (), dev)
    else:
        off = k = n = sbase  # not read
    _kernel()[(P, -(-N // BLOCK_N))](
        sbase, em, es, off, k, n, out, N,
        HAS_EXT=emask is not None, HAS_SAMPLE=sampling is not None,
        BLOCK=BLOCK_N, num_warps=8,
    )
    count_launch(k18)
    return out


def extender_merge(sbase, emask=None, escore=None, sampling=None):
    """The carry cycle's base: the kernel on CUDA, the plain version on CPU."""
    if sbase.device.type == "cuda":
        return extender_merge_triton(sbase, emask, escore, sampling)
    return extender_merge_plain(sbase, emask, escore, sampling)
