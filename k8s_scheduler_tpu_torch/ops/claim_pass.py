"""K2 `claim_pass`: one wide acceptance pass of the rounds engine — every
row claims its best still-available node.

Reference: the pass body at `k8s_scheduler_tpu/ops/rounds.py:805-823`:

    avail = mask & ~dead & ~acc[:, None]
    eff   = where(avail, round(base + delta[None, :]) + _tie_break(gid, N), NEG_INF)
    best  = argmax_first(eff)                  # nominated node first if available
    has   = avail[pid, best]

`claim_pass_plain` is that expression in torch; `claim_pass_triton` is the
Triton kernel (one program per row: fused mask/round/hash over BLOCK_N
tiles with a running first-index max). Bound on an H100: bytes — each
pass reads base (4 B), mask (1 B) and dead (1 B) per element once; rows
already accepted are not read at all. The wrapper runs the kernel for
CUDA tensors and the plain version for CPU tensors."""

from __future__ import annotations

import torch

from . import argsel, kernel_build
from .kernel_build import count_launch

NEG_INF = -1e9
# Claim scores are rounded to integers before the hash tie-break (the
# upstream scheduler's own granularity); the hash spread stays strictly
# below the integer quantum.
TIE_EPS = 0.9375
_PR1 = 2654435761
_PR2 = 40503


def tie_break(gid: torch.Tensor, N: int) -> torch.Tensor:
    """f32 [B, N] in [0, TIE_EPS), keyed on GLOBAL pod id. The reference
    hashes in u32 and keeps 16 bits; the low 16 bits of the wrapped u32
    sum equal those of the exact int64 sum."""
    p = gid.to(torch.int64)[:, None]
    n = torch.arange(N, dtype=torch.int64, device=gid.device)[None, :]
    h = (p * _PR1 + n * _PR2) & 0xFFFF
    return h.to(torch.float32) * (TIE_EPS / 65536.0)


def claim_pass_plain(base, mask, dead, acc, delta, gid, nominated):
    """(best i32 [B], has bool [B]) for one pass; `delta` f32 [N] or None
    (pass 0), `nominated` i32 [B] node index or -1."""
    B, N = base.shape
    avail = mask & ~dead & ~acc[:, None]
    x = base if delta is None else base + delta[None, :]
    scored = torch.round(x) + tie_break(gid, N)
    eff = torch.where(avail, scored, torch.full((), NEG_INF, device=base.device))
    pid = torch.arange(B, device=base.device)
    nom = nominated.clamp(0, N - 1).long()
    nom_ok = (nominated >= 0) & avail[pid, nom]
    best = torch.where(nom_ok, nom.to(torch.int32), argsel.argmax_first(eff, dim=1))
    return best, avail[pid, best.long()]


_KERNEL = None


def _kernel():
    """Build the Triton kernel on first use (triton is imported here, never
    at module import: CPU-only machines have no triton)."""
    global _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    # Triton's compile cache stays inside the build directory
    kernel_build.triton_cache_dir()
    import triton
    import triton.language as tl

    try:
        from triton.language.extra import libdevice
    except ImportError:  # older triton layout
        from triton.language.extra.cuda import libdevice

    @triton.jit
    def claim_pass_kernel(
        base_ptr, mask_ptr, dead_ptr, acc_ptr, delta_ptr, gid_ptr, nom_ptr,
        best_ptr, has_ptr, N,
        HAS_DELTA: tl.constexpr, BLOCK_N: tl.constexpr,
    ):
        row = tl.program_id(0)
        row_off = row.to(tl.int64) * N
        acc = tl.load(acc_ptr + row)
        if acc != 0:
            # an accepted row has no available node: argmax_first of an
            # all-NEG_INF row is index 0, and it holds nothing
            tl.store(best_ptr + row, 0)
            tl.store(has_ptr + row, 0)
        else:
            g = tl.load(gid_ptr + row).to(tl.int64)
            run_v = tl.full((), float("-inf"), tl.float32)
            run_i = tl.full((), 0, tl.int32)
            for start in range(0, N, BLOCK_N):
                cols = start + tl.arange(0, BLOCK_N)
                inb = cols < N
                b = tl.load(base_ptr + row_off + cols, mask=inb, other=0.0)
                m = tl.load(mask_ptr + row_off + cols, mask=inb, other=0)
                d = tl.load(dead_ptr + row_off + cols, mask=inb, other=1)
                if HAS_DELTA:
                    b = b + tl.load(delta_ptr + cols, mask=inb, other=0.0)
                # tie_break() inline: _PR1, _PR2 and TIE_EPS as literals
                h = (g * 2654435761 + cols.to(tl.int64) * 40503) & 0xFFFF
                tie = h.to(tl.float32) * (0.9375 / 65536.0)
                scored = libdevice.rint(b) + tie
                eff = tl.where((m != 0) & (d == 0), scored, -1e9)
                eff = tl.where(inb, eff, float("-inf"))
                bm = tl.max(eff, axis=0)
                bi = tl.min(tl.where(eff == bm, cols, 2147483647), axis=0)
                better = bm > run_v  # strict: earlier tiles keep ties
                run_i = tl.where(better, bi, run_i)
                run_v = tl.where(better, bm, run_v)
            nom = tl.load(nom_ptr + row)
            nom_c = tl.minimum(tl.maximum(nom, 0), N - 1)
            nm = tl.load(mask_ptr + row_off + nom_c)
            nd = tl.load(dead_ptr + row_off + nom_c)
            nom_ok = (nom >= 0) & (nm != 0) & (nd == 0)
            best = tl.where(nom_ok, nom_c, run_i)
            bm2 = tl.load(mask_ptr + row_off + best)
            bd2 = tl.load(dead_ptr + row_off + best)
            tl.store(best_ptr + row, best)
            tl.store(has_ptr + row, ((bm2 != 0) & (bd2 == 0)).to(tl.int8))

    _KERNEL = claim_pass_kernel
    return _KERNEL


def claim_pass_triton(base, mask, dead, acc, delta, gid, nominated):
    """Launch the Triton kernel on the current stream (one program per row)."""
    B, N = base.shape
    dev = base.device
    for name, t, dt, shape in (
        ("base", base, torch.float32, (B, N)),
        ("mask", mask, torch.bool, (B, N)),
        ("dead", dead, torch.bool, (B, N)),
        ("acc", acc, torch.bool, (B,)),
        ("gid", gid, torch.int32, (B,)),
        ("nominated", nominated, torch.int32, (B,)),
    ) + ((("delta", delta, torch.float32, (N,)),) if delta is not None else ()):
        if t.dtype != dt or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"claim_pass: {name} must be {dt} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    base = base.contiguous()
    mask_u8 = mask.contiguous().view(torch.uint8)
    dead_u8 = dead.contiguous().view(torch.uint8)
    acc_u8 = acc.contiguous().view(torch.uint8)
    best = torch.empty(B, dtype=torch.int32, device=dev)
    has = torch.empty(B, dtype=torch.uint8, device=dev)
    if B == 0:
        return best, has.bool()
    _kernel()[(B,)](
        base, mask_u8, dead_u8, acc_u8,
        delta.contiguous() if delta is not None else base,
        gid.contiguous(), nominated.contiguous(), best, has, N,
        HAS_DELTA=delta is not None, BLOCK_N=1024, num_warps=4,
    )
    count_launch("claim_pass")
    return best, has.view(torch.bool)


def claim_pass(base, mask, dead, acc, delta, gid, nominated):
    """(best, has) for one acceptance pass: the Triton kernel on CUDA, the
    plain version on CPU."""
    if base.device.type == "cuda":
        return claim_pass_triton(base, mask, dead, acc, delta, gid, nominated)
    return claim_pass_plain(base, mask, dead, acc, delta, gid, nominated)
