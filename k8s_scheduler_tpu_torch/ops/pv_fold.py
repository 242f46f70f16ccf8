"""K12 `pv_fold`: a round's static-PV claims folded into the claim bitmap,
the whole fixed-point loop in one launch.

Reference: `k8s_scheduler_tpu/ops/volumes.py:419 fold_pv_claims` (a
`while_loop` of rank-arbitrated passes). `volumes.pv_fold_plain` is the
plain version (a host loop that reads the loop condition every pass);
this module launches csrc/pv_fold.cu for CUDA tensors: one persistent
block of 1024 threads runs every pass and reads the loop condition on the
device, with K11's choice (csrc/pv_common.cuh pv::choose)."""

from __future__ import annotations

import ctypes

import torch

from . import volumes
from .kernel_build import (checked, count_launch, load_cuda_library, ptr,
                           raise_on_error, stream_of)
from .volume_mask import CTX_ARGTYPES, ctx_args, ctx_dims, sdr_tables

def _library():
    lib = load_cuda_library("pv_fold")
    if lib.pv_fold_launch.argtypes is None:
        lib.pv_fold_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + CTX_ARGTYPES
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 6)
        lib.pv_fold_launch.restype = ctypes.c_int
    return lib


def pv_fold_cuda(snap, tables: volumes.VolumeTables, pv_claimed, accepted,
                 node_of, rank) -> torch.Tensor:
    """Launch csrc/pv_fold.cu on the current stream."""
    k = "pv_fold"
    B, MVol = snap.pod_vol_mode.shape
    V = snap.pv_avail.shape[0]
    dev = snap.device
    ctx = ctx_args(k, snap, tables)
    keep = [checked(k, node_of, torch.int32, (B,), dev),
            checked(k, accepted, torch.bool, (B,), dev),
            checked(k, rank, torch.int32, (B,), dev)]
    claimed = checked(k, pv_claimed, torch.bool, (V,), dev).clone()
    masks, off = sdr_tables(MVol, str(dev))
    i32 = torch.int32
    winner = torch.empty(V, dtype=i32, device=dev)
    chs = torch.empty(B, dtype=i32, device=dev)
    pend = torch.empty(B, dtype=i32, device=dev)
    err = _library().pv_fold_launch(
        ptr(claimed), B, *ctx_dims(snap, tables), *[ptr(t) for t in ctx],
        *[ptr(t) for t in keep], int(volumes._multi(snap)), ptr(masks), ptr(off),
        ptr(winner), ptr(chs), ptr(pend), stream_of(dev))
    raise_on_error(k, err)
    count_launch(k)
    return claimed


def pv_fold(snap, tables: volumes.VolumeTables, pv_claimed, accepted, node_of,
            rank) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = pv_fold_cuda if snap.device.type == "cuda" else volumes.pv_fold_plain
    return fn(snap, tables, pv_claimed, accepted, node_of, rank)
