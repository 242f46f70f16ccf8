"""K11 `pv_choice`: the static PV each round claimant would bind per
volume slot, i32 [B, MVol] — the rounds engine's PV guard key.

Reference: `k8s_scheduler_tpu/ops/volumes.py:535 chosen_pv_slots` (with
`chosen_pv`, `chosen_pv_sdr`, `_sdr_safe_choice`, `_dyn_at_node`).
`volumes.pv_choice_plain` is the plain version; this module launches
csrc/pv_choice.cu for CUDA tensors: one thread per claimant walks its
node's list of available PVs in index order (csrc/pv_common.cuh
pv::choose, shared with K12)."""

from __future__ import annotations

import ctypes

import torch

from . import volumes
from .kernel_build import (checked, count_launch, load_cuda_library, ptr,
                           raise_on_error, stream_of)
from .volume_mask import CTX_ARGTYPES, ctx_args, ctx_dims, sdr_tables


def _library():
    lib = load_cuda_library("pv_choice")
    if lib.pv_choice_launch.argtypes is None:
        lib.pv_choice_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + CTX_ARGTYPES
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3)
        lib.pv_choice_launch.restype = ctypes.c_int
    return lib


def pv_choice_cuda(snap, tables: volumes.VolumeTables, pv_claimed, node_of,
                   active) -> torch.Tensor:
    """Launch csrc/pv_choice.cu on the current stream."""
    k = "pv_choice"
    B, MVol = snap.pod_vol_mode.shape
    dev = snap.device
    ctx = ctx_args(k, snap, tables)
    keep = [checked(k, node_of, torch.int32, (B,), dev),
            checked(k, active, torch.bool, (B,), dev),
            checked(k, pv_claimed, torch.bool, (snap.pv_avail.shape[0],), dev)]
    masks, off = sdr_tables(MVol, str(dev))
    out = torch.empty((B, MVol), dtype=torch.int32, device=dev)
    err = _library().pv_choice_launch(
        ptr(out), B, *ctx_dims(snap, tables), *[ptr(t) for t in ctx],
        *[ptr(t) for t in keep], int(volumes._multi(snap)), ptr(masks), ptr(off),
        stream_of(dev))
    raise_on_error(k, err)
    count_launch(k)
    return out


def pv_choice(snap, tables: volumes.VolumeTables, pv_claimed, node_of,
              active) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = pv_choice_cuda if snap.device.type == "cuda" else volumes.pv_choice_plain
    return fn(snap, tables, pv_claimed, node_of, active)
