"""K10 `volume_mask`: VolumeBinding's feasibility plane, bool [B, N].

Reference: `k8s_scheduler_tpu/ops/volumes.py:159 volume_mask` (the static
variant, once per cycle and in the preemption gate) and `:208
volume_mask_unbound` (the unbound residue against the live claim bitmap,
once per round), with `_hall_ok` (:109). `volumes.volume_mask_plain` is
the plain version (the reference's dense [P, V] x [V, N] count products);
this module launches csrc/volume_mask.cu for CUDA tensors: one thread per
(pod, node) walks the node's short list of available PVs
(`volumes.VolumeTables`) and counts per slot and per Hall subset. Slot
subsets go in as bitmasks; above 6 slots the dominance-group membership
on the raw candidate sets comes from plain torch. At most
MAX_VOLUME_SLOTS volume slots per pod."""

from __future__ import annotations

import ctypes
import functools

import torch

from . import volumes
from .kernel_build import (checked, count_launch, load_cuda_library, ptr,
                           raise_on_error, stream_of)

MAX_VOLUME_SLOTS = 8  # csrc/pv_common.cuh kMaxVol


def _bits(subsets) -> list[int]:
    return [sum(1 << t for t in s) for s in subsets]


@functools.lru_cache(maxsize=None)
def _subset_masks(MVol: int, multi: bool, device: str) -> torch.Tensor:
    """i32 [n_sub]: the singletons, then (multi-volume) `_hall_subsets`."""
    subs = [(t,) for t in range(MVol)]
    if multi:
        subs += volumes._hall_subsets(MVol)
    return torch.tensor(_bits(subs), dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def sdr_tables(MVol: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(i32 masks, i32 [MVol + 1] offsets): `_sdr_other_subsets` of every
    slot as bitmasks, for csrc/pv_common.cuh pv::choose."""
    masks, off = [], [0]
    for j in range(MVol):
        masks += _bits(volumes._sdr_other_subsets(MVol, j))
        off.append(len(masks))
    return (torch.tensor(masks or [0], dtype=torch.int32, device=device),
            torch.tensor(off, dtype=torch.int32, device=device))


def ctx_args(kernel: str, snap, tables: volumes.VolumeTables) -> list:
    """The pv::Ctx operands (after N, V, Rq, MVol, G), checked, in order."""
    B, MVol = snap.pod_vol_mode.shape
    N, V, Rq = snap.N, snap.pv_avail.shape[0], tables.req.shape[0]
    dev = snap.device
    if MVol > MAX_VOLUME_SLOTS:
        raise ValueError(f"{kernel}: {MVol} volume slots per pod over {MAX_VOLUME_SLOTS}")
    i32, f32 = torch.int32, torch.float32
    L, G = tables.node_pv.shape[0], tables.global_pv.shape[0]
    return [
        checked(kernel, tables.node_off, i32, (N + 1,), dev),
        checked(kernel, tables.node_pv, i32, (L,), dev),
        checked(kernel, tables.global_pv, i32, (G,), dev),
        checked(kernel, snap.pv_class, i32, (V,), dev),
        checked(kernel, snap.pv_capacity, f32, (V,), dev),
        checked(kernel, tables.req, torch.bool, (Rq, N), dev),
        checked(kernel, snap.pod_vol_mode, i32, (B, MVol), dev),
        checked(kernel, snap.pod_vol_req, i32, (B, MVol), dev),
        checked(kernel, snap.pod_vol_class, i32, (B, MVol), dev),
        checked(kernel, snap.pod_vol_size, f32, (B, MVol), dev),
    ]


def ctx_dims(snap, tables: volumes.VolumeTables) -> list[int]:
    return [snap.N, snap.pv_avail.shape[0], tables.req.shape[0],
            snap.pod_vol_mode.shape[1], tables.global_pv.shape[0]]


CTX_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 10


def _membership_table(snap) -> torch.Tensor:
    """u8 [B, MVol, MVol]: [p, a, t] = slot t's raw candidate set is a
    subset of slot a's (`volumes._membership` on `pod_pv_cand`)."""
    MVol = snap.pod_vol_mode.shape[1]
    cands = [volumes.pod_pv_cand(snap, t) for t in range(MVol)]
    return torch.stack([torch.stack([volumes._membership(cands, a, t)
                                     for t in range(MVol)], dim=1)
                        for a in range(MVol)], dim=1).to(torch.uint8).contiguous()


def _library():
    lib = load_cuda_library("volume_mask")
    if lib.volume_mask_launch.argtypes is None:
        lib.volume_mask_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + CTX_ARGTYPES
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
        lib.volume_mask_launch.restype = ctypes.c_int
    return lib


def volume_mask_cuda(snap, tables: volumes.VolumeTables, pv_claimed,
                     unbound: bool) -> torch.Tensor:
    """Launch csrc/volume_mask.cu on the current stream."""
    k = "volume_mask"
    B, MVol = snap.pod_vol_mode.shape
    dev = snap.device
    ctx = ctx_args(k, snap, tables)
    claimed = None
    if pv_claimed is not None:
        claimed = checked(k, pv_claimed, torch.bool, (snap.pv_avail.shape[0],), dev)
    multi = volumes._multi(snap)
    subs = _subset_masks(MVol, multi, str(dev))
    member = _membership_table(snap) if multi and MVol > 6 else None
    out = torch.empty((B, snap.N), dtype=torch.bool, device=dev)
    err = _library().volume_mask_launch(
        ptr(out), B, *ctx_dims(snap, tables), *[ptr(t) for t in ctx], ptr(claimed),
        int(unbound), int(multi), ptr(subs), subs.shape[0], ptr(member), stream_of(dev))
    raise_on_error(k, err)
    count_launch(k)
    return out


def volume_mask(snap, tables: volumes.VolumeTables, pv_claimed,
                unbound: bool) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = volume_mask_cuda if snap.device.type == "cuda" else volumes.volume_mask_plain
    return fn(snap, tables, pv_claimed, unbound)
