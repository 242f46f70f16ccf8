"""K12 `pv_fold`: a round's static-PV claims folded into the claim bitmap,
the whole fixed-point loop in one launch.

Reference: `k8s_scheduler_tpu/ops/volumes.py:419 fold_pv_claims` (a
`while_loop` of rank-arbitrated passes). `volumes.pv_fold_plain` is the
plain version (a host loop that reads the loop condition every pass);
this module launches csrc/pv_fold.cu for CUDA tensors: one thread-block
cluster (16 CTAs where the card can schedule them, else the portable 8),
each CTA over a slice of the pod rows, whose claimants it lists in shared
memory, and over a slice of the PVs' winner entries, taken by a 32-bit
atomicMin across the cluster (double-buffered by the step's parity); two cluster barriers a slot, and the loop condition
read on the device. The choice is K11's (csrc/pv_common.cuh pv::choose).
`launch_shape` gives a launch's slices and shared memory without a card."""

from __future__ import annotations

import ctypes
import functools

import torch

from . import volumes
from .kernel_build import (checked, count_launch, load_cuda_library, ptr,
                           raise_on_error, stream_of)
from .volume_mask import CTX_ARGTYPES, ctx_args, ctx_dims, sdr_tables

CLUSTER, CLUSTER_PORTABLE = 16, 8  # csrc/pv_fold.cu: up to kMaxCluster CTAs
THREADS = 256  # a CTA's threads (kThreads)
SMEM_LIMIT = 227 * 1024 - 1024  # csrc/pv_fold.cu kSmemLimit


def launch_shape(B: int, V: int, cluster: int = CLUSTER) -> dict:
    """The launch for B pod rows and V PVs on a cluster of `cluster` CTAs:
    the rows a CTA lists at most (its blocks of 32, dealt round-robin), the
    winner entries it owns and its shared memory (8 bytes a PV: two
    buffers of 4-byte keys; 20 a row); ValueError naming the limit the
    inputs pass."""
    blocks = -(-B // 32)
    rows, vs = 32 * -(-blocks // cluster), -(-V // cluster)
    smem = vs * 8 + rows * 20
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"pv_fold: {B} pod rows and {V} PVs need {smem} bytes of shared memory a CTA "
            f"on a cluster of {cluster} (20 a row, 8 a PV); a CTA has at most {SMEM_LIMIT}")
    return {"cluster": cluster, "rows": rows, "vs": vs, "smem": smem}


def _library():
    lib = load_cuda_library("pv_fold")
    if lib.pv_fold_launch.argtypes is None:
        lib.pv_fold_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + CTX_ARGTYPES
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.pv_fold_launch.restype = ctypes.c_int
        lib.pv_fold_clusters.argtypes = [ctypes.c_int, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int)]
        lib.pv_fold_clusters.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _schedulable(lib, csize: int, smem: int) -> bool:
    """The card can run a cluster of `csize` CTAs of `smem` bytes each."""
    n = ctypes.c_int(0)
    raise_on_error("pv_fold", lib.pv_fold_clusters(csize, smem, ctypes.byref(n)))
    return n.value >= 1


def fold_shape(B: int, V: int, cluster: int = CLUSTER) -> dict:
    """The launch csrc/pv_fold.cu makes on this card: a cluster of `cluster`
    CTAs where the card can schedule it, else the portable 8
    (`launch_shape`'s dict); RuntimeError naming each shape tried when the
    card schedules none."""
    sizes = (cluster,) if cluster == CLUSTER_PORTABLE else (cluster, CLUSTER_PORTABLE)
    lib, tried = _library(), []
    for csize in sizes:
        try:
            shape = launch_shape(B, V, csize)
        except ValueError as e:
            tried.append(str(e))
            continue
        if _schedulable(lib, csize, shape["smem"]):
            return shape
        tried.append(f"the card schedules no cluster of {csize} CTAs with "
                     f"{shape['smem']} bytes of shared memory each")
    raise RuntimeError("pv_fold: no cluster shape this card can run: " + "; ".join(tried))


def pv_fold_cuda(snap, tables: volumes.VolumeTables, pv_claimed, accepted,
                 node_of, rank, cluster: int = CLUSTER) -> torch.Tensor:
    """Launch csrc/pv_fold.cu on the current stream (on a cluster of
    `cluster` CTAs where the card can schedule it, else the portable 8)."""
    k = "pv_fold"
    B, MVol = snap.pod_vol_mode.shape
    V = snap.pv_avail.shape[0]
    dev = snap.device
    ctx = ctx_args(k, snap, tables)
    keep = [checked(k, node_of, torch.int32, (B,), dev),
            checked(k, accepted, torch.bool, (B,), dev),
            checked(k, rank, torch.int32, (B,), dev)]
    claimed_in = checked(k, pv_claimed, torch.bool, (V,), dev)
    shape = fold_shape(B, V, cluster)
    masks, off = sdr_tables(MVol, str(dev))
    claimed = torch.empty(V, dtype=torch.bool, device=dev)
    err = _library().pv_fold_launch(
        ptr(claimed), B, *ctx_dims(snap, tables), *[ptr(t) for t in ctx],
        *[ptr(t) for t in keep], int(volumes._multi(snap)), ptr(masks), ptr(off),
        ptr(claimed_in), shape["cluster"], shape["rows"], shape["vs"], stream_of(dev))
    raise_on_error(k, err)
    count_launch(k)
    return claimed


def pv_fold(snap, tables: volumes.VolumeTables, pv_claimed, accepted, node_of,
            rank) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = pv_fold_cuda if snap.device.type == "cuda" else volumes.pv_fold_plain
    return fn(snap, tables, pv_claimed, accepted, node_of, rank)
