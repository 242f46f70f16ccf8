"""K5 `capacity`: rank-ordered capacity resolution of one acceptance pass,
after the (node, rank) sort.

Reference: `k8s_scheduler_tpu/ops/rounds.py:592-658 resolve_capacity`.
Claims sorted on the packed key node * 2^rank_bits + rank form one run per
node (dead claims carry node N and sort last). Within a run:

    seg_before = exclusive prefix of the claims' requests (f64, rounded once)
    fits       = all_r(seg_before + req <= (alloc - node_req) + slack)
    accepted[order] = fits
    node_req[node] += (sum of accepted requests, f64, rounded once)

The fold is `index_add_exact`'s: equal to the reference's f32 one-hot
product wherever that is exact (every request sum the encoder makes is a
dyadic multiple far below 2^53). With `check=False` every live claim is
accepted: the round-end revocation fold (`rounds.py:852`) and the same
kernel.

`capacity_plain` is the plain torch version (a global f64 cumsum and
segment-start differences); `capacity_cuda` launches csrc/capacity.cu: one
warp per node, so the work follows the claims — a 32-way cooperative search
for the node's run, then steps of one claim a lane and, past 32 claims, 8
consecutive claims a lane, each step one f64 warp scan by `__shfl_up_sync`
per resource; no shared memory and no barrier; a node with no claim costs
one search and copies its row. The kernel sums each run in another
order than the plain version's global cumsum; both are exact for the
encoder's requests (whole millicores, whole multiples of 2^20 bytes: every
f64 sum of up to 2^20 of them is exact in any order), so they agree bit for
bit. The kernel also clears the dead claims' accept flags, so the wrapper
allocates its outputs uninitialised. Bound on an H100: bytes (the sorted
keys, the permutation, the gathered requests and the [N, R] tables, each
read once; about 0.3 us for a round-0 pass): in practice one launch and a
dependent search per node. The sort itself stays `torch.sort`, as the
reference's stays `lax.sort`."""

from __future__ import annotations

import ctypes

import torch

from .kernel_build import (checked, count_launch, load_cuda_library, ptr,
                           raise_on_error, stream_of)

MAX_RESOURCES = 8  # csrc/capacity.cu kMaxR


def index_add_exact(target: torch.Tensor, idx: torch.Tensor,
                    rows: torch.Tensor) -> torch.Tensor:
    """target + (rows summed per index), with each index's sum taken in f64
    in a fixed order and rounded once: deterministic on every device, and
    equal to the reference's f32 one-hot product wherever that is exact."""
    if idx.numel() == 0:
        return target
    order = torch.argsort(idx, stable=True)
    s_idx = idx[order].long()
    s_rows = rows[order].to(torch.float64)
    cum = torch.cumsum(s_rows, dim=0)
    last = torch.ones_like(s_idx, dtype=torch.bool)
    last[:-1] = s_idx[1:] != s_idx[:-1]
    ends = cum[last]
    totals = ends - torch.cat([ends.new_zeros((1,) + ends.shape[1:]), ends[:-1]])
    return target.index_add(0, s_idx[last], totals.to(target.dtype))


def capacity_plain(s_key, order, rank_bits: int, req, node_req, alloc, slack,
                   check: bool = True):
    """(accepted bool [B], node_req' f32 [N, R]) for claims sorted on
    `s_key` (i64 [B]) with permutation `order` (i64 [B])."""
    B = s_key.shape[0]
    N = node_req.shape[0]
    dev = s_key.device
    s_node = s_key >> rank_bits
    s_live = s_node < N
    s_req = torch.where(s_live[:, None], req[order], torch.zeros((), device=dev))
    if check:
        x = s_req.to(torch.float64)
        before = torch.cumsum(x, dim=0) - x
        i = torch.arange(B, device=dev)
        seg_start = torch.ones(B, dtype=torch.bool, device=dev)
        seg_start[1:] = s_node[1:] != s_node[:-1]
        seg_first = torch.cummax(torch.where(seg_start, i, -1), dim=0).values
        seg_before = (before - before[seg_first]).to(torch.float32)
        nsafe = s_node.clamp(0, N - 1)
        free = (alloc[nsafe] - node_req[nsafe]) + slack[nsafe]
        fits = torch.all(seg_before + s_req <= free, dim=1) & s_live
    else:
        fits = s_live
    accepted = torch.zeros(B, dtype=torch.bool, device=dev)
    accepted[order] = fits
    return accepted, index_add_exact(node_req, s_node[fits], s_req[fits])


def _library():
    lib = load_cuda_library("capacity")
    if lib.capacity_launch.argtypes is None:
        lib.capacity_launch.argtypes = (
            [ctypes.c_int] * 5 + [ctypes.c_void_p] * 8 + [ctypes.c_void_p]
        )
        lib.capacity_launch.restype = ctypes.c_int
    return lib


def capacity_cuda(s_key, order, rank_bits: int, req, node_req, alloc, slack,
                  check: bool = True):
    """Launch csrc/capacity.cu on the current stream."""
    B = s_key.shape[0]
    N, R = node_req.shape
    dev = node_req.device
    if R > MAX_RESOURCES:
        raise ValueError(f"capacity: {R} resources > {MAX_RESOURCES}")
    keep = [
        checked("capacity", s_key, torch.int64, (B,), dev),
        checked("capacity", order, torch.int64, (B,), dev),
        checked("capacity", req, torch.float32, (B, R), dev),
        checked("capacity", node_req, torch.float32, (N, R), dev),
        checked("capacity", alloc, torch.float32, (N, R), dev),
        checked("capacity", slack, torch.float32, (N, R), dev),
    ]
    accepted = torch.empty(B, dtype=torch.bool, device=dev)
    out = torch.empty_like(keep[3])
    err = _library().capacity_launch(
        B, N, R, rank_bits, int(check), *[ptr(t) for t in keep],
        ptr(accepted), ptr(out), stream_of(dev),
    )
    raise_on_error("capacity", err)
    count_launch("capacity")
    return accepted, out


def capacity(s_key, order, rank_bits: int, req, node_req, alloc, slack,
             check: bool = True):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = capacity_cuda if node_req.device.type == "cuda" else capacity_plain
    return fn(s_key, order, rank_bits, req, node_req, alloc, slack, check)
