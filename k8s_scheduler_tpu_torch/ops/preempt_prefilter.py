"""K7 `preempt_prefilter`: preemption's batched prefilter.

Reference: `k8s_scheduler_tpu/ops/preemption.py:201-232` (the
[C, N, MPN+1] fit table of the budgeted candidates against the post-cycle
state). `preemption.prefilter_plain` is the plain version; this module
launches csrc/preempt_prefilter.cu for CUDA tensors: one block per
candidate, nodes strided over its threads, a block-wide OR. Bound on an
H100: bytes (the [C, N] gate and the per-node victim tables)."""

from __future__ import annotations

import ctypes

import torch

from .kernel_build import (checked, count_launch, load_cuda_library, ptr,
                           raise_on_error, stream_of)
from .preemption import prefilter_plain

MAX_RESOURCES = 8  # csrc/preempt_prefilter.cu kMaxR


def _library():
    lib = load_cuda_library("preempt_prefilter")
    if lib.preempt_prefilter_launch.argtypes is None:
        lib.preempt_prefilter_launch.argtypes = (
            [ctypes.c_int] * 4 + [ctypes.c_void_p] * 9 + [ctypes.c_void_p]
        )
        lib.preempt_prefilter_launch.restype = ctypes.c_int
    return lib


def preempt_prefilter_cuda(prio, req, cand_ok, vict_prio, prefix_freed, free0,
                           gate, node_valid) -> torch.Tensor:  # bool [C]
    """Launch csrc/preempt_prefilter.cu on the current stream."""
    C, R = req.shape
    N, MPN = vict_prio.shape
    dev = req.device
    if R > MAX_RESOURCES:
        raise ValueError(f"preempt_prefilter: {R} resources > {MAX_RESOURCES}")
    k = "preempt_prefilter"
    keep = [
        checked(k, prio, torch.int32, (C,), dev),
        checked(k, req, torch.float32, (C, R), dev),
        checked(k, cand_ok, torch.bool, (C,), dev),
        checked(k, vict_prio, torch.int32, (N, MPN), dev),
        checked(k, prefix_freed, torch.float32, (N, MPN + 1, R), dev),
        checked(k, free0, torch.float32, (N, R), dev),
        checked(k, gate, torch.bool, (C, N), dev),
        checked(k, node_valid, torch.bool, (N,), dev),
    ]
    out = torch.empty(C, dtype=torch.bool, device=dev)
    err = _library().preempt_prefilter_launch(
        C, N, MPN, R, *[ptr(t) for t in keep], ptr(out), stream_of(dev))
    raise_on_error(k, err)
    count_launch(k)
    return out


def preempt_prefilter(prio, req, cand_ok, vict_prio, prefix_freed, free0, gate,
                      node_valid) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = preempt_prefilter_cuda if req.device.type == "cuda" else prefilter_plain
    return fn(prio, req, cand_ok, vict_prio, prefix_freed, free0, gate, node_valid)
