"""K8 `preempt_whatif`: preemption's non-resource what-if over the scan
candidates, bool [C2, N, MPN+1].

Reference: `k8s_scheduler_tpu/ops/preemption.py:246-398`
(nonresource_ok_batched). `preemption.nonresource_ok_plain` is the plain
version; this module launches csrc/preempt_whatif.cu for CUDA tensors:
one thread per (candidate, node), each victim's selector match and owned
anti terms gathered directly instead of the reference's one-hot products
over [S, N*MPN] tables. The inputs (`preemption.whatif_inputs`) keep the
[C2, S] x [S, D] symmetric-owner product as `torch.matmul`. Bound on an
H100: bytes (the verdicts written once, the node tables read once)."""

from __future__ import annotations

import ctypes

import torch

from .kernel_build import (checked, count_launch, load_cuda_library, ptr,
                           raise_on_error, stream_of)
from .preemption import WhatIfInputs, nonresource_ok_plain


def _library():
    lib = load_cuda_library("preempt_whatif")
    if lib.preempt_whatif_launch.argtypes is None:
        lib.preempt_whatif_launch.argtypes = (
            [ctypes.c_int] * 13 + [ctypes.c_void_p] * 19 + [ctypes.c_void_p]
        )
        lib.preempt_whatif_launch.restype = ctypes.c_int
    return lib


def preempt_whatif_cuda(x: WhatIfInputs) -> torch.Tensor:
    """Launch csrc/preempt_whatif.cu on the current stream."""
    C2, MP = x.ports.shape
    N, MPN = x.node_pods.shape
    K = x.node_domains.shape[1]
    E, MEP = x.exist_ports.shape
    dev = x.ports.device
    k = "preempt_whatif"
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    keep = [
        checked(k, x.node_pods, i32, (N, MPN), dev),
        checked(k, x.node_domains, i32, (N, K), dev),
        checked(k, x.ports, i32, (C2, MP), dev),
        checked(k, x.exist_ports, i32, (E, MEP), dev),
        checked(k, x.winner_conf, b8, (C2, N), dev),
    ]
    # the optional tables, in the launcher's argument order (null when the
    # snapshot has no affinity / spread)
    opt = dict.fromkeys(("anti", "aff", "tsc", "tsc_skew", "counts", "total",
                         "mp_c", "me", "exist_anti", "row_d", "sp_min1",
                         "sp_amin", "sp_min2"))
    S = D = MA = MC = 0
    if x.has_affinity or x.has_spread:
        S, D = x.counts.shape
        opt["counts"] = checked(k, x.counts, f32, (S, D), dev)
        opt["total"] = checked(k, x.total, f32, (S,), dev)
        opt["mp_c"] = checked(k, x.mp_c, b8, (C2, S), dev)
        opt["me"] = checked(k, x.me, b8, (S, E), dev)
    if x.has_affinity:
        MA = x.anti.shape[1]
        opt["anti"] = checked(k, x.anti, i32, (C2, MA, 2), dev)
        opt["aff"] = checked(k, x.aff, i32, (C2, MA, 2), dev)
        opt["exist_anti"] = checked(k, x.exist_anti, i32, (E, MA, 2), dev)
        opt["row_d"] = checked(k, x.row_d, f32, (C2, D), dev)
    if x.has_spread:
        MC = x.tsc.shape[1]
        opt["tsc"] = checked(k, x.tsc, i32, (C2, MC, 3), dev)
        opt["tsc_skew"] = checked(k, x.tsc_skew, i32, (C2, MC), dev)
        opt["sp_min1"] = checked(k, x.sp_min1, f32, (K * S,), dev)
        opt["sp_amin"] = checked(k, x.sp_amin, i32, (K * S,), dev)
        opt["sp_min2"] = checked(k, x.sp_min2, f32, (K * S,), dev)
    out = torch.empty((C2, N, MPN + 1), dtype=b8, device=dev)
    err = _library().preempt_whatif_launch(
        C2, N, MPN, K, S, D, E, MA, MC, MP, MEP, int(x.has_affinity),
        int(x.has_spread), *[ptr(t) for t in keep], *[ptr(t) for t in opt.values()],
        ptr(out), stream_of(dev))
    raise_on_error(k, err)
    count_launch(k)
    return out


def preempt_whatif(x: WhatIfInputs) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = preempt_whatif_cuda if x.ports.device.type == "cuda" else nonresource_ok_plain
    return fn(x)
