"""K9 `preempt_claim`: preemption's serial claim loop in one launch.

Reference: `k8s_scheduler_tpu/ops/preemption.py:402-576` (`step` under a
`while_loop` bounded by the live count). `preemption.claim_loop_plain` is
the plain version (a host loop of ~40 small launches per step, after a
host read of the live count); this module launches csrc/preempt_claim.cu
for CUDA tensors: one persistent block of 1024 threads that reads the live
count from device memory and runs every step, with a block-wide
lexicographic argmin per step and the carry in device memory — one launch
per cycle, no host synchronisation inside the loop. Latency-bound on an
H100 (one block, dependent steps)."""

from __future__ import annotations

import ctypes

import torch

from .kernel_build import (checked, count_launch, load_cuda_library, ptr,
                           raise_on_error, stream_of)
from .preemption import ClaimCarry, ClaimInputs, claim_carry0, claim_loop_plain

MAX_RESOURCES = 8  # csrc/preempt_claim.cu kMaxR
MAX_PDBS_PER_POD = 4  # csrc/preempt_claim.cu kMaxMB


def _library():
    lib = load_cuda_library("preempt_claim")
    if lib.preempt_claim_launch.argtypes is None:
        lib.preempt_claim_launch.argtypes = (
            [ctypes.c_int] * 8 + [ctypes.c_void_p] * 24 + [ctypes.c_void_p]
        )
        lib.preempt_claim_launch.restype = ctypes.c_int
    return lib


def preempt_claim_cuda(x: ClaimInputs) -> tuple[torch.Tensor, ClaimCarry]:
    """Launch csrc/preempt_claim.cu on the current stream."""
    t = x.tables
    C2, R = x.req.shape
    MP = x.port_ids.shape[1]
    N, MPN = t.node_pods.shape
    MB = t.vict_pdb.shape[2]
    GP = x.pdb_allowed.shape[0]
    dev = x.req.device
    if R > MAX_RESOURCES or MB > MAX_PDBS_PER_POD:
        raise ValueError(f"preempt_claim: {R} resources / {MB} PDBs per pod over "
                         f"{MAX_RESOURCES} / {MAX_PDBS_PER_POD}")
    k = "preempt_claim"
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    keep = [
        checked(k, x.n_live, i32, (1,), dev),
        checked(k, x.live, b8, (C2,), dev),
        checked(k, x.prio, i32, (C2,), dev),
        checked(k, x.req, f32, (C2, R), dev),
        checked(k, x.port_ids, i32, (C2, MP), dev),
        checked(k, x.gate, b8, (C2, N), dev),
        checked(k, x.ok_nr, b8, (C2, N, MPN + 1), dev),
        checked(k, x.node_valid, b8, (N,), dev),
        checked(k, x.alloc, f32, (N, R), dev),
        checked(k, x.node_requested, f32, (N, R), dev),
        checked(k, x.slack, f32, (N, R), dev),
        checked(k, x.pdb_allowed, i32, (GP,), dev),
        checked(k, t.node_pods, i32, (N, MPN), dev),
        checked(k, t.vict_prio, i32, (N, MPN), dev),
        checked(k, t.vict_start, f32, (N, MPN), dev),
        checked(k, t.vict_pdb, i32, (N, MPN, MB), dev),
        checked(k, t.prefix_freed, f32, (N, MPN + 1, R), dev),
        checked(k, t.prefix_prio, i32, (N, MPN + 1), dev),
    ]
    noms = torch.empty(C2, dtype=i32, device=dev)
    cy = claim_carry0(x)
    err = _library().preempt_claim_launch(
        C2, N, MPN, R, MB, GP, x.num_ports, MP, *[ptr(v) for v in keep],
        ptr(noms), ptr(cy.k_claimed), ptr(cy.nominated_req), ptr(cy.victims),
        ptr(cy.pdb_used), ptr(cy.claimed_q), stream_of(dev))
    raise_on_error(k, err)
    count_launch(k)
    return noms, cy


def preempt_claim(x: ClaimInputs) -> tuple[torch.Tensor, ClaimCarry]:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = preempt_claim_cuda if x.req.device.type == "cuda" else claim_loop_plain
    return fn(x)
