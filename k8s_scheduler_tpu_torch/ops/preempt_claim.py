"""K9 `preempt_claim`: preemption's serial claim loop in one launch.

Reference: `k8s_scheduler_tpu/ops/preemption.py:402-576` (`step` under a
`while_loop` bounded by the live count). `preemption.claim_loop_plain` is
the plain version (a host loop of ~40 small launches per step, after a
host read of the live count); this module launches csrc/preempt_claim.cu
for CUDA tensors: one thread-block cluster (16 CTAs where the card can
schedule them, else 8) that reads the live count from device memory and
runs every step, each CTA over its own slice of the nodes with the slice's
tables in shared memory, one cluster barrier per step to agree on the
lexicographic argmin — one launch per pass, no host synchronisation inside
the loop. Latency-bound on an H100 (dependent steps)."""

from __future__ import annotations

import ctypes

import torch

from . import kernel_build
from .kernel_build import (checked, count_launch, load_cuda_library, ptr,
                           raise_on_error, stream_of)
from .preemption import ClaimCarry, ClaimInputs, claim_carry0, claim_loop_plain

MAX_RESOURCES = 8  # csrc/preempt_claim.cu kMaxR
MAX_PDBS_PER_POD = 4  # csrc/preempt_claim.cu kMaxMB
# a CTA holds at most kThreads x kPer = 2048 nodes: 16 CTAs take 32768, the
# portable 8 (on a card that cannot schedule 16) 16384
MAX_NODES = 16 * 2048
MAX_NODES_PORTABLE = 8 * 2048


def _name() -> str:
    """The library launched: K9, or its last-max tie-break instance while
    the fuzz harness's engine_bug("tiebreak") is active."""
    return "preempt_claim_tie_last" if kernel_build.TIE_LAST else "preempt_claim"


def _library():
    lib = load_cuda_library(_name())
    if lib.preempt_claim_launch.argtypes is None:
        lib.preempt_claim_launch.argtypes = (
            [ctypes.c_int] * 8 + [ctypes.c_void_p] * 24 + [ctypes.c_void_p]
        )
        lib.preempt_claim_launch.restype = ctypes.c_int
    if hasattr(lib, "preempt_claim_shape") and lib.preempt_claim_shape.argtypes is None:
        lib.preempt_claim_shape.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
        lib.preempt_claim_shape.restype = ctypes.c_int
    return lib


def _dims(x: ClaimInputs) -> tuple[int, ...]:
    """(C2, N, MPN, R, MB, GP, MP), or ValueError on what the kernel does
    not take."""
    t = x.tables
    C2, R = x.req.shape
    N, MPN = t.node_pods.shape
    MB = t.vict_pdb.shape[2]
    GP = x.pdb_allowed.shape[0]
    if not 1 <= R <= MAX_RESOURCES or MB > MAX_PDBS_PER_POD or GP < 1:
        raise ValueError(f"preempt_claim: {R} resources / {MB} PDBs per pod / {GP} "
                         f"budgets; the kernel takes 1-{MAX_RESOURCES} / at most "
                         f"{MAX_PDBS_PER_POD} / at least 1")
    if N > MAX_NODES:
        raise ValueError(f"preempt_claim: {N} nodes; the kernel takes at most {MAX_NODES} "
                         f"(2048 a CTA of a 16-CTA cluster; {MAX_NODES_PORTABLE} on a card "
                         "that schedules only the portable 8)")
    return C2, N, MPN, R, MB, GP, x.port_ids.shape[1]


def claim_shape(x: ClaimInputs) -> dict:
    """The launch csrc/preempt_claim.cu makes for these inputs: the cluster
    size (CTAs), whether the victim tables are staged in shared memory, and
    a CTA's dynamic shared memory bytes."""
    C2, N, MPN, R, MB, GP, MP = _dims(x)
    lib = _library()
    shape = (ctypes.c_int * 3)()
    raise_on_error("preempt_claim",
                   lib.preempt_claim_shape(C2, N, MPN, R, MB, GP, MP, shape))
    return {"cluster": shape[0], "staged": bool(shape[1]), "smem": shape[2]}


def preempt_claim_cuda(x: ClaimInputs) -> tuple[torch.Tensor, ClaimCarry]:
    """Launch csrc/preempt_claim.cu on the current stream."""
    t = x.tables
    C2, N, MPN, R, MB, GP, MP = _dims(x)
    dev = x.req.device
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
    count_launch(_name())
    return noms, cy


def preempt_claim(x: ClaimInputs) -> tuple[torch.Tensor, ClaimCarry]:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = preempt_claim_cuda if x.req.device.type == "cuda" else claim_loop_plain
    return fn(x)
