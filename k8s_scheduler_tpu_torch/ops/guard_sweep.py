"""K6 `guard_sweep`: the round-end participant-table sweep of the rounds
engine, after the (group, rank) sort.

Reference: `k8s_scheduler_tpu/ops/rounds.py:342-514 guards_ok` with
`_seg_scan_tables` (:178). Every accepted claim emits entries (group key,
rank, role) — MATCH for each (matched selector, topology domain), ANTI
for its anti terms, BOOT/GMATCH for bootstrap groups, SPREAD (with a cap)
for its DoNotSchedule constraints, PORT for its host ports — into one
table sorted on the packed key * 2^rank_bits + rank. Per entry, the count
of each role in its group strictly before the entry's POD run (one pod's
own entries never block each other) decides:

    ANTI   ok iff no MATCH before        MATCH  ok iff no ANTI before
    BOOT   ok iff no BOOT/GMATCH before  SPREAD ok iff arrivals before < cap
    PORT   ok iff no PORT before         PV     ok iff no PV before

and a pod survives iff all its entries do. Entries keyed GK_INVALID are
padding. Equal packed keys belong to one pod's run, so the sort's tie
order never matters.

`guard_sweep_plain` is `_seg_scan_tables` over the whole table (int64
prefix counts, exact); `guard_sweep_cuda` launches csrc/guard_sweep.cu:
one kernel lists the group starts, a second sweeps each group with one
warp (ballot/popcount prefix counts, a carry across 32-entry chunks, and a
walk back of at most one pod's entries to its run start). Bound on an
H100: bytes (the sorted keys and the permutation, each read once)."""

from __future__ import annotations

import ctypes

import torch

from .kernel_build import (checked, count_launch, load_cuda_library, ptr,
                           raise_on_error, stream_of)

# participant role bits (the reference's _RB_*; csrc/guard_sweep.cu mirrors)
RB_MATCH = 1
RB_ANTI = 2
RB_BOOT = 4
RB_GMATCH = 8
RB_SPREAD = 16
RB_PORT = 32
RB_PV = 64
NO_CAP = 2**30  # cap of an entry that carries none


def seg_scan_tables(keys, pods, counts: dict[str, torch.Tensor]):
    """Entries sorted by (key, rank): for each 0/1 indicator column, the
    in-segment count strictly before each entry's POD."""
    L = keys.shape[0]
    i = torch.arange(L, device=keys.device)
    first = torch.ones((1,), dtype=torch.bool, device=keys.device)
    seg_start = torch.cat([first, keys[1:] != keys[:-1]])
    run_start = seg_start | torch.cat([first, pods[1:] != pods[:-1]])
    seg_first = torch.cummax(torch.where(seg_start, i, -1), dim=0).values
    run_first = torch.cummax(torch.where(run_start, i, -1), dim=0).values
    names = list(counts)
    x = torch.stack([counts[n] for n in names], dim=1).to(torch.int64)
    before = torch.cumsum(x, dim=0) - x
    delta = before[run_first] - before[seg_first]
    return {n: delta[:, c] for c, n in enumerate(names)}


def guard_sweep_plain(s_packed, perm, rank_bits: int, B: int, role_tab, caps,
                      gk_invalid: int) -> torch.Tensor:
    """ok bool [B] from the sorted table (`s_packed` i64 [L], `perm` i64
    [L] into the slot-major table, `role_tab` i32 [slots], `caps` i32 [L]
    in table order or None)."""
    keys_s = s_packed >> rank_bits
    slot = perm // B
    pods_s = perm - slot * B
    role_s = role_tab[slot]
    before = seg_scan_tables(keys_s, pods_s, {
        "match": role_s == RB_MATCH,
        "anti": role_s == RB_ANTI,
        "boot": role_s == RB_BOOT,
        "gmatch": role_s == RB_GMATCH,
        "port": role_s == RB_PORT,
        "pv": role_s == RB_PV,
        "arrive": (role_s == RB_MATCH) | (role_s == RB_SPREAD),
    })
    ok_e = torch.ones(keys_s.shape, dtype=torch.bool, device=keys_s.device)
    ok_e &= torch.where(role_s == RB_ANTI, before["match"] == 0, True)
    ok_e &= torch.where(role_s == RB_MATCH, before["anti"] == 0, True)
    ok_e &= torch.where(role_s == RB_BOOT,
                        (before["boot"] == 0) & (before["gmatch"] == 0), True)
    if caps is not None:
        ok_e &= torch.where(role_s == RB_SPREAD, before["arrive"] < caps[perm], True)
    ok_e &= torch.where(role_s == RB_PORT, before["port"] == 0, True)
    ok_e &= torch.where(role_s == RB_PV, before["pv"] == 0, True)
    ok_e |= keys_s == gk_invalid
    ok = torch.ones(B, dtype=torch.bool, device=keys_s.device)
    ok[pods_s[~ok_e]] = False
    return ok


def _library():
    lib = load_cuda_library("guard_sweep")
    if lib.guard_sweep_launch.argtypes is None:
        lib.guard_sweep_launch.argtypes = (
            [ctypes.c_int] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 8
        )
        lib.guard_sweep_launch.restype = ctypes.c_int
    return lib


def guard_sweep_cuda(s_packed, perm, rank_bits: int, B: int, role_tab, caps,
                     gk_invalid: int) -> torch.Tensor:
    """Launch csrc/guard_sweep.cu on the current stream."""
    L = s_packed.shape[0]
    dev = s_packed.device
    slots = role_tab.shape[0]
    if L != slots * B:
        raise ValueError(f"guard_sweep: table of {L} entries != {slots} slots x {B}")
    keep = [
        checked("guard_sweep", s_packed, torch.int64, (L,), dev),
        checked("guard_sweep", perm, torch.int64, (L,), dev),
        checked("guard_sweep", role_tab, torch.int32, (slots,), dev),
        None if caps is None else checked("guard_sweep", caps, torch.int32, (L,), dev),
    ]
    seg_list = torch.empty(L, dtype=torch.int32, device=dev)
    n_seg = torch.zeros(1, dtype=torch.int32, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    err = _library().guard_sweep_launch(
        L, B, rank_bits, slots, gk_invalid, *[ptr(t) for t in keep],
        ptr(seg_list), ptr(n_seg), ptr(ok), stream_of(dev),
    )
    raise_on_error("guard_sweep", err)
    count_launch("guard_sweep")
    return ok


def guard_sweep(s_packed, perm, rank_bits: int, B: int, role_tab, caps,
                gk_invalid: int) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = guard_sweep_cuda if s_packed.device.type == "cuda" else guard_sweep_plain
    return fn(s_packed, perm, rank_bits, B, role_tab, caps, gk_invalid)
