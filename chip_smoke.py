#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`k8s_scheduler_tpu_torch`) on one
NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — `SnapshotEncoder.encode` then the rounds-
engine latency cycle `build_cycle_fn()(snapshot)` — at BASELINE config
#4's cluster size (5000 nodes, 12000 running pods) with config #2's
constraint mix on 10000 pending pods (node selectors, taints and
tolerations, no inter-pod affinity). Phases:

  1. device   — the card's name and power limit;
  2. build    — nvcc builds K1 `static_base` (csrc/static_base.cu), Triton
                compiles K2 `claim_pass`;
  3. kernels  — each kernel against its plain torch version at the main
                path's shapes, with timings and the card's bound;
  4. e2e      — a warm cycle, the same cycle on the plain versions (same
                assignment required), then three timed cycles whose
                placements are checked for validity with the port's plain
                functions, with launch counts read around them.

The second-to-last lines are the kernel table (JSON) and the card's
`nvidia-smi` name and power limit; the last line is the result JSON.
Exits non-zero, printing no result, without a CUDA device, without the
port's package beside it, or when any check fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and f32 (non-tensor)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
STATIC_BASE_TOL = 1e-3  # max |kernel - plain| of the static base (target 0)
N_NODES, N_EXISTING, N_PENDING = 5000, 12000, 10000
WARM_SEED, TIMED_SEEDS = 101, (102, 103, 104)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(torch, fn, reps: int) -> float:
    """Mean device ms per call over `reps` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import k8s_scheduler_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing: {e}", file=sys.stderr)
        return 3
    from k8s_scheduler_tpu_torch.core.cycle import build_cycle_fn, sampling_window
    from k8s_scheduler_tpu_torch.framework.interfaces import CycleContext
    from k8s_scheduler_tpu_torch.framework.runtime import Framework
    from k8s_scheduler_tpu_torch.models import SnapshotEncoder
    from k8s_scheduler_tpu_torch.ops import claim_pass as cp
    from k8s_scheduler_tpu_torch.ops import kernel_build as kb
    from k8s_scheduler_tpu_torch.ops import rounds as rounds_ops
    from k8s_scheduler_tpu_torch.ops import static_base as sb
    from k8s_scheduler_tpu_torch.ops.resources import fit_slack
    from k8s_scheduler_tpu_torch.utils import synth

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    dev = torch.device("cuda")

    # ---- 1. device ----
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"phase device: {name} x{torch.cuda.device_count()} | nvidia-smi: {smi} "
        f"| torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build: nvcc for K1 in a thread while Triton compiles K2 ----
    build_err: list[BaseException] = []
    build_s: dict[str, float] = {}

    def build_k1():
        t0 = time.time()
        try:
            kb.load_cuda_library("static_base", ("--fmad=false",))
        except BaseException as e:  # re-raised on the main thread below
            build_err.append(e)
        build_s["static_base"] = time.time() - t0

    th = threading.Thread(target=build_k1)
    th.start()
    t0 = time.time()
    z = torch.zeros((2, 8), device=dev)
    zb = torch.zeros((2, 8), dtype=torch.bool, device=dev)
    cp.claim_pass_triton(z, ~zb, zb, zb[:, 0], None,
                         torch.zeros(2, dtype=torch.int32, device=dev),
                         torch.full((2,), -1, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    build_s["claim_pass"] = time.time() - t0
    th.join()
    if build_err:
        raise build_err[0]
    log(f"phase build: static_base nvcc {build_s['static_base']:.2f}s, "
        f"claim_pass triton {build_s['claim_pass']:.2f}s")

    # ---- data: config #4's cluster, config #2's constraint mix ----
    t0 = time.time()
    nodes, existing, pending = synth.config4_cluster_config2_pending(
        (WARM_SEED,) + TIMED_SEEDS, N_NODES, N_EXISTING, N_PENDING
    )
    gen_s = time.time() - t0
    enc = SnapshotEncoder(device=dev)
    encode_ms = {}
    snaps = {}
    for s, pods in pending.items():
        t0 = time.time()
        snaps[s] = enc.encode(nodes, pods, existing)
        torch.cuda.synchronize()
        encode_ms[s] = (time.time() - t0) * 1e3
    snap0 = snaps[WARM_SEED]
    P, N = snap0.P, snap0.N
    log(f"phase data: {N_NODES} nodes, {N_EXISTING} running, {N_PENDING} pending "
        f"-> padded P={P} N={N}; generate {gen_s:.1f}s; encode ms "
        + json.dumps({str(k): round(v, 1) for k, v in encode_ms.items()}))

    fw = Framework.from_config()
    cycle_k = build_cycle_fn(device=dev)

    # ---- 3a. warm cycle (kernels) and the same cycle on the plain
    # versions, recording the claim-pass inputs of round 0 ----
    recorded = {}

    def recording_claim_pass(base, mask, dead, acc, delta, gid, nominated):
        i = recorded.setdefault("calls", 0)
        recorded["calls"] = i + 1
        if i in (0, 3):  # round 0, passes 0 and 3
            recorded[i] = tuple(
                t.clone() if isinstance(t, torch.Tensor) else t
                for t in (base, mask, dead, acc, delta, gid, nominated)
            )
        return cp.claim_pass_plain(base, mask, dead, acc, delta, gid, nominated)

    cycle_p = build_cycle_fn(device=dev, static_base_fn=sb.static_base_plain,
                             claim_pass_fn=recording_claim_pass)
    t0 = time.time()
    dk = cycle_k(snap0)
    torch.cuda.synchronize()
    warm_ms = (time.time() - t0) * 1e3
    t0 = time.time()
    dp = cycle_p(snap0)
    torch.cuda.synchronize()
    plain_cycle_ms = (time.time() - t0) * 1e3
    same = {
        "assignment": torch.equal(dk.assignment, dp.assignment),
        "node_requested": torch.equal(dk.node_requested, dp.node_requested),
        "unschedulable": torch.equal(dk.unschedulable, dp.unschedulable),
        "gang_dropped": torch.equal(dk.gang_dropped, dp.gang_dropped),
    }
    log(f"phase e2e-parity: kernels cycle {warm_ms:.1f} ms (warm-up), plain "
        f"cycle {plain_cycle_ms:.1f} ms, placed {int((dk.assignment >= 0).sum())}"
        f"; kernels == plain: {json.dumps(same)}")
    check(all(same.values()), "kernel cycle differs from the plain-versions cycle")

    # ---- 3b. kernels against their plain versions ----
    ctx = CycleContext(snap0)
    x = sb.static_base_inputs(fw, ctx, fit=True, sampling=sampling_window(snap0, 0))
    k_out = sb.static_base_cuda(x)
    p_out = sb.static_base_plain(x)
    k_mask, p_mask = k_out > sb.NEG_INF / 2, p_out > sb.NEG_INF / 2
    mask_equal = torch.equal(k_mask, p_mask)
    k1_err = float((k_out - p_out).abs().max())
    check(mask_equal, "static_base mask differs from its plain version")
    check(k1_err <= STATIC_BASE_TOL,
          f"static_base max|kernel - plain| {k1_err} > {STATIC_BASE_TOL}")
    del k_out, p_out, k_mask, p_mask
    k1_ms = time_ms(torch, lambda: sb.static_base_cuda(x), 20)
    k1_plain_ms = time_ms(torch, lambda: sb.static_base_plain(x), 3)
    in_bytes = nbytes(*[v for v in vars(x).values() if isinstance(v, torch.Tensor)])
    k1_bytes = P * N * 4 + in_bytes
    k1_ops = P * N * (2 * len(x.terms) + 2)
    k1_bound = 1e3 * max(k1_bytes / PEAK_BYTES_PER_S, k1_ops / PEAK_F32_OPS_PER_S)
    log(f"phase kernel static_base: [{P}, {N}] mask equal {mask_equal}, "
        f"max|err| {k1_err}; kernel {k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms, "
        f"bound {k1_bound:.3f} ms (bytes {k1_bytes})")

    check(0 in recorded and 3 in recorded, "claim-pass states were not recorded")
    k2_err = 0.0
    for i in (0, 3):
        args = recorded[i]
        bk, hk = cp.claim_pass_triton(*args)
        bp, hp = cp.claim_pass_plain(*args)
        equal = torch.equal(bk, bp) and torch.equal(hk, hp)
        k2_err = max(k2_err, float((bk - bp).abs().max()))
        log(f"phase kernel claim_pass pass {i}: best/has equal {equal} "
            f"(acc {int(args[3].sum())}, dead {int(args[2].sum())})")
        check(equal, f"claim_pass differs from its plain version at pass {i}")
    args0 = recorded[0]
    base, mask, dead, acc, delta, gid, nominated = args0
    B = base.shape[0]
    k2_ms = time_ms(torch, lambda: cp.claim_pass_triton(*args0), 20)
    k2_plain_ms = time_ms(torch, lambda: cp.claim_pass_plain(*args0), 5)
    avail = mask & ~dead & ~acc[:, None]
    eff = torch.where(avail, torch.round(base) + cp.tie_break(gid, N), cp.NEG_INF)
    k2_lib_ms = time_ms(torch, lambda: torch.argmax(eff, dim=1), 20)
    del avail, eff
    k2_bytes = nbytes(base, mask, dead, acc, gid, nominated) + B * (4 + 1)
    k2_ops = B * N * 8
    k2_bound = 1e3 * max(k2_bytes / PEAK_BYTES_PER_S, k2_ops / PEAK_F32_OPS_PER_S)
    log(f"phase kernel claim_pass: [{B}, {N}] kernel {k2_ms:.3f} ms, plain "
        f"{k2_plain_ms:.3f} ms, torch.argmax yardstick {k2_lib_ms:.3f} ms, "
        f"bound {k2_bound:.3f} ms (bytes {k2_bytes})")
    del recorded, args0, args, base, mask, dead

    # ---- 4. the main path: three timed cycles, launch counts around them ----
    kb.reset_launch_counts()
    results = []
    for s in TIMED_SEEDS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.time()
        start.record()
        d = cycle_k(snaps[s])
        end.record()
        torch.cuda.synchronize()
        results.append((s, d, start.elapsed_time(end), (time.time() - t0) * 1e3))
    launches = dict(kb.launch_counts)
    log(f"phase e2e launches over {len(TIMED_SEEDS)} cycles: {json.dumps(launches)}")
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the main path")

    for s, d, dev_ms, host_ms in results:
        snap = snaps[s]
        a = d.assignment
        placed = snap.pod_valid & (a >= 0)
        n_real = int(snap.num_nodes)
        check(tuple(a.shape) == (P,) and a.dtype == torch.int32, "assignment shape")
        check(bool(((a >= -1) & (a < n_real)).all()), "assignment out of range")
        check(not bool((~snap.pod_valid & (a >= 0)).any()), "padding pod placed")
        check(bool(torch.isfinite(d.node_requested).all()), "node_requested not finite")
        req = snap.pod_requested
        expect = rounds_ops.index_add_exact(snap.node_requested, a[placed], req[placed])
        check(torch.equal(expect, d.node_requested),
              "node_requested != running requests + placed requests")
        # a node that received pods this cycle ends within its allocatable
        # (the running workload alone may already exceed it)
        alloc = snap.node_allocatable
        over = (d.node_requested > alloc + fit_slack(alloc)).any(dim=1)
        check(not bool(over[a[placed].long()].any()),
              "a node that received pods is over capacity")
        ctx = CycleContext(snap)
        smask = sb.static_base_plain(sb.static_base_inputs(
            fw, ctx, fit=True, sampling=sampling_window(snap, 0)
        )) > sb.NEG_INF / 2
        pidx = torch.nonzero(placed, as_tuple=True)[0]
        check(bool(smask[pidx, a[pidx].long()].all()),
              "a placed pod's static mask is false at its node")
        extra = fw.extra_update_batched(
            ctx, fw.extra_init(ctx), placed, torch.where(placed, a, 0)
        )
        feasible, _ = fw.dyn_batched(ctx, d.node_requested, extra, smask)
        open_ = snap.pod_valid & (a < 0) & ~d.gang_dropped
        n_open_feasible = int((feasible.any(dim=1) & open_).sum())
        check(n_open_feasible == 0,
              f"{n_open_feasible} unplaced pods still have a feasible node")
        del smask, feasible
        log(f"phase e2e cycle seed {s}: device {dev_ms:.1f} ms, host {host_ms:.1f} ms, "
            f"placed {int(placed.sum())}, unschedulable {int(d.unschedulable.sum())}, "
            f"valid: capacity ok, static masks ok, unplaced infeasible")

    kernels = [
        {
            "name": "static_base",
            "route": "cuda",
            "source": "k8s_scheduler_tpu_torch/csrc/static_base.cu",
            "replaces": "k8s_scheduler_tpu/ops/rounds.py:338",
            "launches": launches["static_base"],
            "max_abs_err": k1_err,
            "ms": k1_ms,
            "plain_ms": k1_plain_ms,
            "bound_ms": k1_bound,
            "bound_by": "bytes" if k1_bytes / PEAK_BYTES_PER_S
            >= k1_ops / PEAK_F32_OPS_PER_S else "operations",
            "library_ms": None,
        },
        {
            "name": "claim_pass",
            "route": "triton",
            "source": "k8s_scheduler_tpu_torch/ops/claim_pass.py",
            "replaces": "k8s_scheduler_tpu/ops/rounds.py:805",
            "launches": launches["claim_pass"],
            "max_abs_err": k2_err,
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
            "bound_ms": k2_bound,
            "bound_by": "bytes" if k2_bytes / PEAK_BYTES_PER_S
            >= k2_ops / PEAK_F32_OPS_PER_S else "operations",
            "library_ms": k2_lib_ms,
        },
    ]
    timed = [r[2] for r in results]
    log(f"phase summary: cycle device ms {[round(t, 1) for t in timed]}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, "
        f"total {time.time() - t_start:.0f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
