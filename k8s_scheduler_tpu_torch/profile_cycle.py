"""Where a cycle's time goes on the card: torch.profiler over cycles of
BASELINE config #4's workload (`utils.synth.config4_workload`, the
workload of chip_smoke.py's phases affinity and preemption: inter-pod
affinity and spread on both sides, 10000 pending x 5000 nodes x 12000
running), of the same workload with local and zonal volumes
(`utils.synth.config4_volumes`, chip_smoke.py's phase volumes), and of
config #4's workload through the scan engine (`build_cycle_fn(commit_mode=
"scan")`, chip_smoke.py's phase scan), and of config #4's rounds cycle
with the plain versions of K14 `dyn_mask` and K15 `dyn_score` (the run
the kernels are held against, for a before and after in one call), each
cycle followed by
DefaultPreemption (`build_preemption_fn`) on its decision, as a serving
host runs them.

    python3 -m k8s_scheduler_tpu_torch.profile_cycle [--cycles 2] [--out PATH]

Prints, per workload, for the cycles and for the preemption passes
separately: wall ms,
summed device-kernel ms, the device busy share (kernel time over wall
time; one stream, so kernels never overlap), device-activity count, the
hand kernels' launch counts, and the device kernels ranked by total time —
with the card's name and power limit. Needs a CUDA device."""

from __future__ import annotations

import argparse
import collections
import subprocess
import sys
import time

import torch


def _profile(fn, inputs):
    """(wall ms per call, {device kernel name: [ms, ...]}, launch counts)
    of fn(*x) for x in inputs under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from .ops import kernel_build as kb

    kb.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x in inputs:
            fn(*x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(inputs)
    by_name: dict[str, list[float]] = collections.defaultdict(list)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name].append(e.time_range.elapsed_us() / 1e3)
    return wall_ms, by_name, {k: v for k, v in kb.launch_counts.items() if v}


def _report(title, n, wall_ms, by_name, launches, top):
    dev_ms = sum(sum(v) for v in by_name.values()) / n
    n_act = sum(len(v) for v in by_name.values()) / n
    lines = [
        f"{title}: {n} profiled",
        f"  wall ms/call: {wall_ms:.3f}",
        f"  device kernel ms/call: {dev_ms:.3f}",
        f"  device busy share: {dev_ms / wall_ms:.4f}",
        f"  device activities/call: {n_act:.0f}",
        f"  hand-kernel launches/call: "
        + ", ".join(f"{k} {v / n:g}" for k, v in launches.items()),
        "  top device kernels (ms/call, calls/call, name):",
    ]
    ranked = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    for name, ts in ranked[:top]:
        lines.append(f"  {sum(ts) / n:9.3f}  {len(ts) / n:7.1f}  {name[:110]}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cycles", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_cycle: no CUDA device", file=sys.stderr)
        return 2
    from .core.cycle import build_cycle_fn, build_preemption_fn
    from .models import SnapshotEncoder
    from .ops import dyn_round as dr
    from .utils import synth

    dev = torch.device("cuda")
    seeds = tuple(range(201, 202 + args.cycles))
    nodes, existing, pending = synth.config4_workload(seeds)
    cycles = {"config4": build_cycle_fn(commit_mode="rounds", outputs="latency",
                                        device=dev),
              "config4 plain dyn": build_cycle_fn(
                  commit_mode="rounds", outputs="latency", device=dev,
                  dyn_mask_fn=dr.dyn_mask_plain, dyn_score_fn=dr.dyn_score_plain),
              "volumes": build_cycle_fn(commit_mode="rounds", outputs="latency", device=dev),
              "scan": build_cycle_fn(commit_mode="scan", outputs="latency", device=dev)}
    preempt = build_preemption_fn(device=dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    lines = [f"card: {smi}"]
    for wl, cycle in cycles.items():
        enc = SnapshotEncoder(device=dev)
        snaps = []
        for s in seeds:
            if wl == "volumes":
                ex, pods, pvcs, pvs, classes = synth.config4_volumes(
                    nodes, existing, pending[s], seed=s)
                snaps.append(enc.encode(nodes, pods, ex, pvcs=pvcs, pvs=pvs,
                                        storage_classes=classes))
            else:
                snaps.append(enc.encode(nodes, pending[s], existing))
        preempt(snaps[0], cycle(snaps[0]))  # warm-up: builds, allocator, Triton
        torch.cuda.synchronize()
        decisions = []
        c_wall, c_names, c_launch = _profile(
            lambda s: decisions.append(cycle(s)), [(s,) for s in snaps[1:]])
        p_wall, p_names, p_launch = _profile(preempt, list(zip(snaps[1:], decisions)))
        extra = {"config4": "",
                 "config4 plain dyn": " with the plain versions of K14 and K15",
                 "volumes": " with local and zonal volumes",
                 "scan": " through the scan engine"}[wl]
        lines += [
            f"workload: config #4{extra} (10000 pending x 5000 nodes, 12000 running), "
            f"seeds {list(seeds[1:])}",
            *_report("cycles", args.cycles, c_wall, c_names, c_launch, args.top),
            *_report("preemption passes", args.cycles, p_wall, p_names, p_launch,
                     args.top),
        ]
        del snaps, decisions
    report = "\n".join(lines)
    print(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
