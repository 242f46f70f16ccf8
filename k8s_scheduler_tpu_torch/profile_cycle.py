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
    python3 -m k8s_scheduler_tpu_torch.profile_cycle --plain-scan 512 [--out PATH]

Prints, per workload, for the cycles and for the preemption passes
separately: wall ms,
summed device-kernel ms, the device busy share (kernel time over wall
time; one stream, so kernels never overlap), device-activity count, the
hand kernels' launch counts, and the device kernels ranked by total time —
with the card's name and power limit. With `--plain-scan PODS`, only the
scan engine's plain commit (`scan_commit_plain`, the run K13 is held
against) on the volumes workload's first PODS pending pods, with
VolumeBinding on and off: per step, wall ms, device-kernel ms and
activities, host syncs (`torch.cuda.set_sync_debug_mode`), and the host
operators ranked by their own CPU time. Needs a CUDA device."""

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


def _plain_scan(pods: int, top: int, smi: str) -> list[str]:
    """The plain scan's step on the volumes workload (seed 202, its first
    `pods` pending pods, all nodes and PVs), VolumeBinding on and off."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from .config import PluginSet, Plugins, Profile, SchedulerConfiguration
    from .core.cycle import build_cycle_fn
    from .framework.runtime import Framework
    from .models import SnapshotEncoder
    from .ops import scan_commit as sc
    from .utils import synth

    dev = torch.device("cuda")
    nodes, existing, pending = synth.config4_workload((202,))
    ex, pods_, pvcs, pvs, classes = synth.config4_volumes(nodes, existing, pending[202],
                                                          seed=202)
    snap = SnapshotEncoder(device=dev).encode(nodes, pods_[:pods], ex, pvcs=pvcs, pvs=pvs,
                                              storage_classes=classes)
    steps = int(snap.pod_valid.sum())
    off = Framework.from_config(SchedulerConfiguration(profiles=[Profile(
        plugins=Plugins(filter=PluginSet(disabled=["VolumeBinding"])))]))
    lines = [f"card: {smi}",
             f"plain scan (scan_commit_plain) on config #4 with volumes, seed 202, the first "
             f"{pods} pending pods ({steps} steps), {snap.N} nodes, "
             f"{snap.pv_avail.shape[0]} PVs"]
    for tag, fw in (("VolumeBinding on", None), ("VolumeBinding off", off)):
        cycle = build_cycle_fn(fw, commit_mode="scan", outputs="latency", device=dev,
                               scan_commit_fn=sc.scan_commit_plain)
        cycle(snap)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            cycle(snap)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        torch.cuda.set_sync_debug_mode(0)
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            cycle(snap)
            torch.cuda.synchronize()
        dev_us = [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        lines += [f"{tag}: wall {wall:.1f} ms, {wall / steps:.3f} ms a step; device "
                  f"kernels {sum(dev_us) / 1e3 / steps:.3f} ms and {len(dev_us) / steps:.1f} "
                  f"activities a step; {syncs / steps:.2f} host syncs a step",
                  "  host operators by own CPU time (ms a step, calls a step, name):"]
        ranked = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
        for a in ranked[:top]:
            lines.append(f"  {a.self_cpu_time_total / 1e3 / steps:9.4f}  "
                         f"{a.count / steps:7.1f}  {a.key[:100]}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cycles", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", default=None, help="also write the report here")
    ap.add_argument("--plain-scan", type=int, default=0, metavar="PODS",
                    help="profile only the plain scan's step on the volumes workload's "
                         "first PODS pending pods")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_cycle: no CUDA device", file=sys.stderr)
        return 2
    if args.plain_scan:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
        return _write(_plain_scan(args.plain_scan, args.top, smi), args.out)
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
    return _write(lines, args.out)


def _write(lines, out) -> int:
    report = "\n".join(lines)
    print(report)
    if out:
        with open(out, "w") as f:
            f.write(report + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
