"""Where a cycle's time goes on the card: torch.profiler over cycles of the
slice workload (`utils.synth.config4_cluster_config2_pending`, the
workload chip_smoke.py drives).

    python3 -m k8s_scheduler_tpu_torch.profile_cycle [--cycles 2] [--out PATH]

Prints, per cycle: wall ms, summed device-kernel ms, the device busy share
(kernel time over wall time; one stream, so kernels never overlap),
device-activity count, and the device kernels ranked by total time — with
the card's name and power limit. Needs a CUDA device."""

from __future__ import annotations

import argparse
import collections
import subprocess
import sys
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cycles", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_cycle: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from .core.cycle import build_cycle_fn
    from .models import SnapshotEncoder
    from .utils import synth

    dev = torch.device("cuda")
    seeds = tuple(range(201, 202 + args.cycles))
    nodes, existing, pending = synth.config4_cluster_config2_pending(seeds)
    enc = SnapshotEncoder(device=dev)
    snaps = [enc.encode(nodes, pending[s], existing) for s in seeds]
    cycle = build_cycle_fn(device=dev)
    cycle(snaps[0])  # warm-up: kernel builds, allocator, Triton compile
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for snap in snaps[1:]:
            cycle(snap)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.cycles

    by_name: dict[str, list[float]] = collections.defaultdict(list)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name].append(e.time_range.elapsed_us() / 1e3)
    dev_ms = sum(sum(v) for v in by_name.values()) / args.cycles
    n_act = sum(len(v) for v in by_name.values()) / args.cycles
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    lines = [
        f"card: {smi}",
        f"cycles profiled: {args.cycles} (slice workload, 10000 pending x 5000 nodes)",
        f"wall ms/cycle: {wall_ms:.3f}",
        f"device kernel ms/cycle: {dev_ms:.3f}",
        f"device busy share: {dev_ms / wall_ms:.4f}",
        f"device activities/cycle: {n_act:.0f}",
        "top device kernels (ms/cycle, calls/cycle, name):",
    ]
    ranked = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    for name, ts in ranked[: args.top]:
        lines.append(f"  {sum(ts) / args.cycles:9.3f}  {len(ts) / args.cycles:7.1f}  {name[:110]}")
    report = "\n".join(lines)
    print(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
