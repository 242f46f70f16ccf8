"""Where the port's kernels spend their time on the card: device times of
the small kernels on the main path, and timed variants of K9
`preempt_claim`, K4 `affinity_update`, K5 `capacity` and K1 `static_base`,
built from edited copies of their sources, on full-size inputs recorded
from the main path.

    python3 -m k8s_scheduler_tpu_torch.kernel_variants [--csrc DIR] [--out PATH]

`--csrc` names the directory whose `preempt_claim.cu`, `affinity_update.cu`,
`capacity.cu` and `static_base.cu` are varied (default: the package's own
`csrc/`; an earlier checkout's `csrc/` times that design on the same
inputs, K4 through its earlier C interface, `prev_affinity_update`). Each
variant is a list of text edits; a variant whose anchors are not in the
source is reported as not applicable. The variants compute wrong results
on purpose: they are timed, never compared. The edited copies are built
into `_build/variants/`.

Inputs, BASELINE config #4's cluster size (5000 nodes, 12000 running,
10000 pending; P=16384, N=8192), as `chip_smoke.py` makes them:
  small  every call of K4, K5, K6 `guard_sweep` (one rounds cycle of
         config #4's workload, seed 202), K7-K9 (the preemption pass after it),
         K11 `pv_choice` and K12 `pv_fold` (one rounds cycle of the same
         workload with local and zonal volumes, seed 201; K9 also in the
         pass after it): the first call by CUDA events around eager calls
         and as device time, and the device time's mean over the calls;
  K9     the two recorded passes: the kernel, its floor (the cluster
         barrier and the exchange of records without the node work), 8
         CTAs against 16 (the portable cluster, also held against the
         plain version), the victim tables from L2 against shared memory;
  K4     the recorded calls (round 0 and the mean): the kernel, the domain
         pass alone, without the match scan, the copy alone;
  K5     every `capacity` call of one rounds cycle of config #4's workload
         (seed 202): the round-0 pass, a late pass and the round-0
         revocation fold are timed alone, the mean over all recorded calls
         too;
  K1     slice 1's inputs (config #2's pending mix, seed 101; fit and node
         sampling) and the volume phase's (config #4 with local and zonal
         PVs, seed 201; VolumeBinding's mask operand), beside
         `torch.empty(P, N).fill_(-1e9)`, the write floor.

Device times come from calls captured in a CUDA graph and replayed between
CUDA events (`device_ms`: a small kernel's wrapper takes longer on the host
than the kernel on the card, so events around eager calls measure the
host). K1 times are CUDA events around eager calls, the variants in turn,
the best of three turns. With the package's own sources, the kernels are
first held against their plain versions on every input,
`utils/kernel_cases.py`'s edge cases included. Prints one line per variant
with its ms and the card's name and power limit, and writes the table as
JSON to `--out` (default `_build/kernel_variants.json` in the package).
Needs a CUDA device."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

N_NODES, N_EXISTING, N_PENDING = 5000, 12000, 10000

# {variant: [(anchor, replacement), ...]}; "today" is the kernel as it stands
_ROW = ("if (threadIdx.x < R) node_req_out[(size_t)j * R + threadIdx.x] = "
        "node_req[(size_t)j * R + threadIdx.x];")
_HI = "  const int hi = lower_bound_node(s_key, B, rank_bits, (long long)j + 1);\n"
_OWN = "if (lane < kR) node_req_out[(size_t)j * kR + lane] = own;"
CAPACITY_VARIANTS = {
    # the earlier design: a block per node
    "today": [],
    "searches only": [(
        _HI, _HI + f"  if (lo <= hi) {{ {_ROW} return; }}\n")],
    "early exit on an empty run": [(
        _HI, _HI + f"  if (lo == hi) {{ {_ROW} return; }}\n")],
    "no fold scan": [(
        "      block_excl_scan(fits ? (double)q[r] : 0.0, warp_sums, &tot);",
        "      tot = fits ? (double)q[r] : 0.0;")],
    "empty blocks": [(
        "  const int j = blockIdx.x;\n",
        f"  const int j = blockIdx.x;\n  if (j >= 0) {{ {_ROW} return; }}\n")],
    # csrc/capacity.cu as it stands: a warp per node
    "warp: search only": [(
        "  if (lo >= B || (s_key[lo] >> rank_bits) != j) {",
        f"  if (lo >= 0) {{ {_OWN} return; }}\n"
        "  if (lo >= B || (s_key[lo] >> rank_bits) != j) {")],
    "warp: 4 claims a lane": [("constexpr int kU = 8;", "constexpr int kU = 4;")],
    "warp: 3 blocks an SM": [("__global__ void __launch_bounds__(kThreads)\ncapacity_kernel(",
                              "__global__ void __launch_bounds__(kThreads, 3)\ncapacity_kernel(")],
    "warp: empty warps": [(
        "  const int lo = warp_lower_bound(",
        f"  if (j >= 0) {{ {_OWN} return; }}\n  const int lo = warp_lower_bound(")],
}
STATIC_BASE_VARIANTS = {
    # the earlier design: one element a thread
    "today": [],
    "store only": [(
        "    bool ok = valid;",
        "    a.out[(size_t)p * a.N + n] = kNegInf;\n    continue;\n    bool ok = valid;")],
    "mask without score": [(
        "    float out = kNegInf;\n    if (ok) {",
        "    float out = ok ? 0.0f : kNegInf;\n    if (false) {")],
    "float4 stores, store only": [(
        "    bool ok = valid;",
        "    if (4 * n < a.N) reinterpret_cast<float4*>(a.out + (size_t)p * a.N)[n] ="
        " make_float4(kNegInf, kNegInf, kNegInf, kNegInf);\n    continue;\n"
        "    bool ok = valid;")],
    # csrc/static_base.cu as it stands: node-stationary tiles
    "tile: store only": [(
        "      const Pod q = pods[k];",
        "      if (kVec) { for (int c = 0; c < kPerThread; c += 4) __stcs("
        "reinterpret_cast<float4*>(a.out + (size_t)(p0 + k) * N + n0 + c / 4 * kStride), "
        "make_float4(kNegInf, kNegInf, kNegInf, kNegInf)); continue; }\n"
        "      const Pod q = pods[k];")],
    "tile: mask without score": [("      if (any) {", "      if (false) {")],
    "tile: no node name": [("      if ((flags & kNodeName) && q.pin != -1) {",
                            "      if (false) {")],
    "tile: no taint test": [("      if ((flags & kTaint) && ts_bits) {", "      if (false) {"),
                            ("      } else if (flags & kTaint) {", "      } else if (false) {")],
    "tile: no requirement rows": [("      if (flags & kAffinity) {", "      if (false) {")],
    "tile: no fit": [("      if (flags & kFit) {\n        for", "      if (false) {\n        for")],
    "tile: no sampling": [("      if (flags & kSample) {\n        // (n - off)",
                           "      if (false) {\n        // (n - off)")],
    "tile: 4 nodes a thread": [("constexpr int kPerThread = 8;", "constexpr int kPerThread = 4;")],
    "tile: 64-pod groups": [("constexpr int kPodGroup = 32;", "constexpr int kPodGroup = 64;")],
}

_NODE_WORK = ("      const Rec k = node_key<R, MB>(a, s, ln, n0 + ln, gate, ok + ln * (M + 1), "
              "ports, q, p);\n      if (before(k, best)) best = k;")
CLAIM_VARIANTS = {
    "today": [],
    # csrc/preempt_claim.cu as it stands: a cluster of 16 CTAs
    "cluster: floor (barrier and exchange, no node work)": [(_NODE_WORK, "      (void)ln;")],
    "cluster: 8 CTAs": [("constexpr int kClusterWant = 16;", "constexpr int kClusterWant = 8;")],
    "cluster: victim tables from L2": [("constexpr bool kStageTables = true;",
                                        "constexpr bool kStageTables = false;")],
}
_DOMAIN_LAUNCH = ("    domain_kernel<<<(unsigned)((terms + kThreads - 1) / kThreads), kThreads, "
                  "0, st>>>(a);")
_MATCH_SCAN = "    for (int i = tid; i < a.B / 16; i += kThreads) {"
AFFINITY_UPDATE_VARIANTS = {
    "today": [],
    # csrc/affinity_update.cu as it stands: a domain pass, then a row fold
    "fold: domain pass alone": [("  fold_kernel<<<S, kThreads, smem, st>>>(a);",
                                 "  (void)smem;")],
    "fold: no match scan": [(_MATCH_SCAN, _MATCH_SCAN.replace("< a.B / 16", "< 0"))],
    "fold: copy alone (no domain pass, no match scan)": [
        (_DOMAIN_LAUNCH, ""), (_MATCH_SCAN, _MATCH_SCAN.replace("< a.B / 16", "< 0"))],
}

VARIANT_OF: dict[str, str] = {}  # edited source -> "kernel, variant"


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def device_ms(fn, reps: int) -> float:
    """Mean device ms per call of fn, from one CUDA graph of `reps` calls
    replayed between two CUDA events: the device's time for the calls'
    kernels back to back, without the host time of the Python wrappers
    that launch them (a K5 call takes longer on the host than on the card,
    so events around eager calls would time the host)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def time_ms(fn, reps: int) -> float:
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


def build_variants(name: str, csrc: Path, variants: dict) -> dict:
    """{variant: loaded library or None (anchors missing)}; builds in
    parallel, one nvcc each."""
    from .ops import kernel_build as kb

    text = (csrc / f"{name}.cu").read_text()
    out_dir = kb.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = {}
    for v, edits in variants.items():
        if not all(a in text for a, _ in edits):
            srcs[v] = None
            continue
        t = text
        for a, b in edits:
            t = t.replace(a, b, 1)
        path = out_dir / f"{name}-{len(srcs)}.cu"
        path.write_text(t)
        srcs[v] = path
        VARIANT_OF[str(path)] = f"{name}, {v}"
    libs, errs = {}, []

    def one(v, path):
        try:
            libs[v] = kb.build_cuda_library(name, path)
        except BaseException as e:  # re-raised below
            errs.append(e)

    threads = [threading.Thread(target=one, args=(v, p)) for v, p in srcs.items() if p]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errs:
        raise errs[0]
    import ctypes

    return {v: (ctypes.CDLL(str(libs[v])) if p else None) for v, p in srcs.items()}


def with_library(name: str, lib, fn):
    """Run fn() with kernel `name`'s wrapper launching from `lib`."""
    from .ops import kernel_build as kb

    saved = kb._libs.get(name)
    kb._libs[name] = lib
    try:
        return fn()
    finally:
        if saved is None:
            kb._libs.pop(name, None)
        else:
            kb._libs[name] = saved


# the small kernels of the main path timed on the device: the module under
# ops/ and its CUDA wrapper
SMALL_KERNELS = {
    "affinity_update": ("affinity_update", "affinity_update_cuda"),
    "capacity": ("capacity", "capacity_cuda"),
    "guard_sweep": ("guard_sweep", "guard_sweep_cuda"),
    "preempt_prefilter": ("preempt_prefilter", "preempt_prefilter_cuda"),
    "preempt_whatif": ("preempt_whatif", "preempt_whatif_cuda"),
    "preempt_claim": ("preempt_claim", "preempt_claim_cuda"),
    "pv_choice": ("pv_choice", "pv_choice_cuda"),
    "pv_fold": ("pv_fold", "pv_fold_cuda"),
}


def cuda_fn(name: str):
    """Kernel `name`'s CUDA wrapper (SMALL_KERNELS)."""
    import importlib

    mod, fn = SMALL_KERNELS[name]
    return getattr(importlib.import_module(f".ops.{mod}", __package__), fn)


def record_small_calls(dev) -> dict:
    """{kernel: [args of each call]} of the small kernels on the main path:
    K4 `affinity_update`, K5 `capacity` and K6 `guard_sweep` over one
    rounds cycle of config #4's workload (seed 202), K7-K9 in the preemption pass after
    it, K11 `pv_choice` and K12 `pv_fold` over one rounds cycle of the
    same workload with local and zonal volumes (seed 201), and K9 in the
    preemption pass after that cycle too."""
    from .core.cycle import build_cycle_fn, build_preemption_fn
    from .models import SnapshotEncoder
    from .utils import synth

    calls: dict = {k: [] for k in SMALL_KERNELS}

    def rec(name):
        fn = cuda_fn(name)

        def call(*args):
            calls[name].append(args)
            return fn(*args)
        return call

    enc = SnapshotEncoder(device=dev)
    nodes, existing, pending = synth.config4_workload((201, 202), N_NODES, N_EXISTING,
                                                      N_PENDING)
    snap = enc.encode(nodes, pending[202], existing)
    d = build_cycle_fn(commit_mode="rounds", device=dev,
                       affinity_update_fn=rec("affinity_update"),
                       capacity_fn=rec("capacity"),
                       guard_sweep_fn=rec("guard_sweep"))(snap)
    build_preemption_fn(device=dev, prefilter_fn=rec("preempt_prefilter"),
                        whatif_fn=rec("preempt_whatif"),
                        claim_fn=rec("preempt_claim"))(snap, d)
    ex, pods, pvcs, pvs, classes = synth.config4_volumes(nodes, existing, pending[201],
                                                         seed=201)
    vsnap = enc.encode(nodes, pods, ex, pvcs=pvcs, pvs=pvs, storage_classes=classes)
    d = build_cycle_fn(commit_mode="rounds", device=dev, pv_choice_fn=rec("pv_choice"),
                       pv_fold_fn=rec("pv_fold"))(vsnap)
    build_preemption_fn(device=dev, claim_fn=rec("preempt_claim"))(vsnap, d)
    torch.cuda.synchronize()
    return calls


def time_small_kernels(calls: dict) -> dict:
    """{kernel: {timing: ms}}: each small kernel's first recorded call timed
    with CUDA events around eager calls (the host's time where the wrapper
    takes longer than the kernel) and as device time (`device_ms`), and the
    device time's mean over every recorded call."""
    out = {}
    for name, cs in calls.items():
        fn = cuda_fn(name)
        row = {"calls": len(cs),
               "first call, events": time_ms(lambda: fn(*cs[0]), 20),
               "first call, device": device_ms(lambda: fn(*cs[0]), 20),
               "mean over the calls, device": sum(
                   device_ms(lambda: fn(*c), 5) for c in cs) / len(cs)}
        out[name] = row
        print(f"  small kernel {name:18s} " + "  ".join(
            f"{k} {v:.4f} ms" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()), flush=True)
    return out


def time_claim_variants(dev, csrc: Path, calls: list, check: bool) -> dict:
    """K9's variants (CLAIM_VARIANTS) in device time on the recorded
    passes; with the package's own source, K9 first held against
    `claim_loop_plain` bit for bit on them and on its seeded edge cases."""
    from .ops import preempt_claim as k9
    from .ops import preemption as pre

    libs = build_variants("preempt_claim", csrc, CLAIM_VARIANTS)
    if check:
        from .utils import kernel_cases

        cases = kernel_cases.claim_cases(dev)
        inputs = list(cases.items()) + [(f"pass {i}", c[0]) for i, c in enumerate(calls)]

        def hold(tag):
            for case, x in inputs:
                (nk, ck), (np_, cp_) = k9.preempt_claim_cuda(x), pre.claim_loop_plain(x)
                if not (torch.equal(nk, np_) and all(
                        torch.equal(getattr(ck, f), getattr(cp_, f)) for f in vars(ck))):
                    raise RuntimeError(f"preempt_claim ({tag}) differs from "
                                       f"claim_loop_plain ({case})")

        hold("16 CTAs")
        shapes = {tag: k9.claim_shape(x) for tag, x in inputs}
        print(f"preempt_claim equal to claim_loop_plain bit for bit on {len(calls)} passes "
              f"and {len(cases)} edge cases; launch shapes {json.dumps(shapes)}", flush=True)
        # the portable cluster, the kernel's shape on a card that cannot
        # schedule 16 CTAs, is exact too
        with_library("preempt_claim", libs["cluster: 8 CTAs"], lambda: hold("8 CTAs"))
        shape8 = with_library("preempt_claim", libs["cluster: 8 CTAs"],
                              lambda: k9.claim_shape(calls[0][0]))
        print(f"preempt_claim with 8 CTAs (launch shape {json.dumps(shape8)}) equal to "
              "claim_loop_plain on the same inputs", flush=True)
    out = {}
    for v, lib in libs.items():
        if lib is None:
            out[v] = "not applicable"
            continue
        row = {f"pass {i} ({int(c[0].n_live)} live)": with_library(
            "preempt_claim", lib, lambda: device_ms(lambda: k9.preempt_claim_cuda(*c), 20))
            for i, c in enumerate(calls)}
        out[v] = row
        print(f"  preempt_claim {v:52s} "
              + "  ".join(f"{k} {ms:.4f} ms" for k, ms in row.items()), flush=True)
    return out


def prev_affinity_update(lib, snap, state, m_pending, accepted, node_of):
    """K4 through the earlier C interface (`affinity_update_launch`, the
    design before the domain pass and row fold): the four tables cloned,
    then updated in place by the library's kernels."""
    import ctypes

    from .ops import interpod as ip
    from .ops.kernel_build import ptr, raise_on_error, stream_of

    fn = lib.affinity_update_launch
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 12
    fn.restype = ctypes.c_int
    S, D = state.counts.shape
    out = ip.AffinityState(state.counts.clone(), state.total.clone(),
                           state.anti_presence.clone(), state.pref_sym.clone())
    dev = state.counts.device
    raise_on_error("affinity_update", fn(
        snap.P, snap.N, S, D, snap.node_domains.shape[1], snap.pod_anti_terms.shape[1],
        int(bool(snap.has_inter_pod_affinity)), ptr(m_pending), ptr(accepted), ptr(node_of),
        ptr(snap.node_domains), ptr(snap.pod_anti_terms), ptr(snap.pod_pref_aff),
        ptr(snap.pod_pref_aff_w), ptr(out.counts), ptr(out.total), ptr(out.anti_presence),
        ptr(out.pref_sym), stream_of(dev)))
    return out


def affinity_update_with(lib):
    """K4's wrapper for library `lib`: the package's interface, or the
    earlier one (`prev_affinity_update`) for a library without it."""
    from .ops import affinity_update as au

    if hasattr(lib, "affinity_update_fold"):
        return lambda *args: with_library("affinity_update", lib,
                                          lambda: au.affinity_update_cuda(*args))
    return lambda *args: prev_affinity_update(lib, *args)


def states_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("counts", "total", "anti_presence", "pref_sym"))


def time_affinity_update_variants(dev, csrc: Path, calls: list, check: bool) -> dict:
    """K4's variants (AFFINITY_UPDATE_VARIANTS) in device time on the
    recorded calls of one cycle: the round-0 call and the mean over the
    calls; with the package's own source, K4 first held against
    `affinity_update_plain` on them and on its seeded edge cases."""
    from .ops import affinity_update as au

    libs = build_variants("affinity_update", csrc, AFFINITY_UPDATE_VARIANTS)
    if check:
        from .utils import kernel_cases

        edge = {t: kernel_cases.affinity_update_args(r, dev)
                for t, r in kernel_cases.affinity_update_raw_cases().items()}
        for tag, c in list(edge.items()) + [(f"call {i}", c) for i, c in enumerate(calls)]:
            if not states_equal(au.affinity_update_cuda(*c), au.affinity_update_plain(*c)):
                raise RuntimeError(f"affinity_update differs from its plain version ({tag})")
        print(f"affinity_update equal to affinity_update_plain on {len(calls)} recorded calls "
              f"and {len(edge)} edge cases", flush=True)
    out = {}
    for v, lib in libs.items():
        if lib is None:
            out[v] = "not applicable"
            continue
        fn = affinity_update_with(lib)
        row = {"round 0": device_ms(lambda: fn(*calls[0]), 20),
               "mean over the calls": sum(device_ms(lambda: fn(*c), 5)
                                          for c in calls) / len(calls)}
        out[v] = row
        print(f"  affinity_update {v:40s} "
              + "  ".join(f"{k} {ms:.4f} ms" for k, ms in row.items()), flush=True)
    st = calls[0][1]
    tables = (st.counts, st.total, st.anti_presence, st.pref_sym)
    out["the four old tables cloned by torch (a copy floor)"] = device_ms(
        lambda: [t.clone() for t in tables], 20)
    print(f"  affinity_update the four old tables cloned by torch "
          f"{out['the four old tables cloned by torch (a copy floor)']:.4f} ms", flush=True)
    return out


def static_base_cases(dev):
    """{case: StaticBaseInputs} of slice 1 and the volume phase."""
    from .core.cycle import sampling_window
    from .framework.interfaces import CycleContext
    from .framework.runtime import Framework
    from .models import SnapshotEncoder
    from .ops import static_base as sb
    from .utils import synth

    fw = Framework.from_config()
    enc = SnapshotEncoder(device=dev)
    nodes, existing, pending = synth.config4_cluster_config2_pending(
        (101,), N_NODES, N_EXISTING, N_PENDING)
    snap = enc.encode(nodes, pending[101], existing)
    cases = {"slice 1": sb.static_base_inputs(
        fw, CycleContext(snap), fit=True, sampling=sampling_window(snap, 0))}
    nodes, existing, pending = synth.config4_workload((201,), N_NODES, N_EXISTING,
                                                      N_PENDING)
    ex, pods, pvcs, pvs, classes = synth.config4_volumes(nodes, existing, pending[201],
                                                         seed=201)
    snap = enc.encode(nodes, pods, ex, pvcs=pvcs, pvs=pvs, storage_classes=classes)
    cases["volumes"] = sb.static_base_inputs(
        fw, CycleContext(snap), fit=True, sampling=sampling_window(snap, 0))
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    from .ops import capacity as cap
    from .ops import kernel_build as kb
    from .ops import static_base as sb

    dev = torch.device("cuda")
    csrc = args.csrc or kb.CSRC_DIR
    smi = _smi()
    print(f"device: {smi} | csrc {csrc}", flush=True)
    t0 = time.time()
    cap_libs = build_variants("capacity", csrc, CAPACITY_VARIANTS)
    sb_libs = build_variants("static_base", csrc, STATIC_BASE_VARIANTS)
    print(f"built in {time.time() - t0:.1f}s", flush=True)
    table = {"device": smi, "csrc": str(csrc), "capacity": {}, "static_base": {}}

    small = record_small_calls(dev)
    print("small kernels on recorded main-path calls: "
          + json.dumps({k: len(v) for k, v in small.items()}), flush=True)
    table["small kernels"] = time_small_kernels(small)
    out = args.out or kb.BUILD_DIR / "kernel_variants.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(table, indent=1))
    table["preempt_claim"] = time_claim_variants(dev, csrc, small["preempt_claim"],
                                                 csrc == kb.CSRC_DIR)
    table["affinity_update"] = time_affinity_update_variants(
        dev, csrc, small["affinity_update"], csrc == kb.CSRC_DIR)
    out.write_text(json.dumps(table, indent=1))
    calls = small.pop("capacity")
    N = calls[0][4].shape[0]
    del small

    folds = [i for i, c in enumerate(calls) if c[-1] is False]
    passes = [i for i, c in enumerate(calls) if c[-1] is not False]
    picks = {"round-0 pass": passes[0], "late pass": passes[-1],
             "round-0 revocation fold": folds[0]}
    shape = {}
    for tag, i in picks.items():
        s_key, _, rank_bits = calls[i][:3]
        node = s_key >> rank_bits
        live = node < N
        runs = torch.unique_consecutive(node[live], return_counts=True)[1]
        shape[tag] = {"call": i, "B": s_key.shape[0], "live": int(live.sum()),
                      "nodes with claims": int(runs.numel()),
                      "longest run": int(runs.max()) if runs.numel() else 0}
    table["capacity_calls"] = {"n": len(calls), "passes": len(passes),
                               "folds": len(folds), "picked": shape}
    print(f"capacity: {len(calls)} calls ({len(passes)} passes, {len(folds)} folds); "
          f"{json.dumps(shape)}", flush=True)
    if csrc == kb.CSRC_DIR:  # the package's kernels against their plain versions
        from .utils import kernel_cases

        edge = [a for a, _ in kernel_cases.capacity_cases(dev).values()]
        for c in calls + edge:
            (ak, nk), (ap, np_) = cap.capacity_cuda(*c), cap.capacity_plain(*c)
            if not (torch.equal(ak, ap) and torch.equal(nk.view(torch.int32),
                                                        np_.view(torch.int32))):
                raise RuntimeError("capacity differs from capacity_plain")
        print(f"capacity equal to capacity_plain bit for bit on the {len(calls)} calls "
              f"and {len(edge)} edge cases", flush=True)
    for v, lib in cap_libs.items():
        if lib is None:
            table["capacity"][v] = "not applicable"
            continue
        row = {}
        for tag, i in picks.items():
            row[tag] = with_library("capacity", lib, lambda: device_ms(
                lambda: cap.capacity_cuda(*calls[i]), 50))
        row["mean over the cycle's calls"] = sum(
            with_library("capacity", lib, lambda: device_ms(
                lambda: cap.capacity_cuda(*c), 10))
            for c in calls) / len(calls)
        row["round-0 pass, back to back (host-bound)"] = with_library(
            "capacity", lib, lambda: time_ms(lambda: cap.capacity_cuda(*calls[0]), 50))
        table["capacity"][v] = row
        print(f"  capacity {v:32s} " + "  ".join(f"{k} {ms:.4f} ms" for k, ms in row.items()),
              flush=True)
    del calls

    cases = static_base_cases(dev)
    if csrc == kb.CSRC_DIR:
        from .utils import kernel_cases

        for x in list(cases.values()) + list(kernel_cases.static_base_edge_inputs(dev).values()):
            k_out, p_out = sb.static_base_cuda(x), sb.static_base_plain(x)
            if not torch.equal(k_out.view(torch.int32), p_out.view(torch.int32)):
                raise RuntimeError("static_base differs from static_base_plain")
        print("static_base equal to static_base_plain bit for bit on both cases and the "
              "edge cases", flush=True)
    for tag, x in cases.items():
        P, N = x.shape
        fill = device_ms(lambda: torch.empty((P, N), device=dev).fill_(-1e9), 20)
        table["static_base"].setdefault("torch.empty(P, N).fill_(-1e9)", {})[tag] = fill
        print(f"  static_base {tag} [{P}, {N}] fill floor {fill:.4f} ms", flush=True)
    # K1 runs 0.2-2 ms a call, far longer than its wrapper on the host:
    # CUDA events around eager calls, the variants in turn, best of 3 turns
    built = {v: lib for v, lib in sb_libs.items() if lib is not None}
    best: dict = {v: {} for v in built}
    for _ in range(3):
        for v, lib in built.items():
            for tag, x in cases.items():
                ms = with_library("static_base", lib, lambda: time_ms(
                    lambda: sb.static_base_cuda(x), 10))
                best[v][tag] = min(ms, best[v].get(tag, ms))
    for v in sb_libs:
        row = best.get(v, "not applicable")
        table["static_base"][v] = row
        if isinstance(row, dict):
            print(f"  static_base {v:32s} "
                  + "  ".join(f"{k} {ms:.4f} ms" for k, ms in row.items()), flush=True)
    for src, text in kb.build_logs.items():
        usage = [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]
        if src in VARIANT_OF:
            print(f"  ptxas {VARIANT_OF[src]}: " + " | ".join(usage), flush=True)
    out = args.out or kb.BUILD_DIR / "kernel_variants.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(table, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
