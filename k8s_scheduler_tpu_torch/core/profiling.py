"""Per-plugin profiling pass (the port of `k8s_scheduler_tpu/core/profiling.py`).

The serving cycle runs the static filters and scores fused in K1 and the
dynamic ones in K13 / K14 / K15, so per-plugin latency is not separable
there. This pass times each enabled plugin's own plain-torch functions
alone, as the reference times its jitted probes, and records the upstream
per-plugin histograms:

    scheduler_plugin_execution_duration_seconds{plugin,extension_point,status}
    scheduler_framework_extension_point_duration_seconds{extension_point,status}

plus the per-plugin decision-log report (feasible fraction per Filter,
score statistics per Score). Its report's keys and statistics equal the
reference's on the same snapshot; its seconds are this device's: CUDA
events on the card (best of `repeats`, after an untimed first call), the
host clock on the CPU. It runs off the decision path (`Scheduler.
profile_cycle`), never in the serving loop.

For kernel-level detail, `trace_cycle` runs one cycle under
`torch.profiler` and writes a Chrome trace (Perfetto / chrome://tracing).
"""

from __future__ import annotations

import time as _time
from typing import Any, Iterable

import torch

from ..framework.interfaces import (AffinityKernels, CycleContext, DynKernels,
                                    VolumeKernels)
from ..framework.runtime import Framework
from ..metrics import SchedulerMetrics
from ..models.encoding import ClusterSnapshot
from ..ops import argsel, commit


def _plain_context(snap: ClusterSnapshot) -> CycleContext:
    """A context whose hooks run the plugins' plain versions on any device."""
    return CycleContext(snap, AffinityKernels.plain(), volume_kernels=VolumeKernels.plain(),
                        dyn_kernels=DynKernels.plain())


def _time_call(fn, snap, repeats: int = 3) -> tuple[float, Any]:
    """An untimed first call, then the best of `repeats` in seconds: CUDA
    events around the call on the card, the host clock on the CPU."""
    out = fn(snap)
    dev = snap.node_valid.device
    best = float("inf")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(repeats):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = fn(snap)
            t1.record()
            t1.synchronize()
            best = min(best, t0.elapsed_time(t1) / 1e3)
        return best, out
    for _ in range(repeats):
        t0 = _time.perf_counter()
        out = fn(snap)
        best = min(best, _time.perf_counter() - t0)
    return best, out


def profile_plugins(
    framework: Framework,
    snap: ClusterSnapshot,
    metrics: SchedulerMetrics | None = None,
    repeats: int = 3,
) -> dict[str, dict[str, Any]]:
    """Time each plugin's static and dynamic functions alone; returns a
    report {"<plugin>/<point>[ [dyn]]": {extension_point, seconds, ...stats}}
    and records the per-plugin and per-point histograms when `metrics` is
    given."""
    report: dict[str, dict[str, Any]] = {}
    point_totals = {"Filter": 0.0, "Score": 0.0}
    # probes are cached on the framework, as the reference's jitted ones
    # are, so repeated passes reuse them
    cache: dict[Any, Any] = framework.__dict__.setdefault("_probe_cache", {})
    valid = snap.pod_valid[:, None] & snap.node_valid[None, :]
    n_valid = max(int(valid.sum()), 1)

    def observe(plugin: str, point: str, secs: float) -> None:
        point_totals[point] += secs
        if metrics is not None:
            metrics.plugin_duration.labels(
                plugin=plugin, extension_point=point, status="Success").observe(secs)

    for plugin in framework.filters:
        if ("static", plugin.name, "Filter") not in cache:
            cache[("static", plugin.name, "Filter")] = (
                lambda s, p=plugin: p.static_mask(_plain_context(s)))
        fn = cache[("static", plugin.name, "Filter")]
        if fn(snap) is None:  # dynamic-only plugin (no static function)
            continue
        secs, mask = _time_call(fn, snap, repeats)
        feasible = float(int((mask & valid).sum()) / n_valid)
        report[f"{plugin.name}/Filter"] = {
            "extension_point": "Filter",
            "seconds": secs,
            "feasible_fraction": feasible,
        }
        observe(plugin.name, "Filter", secs)

    for plugin, weight in framework.scores:
        if ("static", plugin.name, "Score") not in cache:
            cache[("static", plugin.name, "Score")] = (
                lambda s, p=plugin: p.static_score(_plain_context(s)))
        fn = cache[("static", plugin.name, "Score")]
        if fn(snap) is None:
            continue
        secs, score = _time_call(fn, snap, repeats)
        sc = score[valid]
        report[f"{plugin.name}/Score"] = {
            "extension_point": "Score",
            "seconds": secs,
            "weight": weight,
            # numpy's f32 mean, as the reference takes it
            "score_mean": float(sc.cpu().numpy().mean()) if sc.numel() else 0.0,
            "score_max": float(sc.max()) if sc.numel() else 0.0,
        }
        observe(plugin.name, "Score", secs)

    # ---- dynamic path: each plugin's per-pod functions in an isolated
    # sequential commit over the whole pending set, the per-cycle cost the
    # plugin adds to the scan ----
    for point, as_score, plugins in (
            ("Filter", False, [(p, None) for p in framework.filters]),
            ("Score", True, list(framework.scores))):
        for plugin, weight in plugins:
            if ("dyn", plugin.name, point) not in cache:
                cache[("dyn", plugin.name, point)] = _dyn_probe(plugin, snap, as_score)
            fn = cache[("dyn", plugin.name, point)]
            if fn is None:
                continue
            secs, _ = _time_call(fn, snap, repeats)
            entry: dict[str, Any] = {"extension_point": point, "seconds": secs}
            if as_score:
                entry["weight"] = weight
            report[f"{plugin.name}/{point}[dyn]"] = entry
            observe(plugin.name, point, secs)

    if metrics is not None:
        for point, total in point_totals.items():
            if total > 0.0:
                metrics.extension_point_duration.labels(
                    extension_point=point, status="Success").observe(total)
    return report


def _score_tensor(s, zero: torch.Tensor) -> torch.Tensor:
    """A dynamic score [N] as a tensor: a `commit.Product` or
    `OneResourceFit` x * c, a `commit.Constant` c."""
    if isinstance(s, commit.Constant):
        return torch.full_like(zero, s.c)
    if isinstance(s, (commit.Product, commit.OneResourceFit)):
        return s.x * s.c
    return s


def _dyn_probe(plugin, snap: ClusterSnapshot, as_score: bool):
    """An isolated sequential commit exercising ONE plugin's dynamic path
    (mask or score) plus its state update; None when the plugin has no such
    path (decided on pod 0, as the reference decides it at trace time). The
    loop mirrors the scan engine's step so timings are representative of
    the plugin's marginal cost."""
    ctx0 = _plain_context(snap)
    e0 = plugin.extra_init(ctx0)
    ext0 = {} if e0 is None else {plugin.name: e0}
    p0 = torch.zeros((), dtype=torch.int32, device=snap.node_valid.device)
    probe = (
        plugin.dyn_score(ctx0, p0, snap.node_requested, ext0, snap.node_valid)
        if as_score
        else plugin.dyn_mask(ctx0, p0, snap.node_requested, ext0)
    )
    if probe is None:
        return None

    def fn(snap):
        ctx = _plain_context(snap)
        e = plugin.extra_init(ctx)
        ext = {} if e is None else {plugin.name: e}
        order = torch.argsort(snap.pod_order, stable=True).to(torch.int32)
        node_req = snap.node_requested.clone()
        zero = torch.zeros((snap.N,), dtype=torch.float32, device=node_req.device)
        for rank in range(snap.P):
            p = order[rank]
            mask = snap.node_valid
            score = zero
            if as_score:
                score = _score_tensor(plugin.dyn_score(ctx, p, node_req, ext, mask),
                                      zero)
            else:
                mask = mask & plugin.dyn_mask(ctx, p, node_req, ext)
            best = argsel.argmax_first(torch.where(mask, score, -1e9), dim=0).long()
            ok = mask[best] & snap.pod_valid[p]
            node_req[best] += torch.where(ok, snap.pod_requested[p], 0.0)
            if plugin.name in ext:
                ext = {plugin.name: plugin.extra_update(ctx, ext[plugin.name], p, best, ok)}
        return node_req

    return fn


def overlap_stats(
    encode_s: float, device_s: float, pipelined_s: float
) -> dict[str, float]:
    """Split-phase overlap accounting for the serving pipeline
    (core/pipeline.py): given three independently measured medians —
    host encode alone, device cycle (dispatch + slimmed decision fetch)
    alone, and the pipelined per-cycle wall time — report how much of the
    smaller stage was hidden behind the larger one.

        hidden      = encode + device - pipelined   (>= 0)
        overlap_pct = hidden / min(encode, device) * 100

    100% means the cheaper stage ran entirely in the other's shadow; 0%
    means no overlap (fully serial — e.g. forced_sync)."""
    hidden = max(0.0, encode_s + device_s - pipelined_s)
    denom = min(encode_s, device_s)
    pct = 100.0 * hidden / denom if denom > 0 else 0.0
    return {
        "encode_ms": round(encode_s * 1e3, 3),
        "device_ms": round(device_s * 1e3, 3),
        "pipelined_ms": round(pipelined_s * 1e3, 3),
        "encode_hidden_ms": round(min(hidden, encode_s) * 1e3, 3),
        "overlap_pct": round(min(pct, 100.0), 1),
    }


def overlap_from_records(
    phase_dicts: "Iterable[dict[str, float]]",
) -> dict[str, float]:
    """Continuous overlap accounting from flight-recorder records — the
    production counterpart of `overlap_stats`. Each input dict is a
    CycleRecord's `phases` (encode_ms, decision_wait_ms, encode_hidden_ms,
    diag_lag_ms, ...). `overlap_ratio` = hidden encode / total encode over
    the window (hidden = max(0, encode - decision_wait) where a record does
    not carry it); 0.0 = fully serial, 1.0 = every encode in the device's
    shadow. Pure Python."""
    n = 0
    enc = hidden = wait = diag = diag_n = 0.0
    for ph in phase_dicts:
        n += 1
        e = ph.get("encode_ms", 0.0)
        w = ph.get("decision_wait_ms", 0.0)
        enc += e
        wait += w
        hidden += ph.get("encode_hidden_ms", max(0.0, e - w))
        if "diag_lag_ms" in ph:
            diag += ph["diag_lag_ms"]
            diag_n += 1
    return {
        "window": float(n),
        "encode_ms_mean": round(enc / n, 4) if n else 0.0,
        "decision_wait_ms_mean": round(wait / n, 4) if n else 0.0,
        "encode_hidden_ms_mean": round(hidden / n, 4) if n else 0.0,
        "diag_lag_ms_mean": round(diag / diag_n, 4) if diag_n else 0.0,
        "overlap_ratio": round(min(hidden / enc, 1.0), 4) if enc > 0
        else 0.0,
    }


TRACE_FILE = "cycle_trace.json"


def trace_cycle(cycle_fn, snap, log_dir: str):
    """One cycle, `cycle_fn(snap)`, under `torch.profiler` (CPU activity,
    and CUDA where the machine has a card), its Chrome trace written to
    `<log_dir>/cycle_trace.json` (`TRACE_FILE`). Returns the cycle's
    output, as the reference's does."""
    import os

    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        out = cycle_fn(snap)
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
    return out
