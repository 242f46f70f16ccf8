"""The scheduler's metrics (`k8s_scheduler_tpu/metrics/metrics.py`) on a
small in-process registry instead of prometheus_client, which the machine
with the card does not have.

`SchedulerMetrics` keeps the reference's metric names, help strings' gist
and label sets for every metric the port's serving code writes (the
`Scheduler`, `ServingPipeline`, `CycleObserver`, `DegradationLadder`,
`CompileWarmer`): counters, gauges (with `set_function`, evaluated when
read), histograms (per-bucket counts) and summaries, each
with `.labels(...)` children, read with `get()` (a histogram's or summary's
sum) and `count`. `scheduler_build_info` carries torch, CUDA and the
device name where the reference's carries jax and its backend.
`SchedulerMetrics.expose()` writes the Prometheus text exposition (format
0.0.4) as prometheus_client's `generate_latest` does, but the `_created`
timestamps; `cmd/httpserver.py` serves it at /metrics."""

from __future__ import annotations

import math
import threading
import time as _time
from typing import Callable

_DURATION_BUCKETS = (
    0.0005, 0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)
_ATTEMPTS_BUCKETS = (1, 2, 3, 5, 8, 13, 21)
_VICTIM_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
_PODS_BUCKETS = (1, 8, 64, 256, 1024, 4096, 16384, 65536)
# same edge family as observe.PHASE_BUCKETS_S
_PHASE_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

class Registry:
    """The metrics of one `SchedulerMetrics`, in declaration order."""

    def __init__(self) -> None:
        self.metrics: list[_Metric] = []

    def expose(self) -> bytes:
        """The Prometheus text exposition of every metric."""
        return "".join(m.expose() for m in self.metrics).encode("utf-8")


def _go_float(d: float) -> str:
    """A sample value as Prometheus's Go client prints it (prometheus_client's
    `floatToGoString`)."""
    d = float(d)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:  # Go switches to exponents sooner than Python
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _label_text(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    esc = {k: v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')
           for k, v in labels.items()}
    return "{" + ",".join(f'{k}="{esc[k]}"' for k in sorted(esc)) + "}"


class _Child:
    def __init__(self, kind: str, buckets=()) -> None:
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Callable[[], float] | None = None
        self._buckets = list(buckets)
        self._counts = [0] * len(self._buckets)
        self._count = 0
        self._kind = kind

    # counter / gauge
    def inc(self, amount: float = 1.0) -> None:
        if self._kind == "counter" and amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    def get(self) -> float:
        """A counter's or gauge's value (a gauge with `set_function` calls
        it now); a histogram's or summary's sum."""
        if self._fn is not None:
            return float(self._fn())
        with self._lock:
            return self._value

    # histogram / summary
    def observe(self, value: float, n: int = 1) -> None:
        """Record `n` samples of `value`."""
        with self._lock:
            self._value += value * n
            self._count += n
            for i, bound in enumerate(self._buckets):
                if value <= bound:
                    self._counts[i] += n
                    break

    @property
    def count(self) -> int:
        with self._lock:
            return self._count


class _Metric:
    kind = ""

    def __init__(self, name: str, documentation: str, labelnames=(),
                 registry: Registry | None = None, buckets=()) -> None:
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._buckets = tuple(buckets)
        self._lock = threading.Lock()
        self._children: dict[tuple, _Child] = {}
        if registry is not None:
            registry.metrics.append(self)
        if not self.labelnames:
            self._children[()] = _Child(self.kind, self._buckets)

    def labels(self, *values, **kw) -> _Child:
        if values and kw:
            raise ValueError("labels: positional or keyword values, not both")
        if kw:
            if set(kw) != set(self.labelnames):
                raise ValueError(f"{self.name}: labels {sorted(kw)}, want "
                                 f"{list(self.labelnames)}")
            values = tuple(str(kw[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: {len(values)} label values for "
                             f"{list(self.labelnames)}")
        with self._lock:
            c = self._children.get(values)
            if c is None:
                c = self._children[values] = _Child(self.kind, self._buckets)
            return c

    def _only(self) -> _Child:
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {list(self.labelnames)}")
        return self._children[()]

    # the unlabelled metric's child methods
    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def set(self, value: float) -> None:
        self._only().set(value)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._only().set_function(fn)

    def observe(self, value: float, n: int = 1) -> None:
        self._only().observe(value, n)

    def get(self) -> float:
        return self._only().get()

    def expose(self) -> str:
        """This metric's family in the text exposition: HELP, TYPE, then a
        child's samples in creation order (a histogram's cumulative
        buckets, `_count`, `_sum`)."""
        name = self.name
        if self.kind == "counter" and not name.endswith("_total"):
            name += "_total"
        doc = self.documentation.replace("\\", "\\\\").replace("\n", "\\n")
        out = [f"# HELP {name} {doc}\n", f"# TYPE {name} {self.kind}\n"]
        with self._lock:
            children = list(self._children.items())
        for values, child in children:
            labels = dict(zip(self.labelnames, values))
            if self.kind in ("counter", "gauge"):
                out.append(f"{name}{_label_text(labels)} {_go_float(child.get())}\n")
                continue
            with child._lock:
                counts, count, total = list(child._counts), child._count, child._value
            if self.kind == "histogram":
                acc = 0
                for bound, n in zip(child._buckets, counts):
                    acc += n
                    le = _label_text({**labels, "le": _go_float(bound)})
                    out.append(f"{name}_bucket{le} {_go_float(acc)}\n")
                le = _label_text({**labels, "le": "+Inf"})
                out.append(f"{name}_bucket{le} {_go_float(count)}\n")
            out.append(f"{name}_count{_label_text(labels)} {_go_float(count)}\n")
            out.append(f"{name}_sum{_label_text(labels)} {_go_float(total)}\n")
        return "".join(out)


class Counter(_Metric):
    kind = "counter"


class Gauge(_Metric):
    kind = "gauge"


class Histogram(_Metric):
    kind = "histogram"


class Summary(_Metric):
    kind = "summary"


class SchedulerMetrics:
    def __init__(self, registry: Registry | None = None) -> None:
        self.registry = registry or Registry()
        r = self.registry
        self.schedule_attempts = Counter(
            "scheduler_schedule_attempts_total",
            "Number of attempts to schedule pods, by result.",
            ["result", "profile"], registry=r)
        self.attempt_duration = Histogram(
            "scheduler_scheduling_attempt_duration_seconds",
            "Scheduling attempt latency (scheduling algorithm + binding).",
            ["result", "profile"], buckets=_DURATION_BUCKETS, registry=r)
        self.e2e_duration = Histogram(
            "scheduler_e2e_scheduling_duration_seconds",
            "E2e scheduling latency (legacy name kept for dashboards).",
            ["result", "profile"], buckets=_DURATION_BUCKETS, registry=r)
        self.pending_pods = Gauge(
            "scheduler_pending_pods",
            "Pending pods, by queue (active|backoff|unschedulable).",
            ["queue"], registry=r)
        self.queue_incoming = Counter(
            "scheduler_queue_incoming_pods_total",
            "Pods added to scheduling queues by queue and event.",
            ["queue", "event"], registry=r)
        self.preemption_attempts = Counter(
            "scheduler_preemption_attempts_total",
            "Total preemption attempts in the cluster so far.", registry=r)
        self.preemption_victims = Histogram(
            "scheduler_preemption_victims",
            "Number of selected preemption victims.",
            buckets=_VICTIM_BUCKETS, registry=r)
        self.binding_duration = Histogram(
            "scheduler_binding_duration_seconds", "Binding latency.",
            buckets=_DURATION_BUCKETS, registry=r)
        self.pod_scheduling_attempts = Histogram(
            "scheduler_pod_scheduling_attempts",
            "Number of attempts to successfully schedule a pod.",
            buckets=_ATTEMPTS_BUCKETS, registry=r)
        self.cache_size = Gauge(
            "scheduler_cache_size",
            "Scheduler cache size, by type (nodes|pods|assumed_pods).",
            ["type"], registry=r)
        # ---- batched-cycle additions ----
        self.cycle_duration = Histogram(
            "scheduler_cycle_duration_seconds",
            "Batched scheduling cycle latency by phase (encode|dispatch|"
            "device|decision_fetch|postfilter|diag_lag|apply|total).",
            ["phase"], buckets=_DURATION_BUCKETS, registry=r)
        self.cycle_pods = Histogram(
            "scheduler_cycle_pods", "Pending-set size per batched cycle.",
            buckets=_PODS_BUCKETS, registry=r)
        self.decisions = Counter(
            "scheduler_pod_node_decisions_total",
            "Pod-node feasibility+scoring decisions evaluated (P*N per "
            "cycle).", registry=r)
        self.unschedulable_reasons = Counter(
            "scheduler_unschedulable_reasons_total",
            "Unschedulable attempts by first-rejecting plugin.",
            ["plugin", "profile"], registry=r)
        self.decision_fetch_bytes = Counter(
            "scheduler_decision_fetch_bytes_total",
            "Bytes moved device->host by the blocking per-cycle decision "
            "fetch (slimmed payload: i16 assignment + u8 flags per pod).",
            registry=r)
        self.encode_ingest = Histogram(
            "scheduler_encode_ingest_seconds",
            "Admission-time incremental encode: per-group staging cost.",
            buckets=_DURATION_BUCKETS, registry=r)
        self.encode_finalize = Histogram(
            "scheduler_encode_finalize_seconds",
            "Flush-time residue of the incremental encode.",
            buckets=_DURATION_BUCKETS, registry=r)
        # ---- flight-recorder derived gauges ----
        self.pipeline_overlap = Gauge(
            "scheduler_pipeline_overlap_ratio",
            "Fraction of host encode time hidden behind in-flight device "
            "work over the recent flight-recorder window (0 = serial).",
            registry=r)
        self.cycle_inflight = Gauge(
            "scheduler_cycle_inflight",
            "Dispatched-but-unfetched serving-pipeline cycles right now.",
            registry=r)
        self.diag_lag = Summary(
            "scheduler_diag_lag_seconds",
            "How far the deferred FailedScheduling attribution trailed "
            "the cycle's blocking decision fetch.", registry=r)
        self.last_cycle_age = Gauge(
            "scheduler_last_cycle_age_seconds",
            "Seconds since the last completed scheduling cycle record.",
            registry=r)
        # ---- latency attribution / anomalies / SLO (core/observe.py) ----
        self.cycle_phase = Histogram(
            "scheduler_cycle_phase_seconds",
            "Per-phase latency attribution of every committed cycle record.",
            ["phase"], buckets=_PHASE_BUCKETS, registry=r)
        self.cycle_phase_p50 = Gauge(
            "scheduler_cycle_phase_p50_seconds",
            "Streaming per-phase p50 from the cycle observer.",
            ["phase"], registry=r)
        self.cycle_phase_p99 = Gauge(
            "scheduler_cycle_phase_p99_seconds",
            "Streaming per-phase p99 from the cycle observer.",
            ["phase"], registry=r)
        self.anomalies = Counter(
            "scheduler_anomalies_total",
            "Typed anomaly detections from the cycle observer.",
            ["class"], registry=r)
        self.slo_burn_rate = Gauge(
            "scheduler_slo_burn_rate",
            "Latency-SLO burn rate over the fast/slow cycle windows.",
            ["window"], registry=r)
        self.slo_budget_remaining = Gauge(
            "scheduler_slo_budget_remaining",
            "Fraction of the slow-window SLO violation budget left.",
            registry=r)
        self.speculation = Counter(
            "scheduler_speculation_total",
            "Depth-2 speculative dispatch outcomes (adopted | abandoned"
            " | redispatched).", ["outcome"], registry=r)
        self.shard_devices = Gauge(
            "scheduler_shard_devices",
            "Devices the serving path's carry is sharded over (1 = one).",
            registry=r)
        self.collective_payload = Gauge(
            "scheduler_collective_payload_bytes",
            "Per-cycle cross-device collective payload of the current "
            "regime's cycle program (0 = one device).",
            ["profile"], registry=r)
        self.compile_cache_speculative = Counter(
            "scheduler_compile_cache_speculative_builds_total",
            "Adjacent pad regimes pre-built by the speculative warm "
            "thread before churn crossed a bucket boundary.", registry=r)
        # ---- robustness / degradation (core/degrade.py) ----
        self.degradation_rung = Gauge(
            "scheduler_degradation_rung",
            "Current degradation-ladder rung (0 = normal, 1 = retrace, "
            "2 = sequential, 3 = forced_sync, 4 = stateless).", registry=r)
        self.degradation_transitions = Counter(
            "scheduler_degradation_transitions_total",
            "Degradation-ladder rung transitions by from/to rung name.",
            ["from", "to"], registry=r)
        self.fetch_failures = Counter(
            "scheduler_fetch_failures_total",
            "Consumed cycles whose blocking decision fetch raised, by "
            "failure class (transport | wedge | deadline | other).",
            ["class"], registry=r)
        self.build_info = Gauge(
            "scheduler_build_info",
            "Constant 1 gauge carrying the build/runtime fingerprint as "
            "labels (python | torch | cuda | device | git).",
            ["python", "torch", "cuda", "device", "git"], registry=r)
        self.uptime = Gauge(
            "scheduler_uptime_seconds",
            "Seconds since SchedulerMetrics construction.", registry=r)
        _t0 = _time.monotonic()
        self.uptime.set_function(lambda: float(int(_time.monotonic() - _t0)))
        # ---- leader election (cmd/leaderelection.py FileLease) ----
        self.leader_state = Gauge(
            "scheduler_leader_state",
            "1 = this process holds the leader lease (or runs without "
            "election), 0 = standby. Evaluated at scrape time.",
            registry=r)
        self.leader_lease_age = Gauge(
            "scheduler_leader_lease_age_seconds",
            "Age of the lease heartbeat as observed by this process "
            "(grows past leaseDuration when the active is dead).",
            registry=r)
        self.program_retry_strikes = Counter(
            "scheduler_program_retry_strikes_total",
            "Program retries absorbed by the resilience wrapper (kind = "
            "transport | backend_wedge).",
            ["program", "kind"], registry=r)

    # ---- convenience recorders ------------------------------------------

    def observe_attempt(
        self, result: str, seconds: float, profile: str = "default-scheduler"
    ) -> None:
        self.schedule_attempts.labels(result=result, profile=profile).inc()
        self.attempt_duration.labels(result=result, profile=profile).observe(seconds)
        self.e2e_duration.labels(result=result, profile=profile).observe(seconds)

    def observe_attempts(
        self, result: str, seconds: float, profile: str = "default-scheduler",
        n: int = 1,
    ) -> None:
        """`n` attempts sharing one outcome and one latency sample, in O(1)
        metric mutations."""
        if n <= 0:
            return
        self.schedule_attempts.labels(result=result, profile=profile).inc(n)
        for h in (self.attempt_duration, self.e2e_duration):
            h.labels(result=result, profile=profile).observe(seconds, n)

    def set_pending(self, counts: dict[str, int]) -> None:
        for queue, n in counts.items():
            self.pending_pods.labels(queue=queue).set(n)

    def set_cache(self, nodes: int, pods: int, assumed: int) -> None:
        self.cache_size.labels(type="nodes").set(nodes)
        self.cache_size.labels(type="pods").set(pods)
        self.cache_size.labels(type="assumed_pods").set(assumed)

    def set_build_info(self, info: dict[str, str] | None = None) -> None:
        self.build_info.labels(**(info or build_fingerprint())).set(1)

    def expose(self) -> bytes:
        """The Prometheus text exposition (the /metrics payload)."""
        return self.registry.expose()


def build_fingerprint() -> dict[str, str]:
    """Best-effort build/runtime identity: the python and torch versions,
    torch's CUDA version, the device serving cycles (the card's name, or
    "cpu"), and `git describe` of the working tree. Every probe degrades
    to a placeholder."""
    import platform

    info = {"python": platform.python_version(), "torch": "unavailable",
            "cuda": "none", "device": "cpu", "git": "unknown"}
    try:
        import torch

        info["torch"] = str(torch.__version__)
        info["cuda"] = str(torch.version.cuda or "none")
        if torch.cuda.is_available():
            info["device"] = torch.cuda.get_device_name(0)
    except Exception:
        pass
    try:
        import os
        import subprocess

        out = subprocess.run(
            ["git", "describe", "--always", "--dirty", "--tags"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5.0)
        if out.returncode == 0 and out.stdout.strip():
            info["git"] = out.stdout.strip()
    except Exception:
        pass
    return info


_global_lock = threading.Lock()
_global: SchedulerMetrics | None = None


def global_metrics() -> SchedulerMetrics:
    global _global
    with _global_lock:
        if _global is None:
            _global = SchedulerMetrics()
        return _global
