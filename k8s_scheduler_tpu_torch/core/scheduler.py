"""The Scheduler (`k8s_scheduler_tpu/core/scheduler.py`), single-cycle path:
event handlers, the cycle driver, bind and preemption plumbing.

Informer events maintain the cache and queue; each `schedule_cycle()`
encodes the ready set into a packed frame on the device, runs the cycle
program through the `ServingPipeline` (`core/pipeline.py`), assumes the
winners, hands them to the binder, runs the preemption PostFilter for the
losers and routes them back through the backoff / unschedulable tiers with
their FailedScheduling reasons (the diagnosis program on the carry path).

Two program chains, as in the reference (`_use_carry`):
- the device-carry path (`commitMode: rounds`, the default, with no HTTP
  extender or with every extender setting `carryVerdicts`): the
  encoder's `encode_packed` frame, the stable tables
  (`build_stable_state_fn`, memoized per stable side), the carried static
  base (`CarryKeeper`), the carried extender verdicts
  (`ExtenderVerdictKeeper`: the webhooks consulted for the changed pods
  only), `build_packed_cycle_carry_fn`, and off the decision path
  `build_diagnosis_fn`;
- the packed path (`commitMode: scan`, or extenders without
  `carryVerdicts`): a full encode packed into the pipeline's upload slot,
  with every pending pod's extender verdicts as the snapshot's planes, and
  `build_packed_cycle_fn` (its full outputs carry the reject counts);
both with `build_packed_preemption_fn`. A pod whose non-ignorable extender
failed retries with backoff (a `BindError`); a bind-verb extender binds in
place of the binder. On the card the cycle launches the
hand kernels through the programs' default kernel functions; a Scheduler
built for the card raises where there is no CUDA device (`device="cpu"`
runs the plain versions, as the tests do).

The slim decision fetch is the one blocking wait of the decision path;
winners bind before the preemption and diagnosis programs are enqueued
(same stream) and forced for the losers, and cycle k's binds fold into the
cache before cycle k+1's encode reads it. `forced_sync` restores
sequential execution.

Durable state (`state=`, a `state.DurableState`): attached in the
constructor — the snapshot and journal tail restored, then every queue and
cache mutation journaled, and the pods in flight at a predecessor's crash
requeued — one journal batch record a cycle's apply phase, interval
snapshots between cycles, and seal-and-detach at the `stateless` rung. The
front door (`service/admission.py`) closes each pod's submit->bind window
at its bind; armed tracing (`core/spans.py`) stamps the dispatch, decision,
apply, bind and preemption spans of every sampled pod; an armed black box
(`core/blackbox.py`) dumps a bundle at a watchdog abort and at the
`stateless` rung; a fault plan (`faultSpec` / SCHED_FAULTS,
`core/faults.py`) is armed in the constructor and stamps its cycle index
(and any clock skew) at the top of each cycle. `compileCacheDir` (or
`<stateDir>/compile_cache`) opens the persistent kernel cache for the
process (`core/compile_cache.py`); `profile_cycle` runs the per-plugin
profiling pass (`core/profiling.py`).

Multi-cycle serving (`multiCycleK` > 1, reference `core/scheduler.py:
1576-2559`): each profile's arrival groups coalesce until K are buffered,
the arrival stream pauses or the oldest ages past `multiCycleMaxWaitMs`,
then one dispatch of `core/cycle.build_packed_multicycle_fn` runs them as
inner cycles, applied row by row through `_apply_phase` (binds, journal
records, events and flight records per inner cycle, as K sequential
dispatches would). Batches outside the exactness envelope fall back to
sequential dispatches (sticky per profile, but per batch for pending host
ports). `speculativeDispatch` splits a flush depth-2: row 0 alone, the rest
chained on its device carry and adopted or abandoned on the fold's
predicate digest (`speculation_ledger`). `incrementalEncode` stages each
buffered pod's row at buffer time (`_ingest_group`).

Refused when a configuration turns it on: multi-device serving
(`shardDevices` > 1, ROADMAP A13)."""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading as _threading
import time as _time
from typing import Callable

import numpy as np

from ..config import SchedulerConfiguration
from ..framework.runtime import Framework
from ..internal.cache import SchedulerCache
from ..internal.queue import (
    EVENT_NODE_ADD,
    EVENT_NODE_DELETE,
    EVENT_NODE_UPDATE,
    EVENT_POD_ADD,
    EVENT_POD_DELETE,
    EVENT_POD_UPDATE,
    EVENT_PV_CHANGE,
    EVENT_PVC_CHANGE,
    EVENT_STORAGE_CLASS_CHANGE,
    SchedulingQueue,
)
from ..metrics import SchedulerMetrics
from ..models.api import Node, Pod, PodGroup
from ..models.encoding import SnapshotEncoder, pref_raw_bound
from ..utils.device import resolve_device
from .cycle import (
    _Resilient,
    build_packed_cycle_fn,
    build_packed_preemption_fn,
    build_stable_state_fn,
    classify_failure,
)
from .degrade import (
    RUNG_FORCED_SYNC,
    RUNG_RETRACE,
    RUNG_STATELESS,
    RUNG_SEQUENTIAL,
    DegradationLadder,
)
from . import blackbox as _blackbox
from . import faults as _faults
from . import spans as _spans
from .events import EventRecorder, failed_scheduling_message
from .flight_recorder import FlightRecorder

# binder(pod, node_name) -> None; raise to signal bind failure
Binder = Callable[[Pod, str], None]
# evictor(pod, node_name) -> None (preemption victim deletion)
Evictor = Callable[[Pod, str], None]


@dataclasses.dataclass
class CycleStats:
    attempted: int = 0
    scheduled: int = 0
    unschedulable: int = 0
    bind_errors: int = 0
    preemptors: int = 0
    victims: int = 0
    gang_dropped: int = 0
    cycle_seconds: float = 0.0


def _pad(n: int, bucket: int = 64) -> int:
    n = max(n, 1)
    return ((n + bucket - 1) // bucket) * bucket


def _refuse_unported(config: SchedulerConfiguration) -> None:
    """Serving features later slices port: a configuration that turns one
    on is refused by name, never ignored."""
    checks = (
        (int(config.shard_devices) > 1,
         f"shardDevices={config.shard_devices} (multi-device serving) is not "
         "ported yet (ROADMAP A13)"),
    )
    for on, why in checks:
        if on:
            raise NotImplementedError(why)


class Scheduler:
    def __init__(
        self,
        config: SchedulerConfiguration | None = None,
        binder: Binder | None = None,
        evictor: Evictor | None = None,
        now: Callable[[], float] = _time.monotonic,
        pad_bucket: int = 64,
        metrics: SchedulerMetrics | None = None,
        events: EventRecorder | None = None,
        host_plugins: "list | None" = None,
        forced_sync: bool | None = None,  # None = config.forced_sync
        flight_recorder: FlightRecorder | None = None,  # None = build from
        # config.flight_recorder_size (0 disables recording)
        state: "object | None" = None,  # state.DurableState | None:
        # attach() restores any existing state BEFORE the first cycle (the
        # standby-takeover path) and starts journaling mutations
        device=None,  # None = the card (raises without one); "cpu" runs
        # the plain versions
    ) -> None:
        self.config = config or SchedulerConfiguration()
        _refuse_unported(self.config)
        self.device = resolve_device(device)
        names = [p.scheduler_name for p in self.config.profiles]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate profile schedulerNames: {names}")
        self.frameworks = {
            n: Framework.from_config(self.config, scheduler_name=n)
            for n in names
        }
        self._profile_order = names
        self.framework = self.frameworks[names[0]]
        self.cache = SchedulerCache(now=now)
        # a fresh registry by default: two Schedulers in one process must
        # not cross-count
        self.metrics = metrics or SchedulerMetrics()
        self.queue = SchedulingQueue(
            initial_backoff_seconds=self.config.pod_initial_backoff_seconds,
            max_backoff_seconds=self.config.pod_max_backoff_seconds,
            now=now,
            on_enqueue=lambda queue, event: self.metrics.queue_incoming.labels(
                queue=queue, event=event
            ).inc(),
        )
        self.binder = binder or (lambda pod, node: None)
        self.evictor = evictor or (lambda pod, node: None)
        # the submission front door (service/admission.py) attaches itself
        # here so _bind can close the submit->bind window and
        # _commit_record can stamp it on the cycle record
        self.admission = None
        # durable state: restore-then-journal, after queue/cache exist and
        # before any cycle, so a standby that just won the lease resumes
        # with the exact backoff deadlines, attempt counts and assumed pods
        # the dead active had journaled
        self.state = state
        if state is not None:
            state.attach(self.queue, self.cache)
            # pods that were mid-cycle when the previous leader died have
            # no outcome records: requeue them (journaled), or the first
            # pop_ready would drop them with no informer to re-deliver
            self.queue.recover_in_flight()
        self.events = events or EventRecorder()
        if flight_recorder is not None:
            self.flight: FlightRecorder | None = flight_recorder
        elif self.config.flight_recorder_size > 0:
            self.flight = FlightRecorder(
                capacity=self.config.flight_recorder_size
            )
        else:
            self.flight = None
        if self.flight is not None:
            self.metrics.last_cycle_age.set_function(
                self.flight.last_cycle_age_s
            )
            from .observe import CycleObserver

            self.observer = CycleObserver(
                metrics=self.metrics,
                slo_p99_ms=self.config.slo_p99_ms,
                slo_window_cycles=self.config.slo_window_cycles,
                spec_hold_cycles=self.config.degrade_promote_cycles,
            )
            self.observer.epoch = self.flight.epoch
            self.flight.observers.append(self.observer.observe)
        else:
            self.observer = None
            if self.config.slo_p99_ms > 0:
                logging.getLogger(__name__).warning(
                    "sloP99Ms=%g is configured but the flight recorder "
                    "is disabled (flightRecorderSize=0): the SLO engine "
                    "and the anomaly sentinel are off", self.config.slo_p99_ms,
                )
        # the degradation ladder (core/degrade.py): dispatch / fetch
        # failures step it down, clean cycles promote it back up
        self.ladder = DegradationLadder(
            promote_after=self.config.degrade_promote_cycles,
            metrics=self.metrics,
            events=self.events,
            observer=self.observer,
            on_transition=self._on_rung_transition,
        )
        if state is not None:
            # /debug/state shows the current rung next to the journal
            state.degradation = self.ladder
        # watchdog bound on the blocking decision fetch (0 = unbounded)
        self._dispatch_deadline_s = (
            max(float(self.config.dispatch_deadline_ms), 0.0) / 1e3
        )
        # fault injection (core/faults.py): armed process-globally from
        # config faultSpec / env SCHED_FAULTS; unarmed, every hook is a
        # dead branch
        self._fault_plan = None
        self._cycle_counter = 0
        fault_spec = self.config.fault_spec or os.environ.get("SCHED_FAULTS", "")
        if fault_spec:
            self._fault_plan = _faults.FaultPlan.parse(fault_spec)
            _faults.arm(self._fault_plan)
            logging.getLogger(__name__).warning(
                "fault injection ARMED: %s", fault_spec)
        self._now = now
        self._pad_bucket = pad_bucket
        self._groups: dict[str, PodGroup] = {}
        self._pvcs: dict[str, object] = {}  # "ns/name" -> PVC
        self._pvs: dict[str, object] = {}  # name -> PV
        self._storage_classes: dict[str, object] = {}
        self._pdbs: dict[str, object] = {}  # "ns/name" -> PDB
        # host-side extension points (Reserve/Permit/PreBind/PostBind) and
        # HTTP scheduler extenders (framework/host.py)
        from ..framework.host import HTTPExtender

        self.host_plugins = list(host_plugins or [])
        self.extenders = [HTTPExtender(c) for c in self.config.extenders]
        # per-cycle decision log: what the last schedule_cycle nominated
        # (preemptors) and evicted (victims)
        self.last_nominations: list[tuple[Pod, str]] = []
        self.last_evictions: list[tuple[Pod, str]] = []
        # one encoder per profile for the scheduler's lifetime (stable
        # interning, one delta arena per profile); the profile's queueSort
        # plugin owns each encoder's pod_order rank
        from ..framework.queuesort import queue_sort_for_profile

        self._encoders = {
            n: SnapshotEncoder(
                device=self.device,
                queue_sort=queue_sort_for_profile(self.config.profile(n)),
                pad_existing=self.config.pad_existing or None,
                pad_pods_per_node=self.config.pad_pods_per_node or None,
                pad_ma=self.config.pad_ma or None,
                pad_mc=self.config.pad_mc or None,
                pad_hysteresis_pct=self.config.pad_hysteresis_pct,
            )
            for n in names
        }
        self.forced_sync = (
            self.config.forced_sync if forced_sync is None else forced_sync
        )
        self._encoder = self._encoders[names[0]]
        self._cycle_kw = dict(
            gang_scheduling=self.config.gang_scheduling,
            commit_mode=self.config.commit_mode,
            percentage_of_nodes_to_score=(
                self.config.percentage_of_nodes_to_score
            ),
        )
        # the packed program sets, built lazily per pack layout and profile
        # and memoized (LRU) so regime flip-flops reuse earlier builds
        self._packed: dict = {}
        self._dev_stable: dict = {}
        self._packed_builds = 0
        self._last_build_s = 0.0
        self._last_compile_source = "cold"
        self._packed_lock = _threading.Lock()
        # the persistent kernel cache (core/compile_cache.py): the nvcc
        # libraries under compileCacheDir, or the state dir's compile_cache/
        # subtree; the kernels are process-wide, so the cache opens for the
        # process (utils/compilation_cache.py)
        cc_dir = self.config.compile_cache_dir
        if cc_dir.lower() in ("off", "none"):
            # explicit opt-out even with a state dir: "" means derive, not off
            cc_dir = ""
        elif not cc_dir and state is not None:
            cc_dir = getattr(state, "compile_cache_path", "")
        self._compile_cache = None
        if cc_dir:
            from ..utils.compilation_cache import enable_compilation_cache

            self._compile_cache = enable_compilation_cache(cc_dir, metrics=self.metrics)
            if state is not None:
                # /debug/state shows hit / miss / entry counts next to the
                # journal the same directory tree holds
                state.compile_cache = self._compile_cache
        self._warmer = None
        if self.config.speculative_compile and self.observer is not None:
            from .compile_cache import CompileWarmer

            # lazy daemon thread: nothing starts until the first submit
            self._warmer = CompileWarmer(metrics=self.metrics)
        self.n_devices = 1
        self.metrics.shard_devices.set(self.n_devices)
        self._collective_payload: dict[str, int] = {}
        # one device, no mesh (multi-device serving is ROADMAP A13): the
        # layout /debug/state shows next to the journal
        self._shard_status = {"n_devices": self.n_devices, "mesh": None,
                              "collective_payload_bytes": self._collective_payload}
        if state is not None:
            state.sharding = self._shard_status
        # extenders keep the carry path when every one opts into the
        # verdict carry (carryVerdicts: its Filter/Prioritize verdicts are
        # deterministic per pod, so rows persist on the device and only
        # changed pods consult the webhook again)
        self._extender_carry = bool(self.extenders) and all(
            e.config.carry_verdicts for e in self.extenders
        )
        self._use_carry = self.config.commit_mode == "rounds" and (
            not self.extenders or self._extender_carry
        )
        if (self.config.commit_mode == "rounds" and self.extenders
                and not self._extender_carry):
            # their verdicts may be stateful: every cycle consults every
            # pod and takes the full encode and the in-cycle attribution
            logging.getLogger(__name__).warning(
                "scheduler: %d HTTP extender(s) configured without "
                "carryVerdicts - the device-carry latency path is "
                "DISABLED; cycles take the full re-encode + in-cycle "
                "attribution path",
                len(self.extenders),
            )
        # per-profile in-place-mutation reports (the delta arena must
        # re-read a nominated pod's slot)
        self._nominated_mut: dict[str, set[int]] = {n: set() for n in names}
        # multi-cycle serving: per-profile arrival groups coalesce in
        # _mc_groups until a flush; _mc_fns memoizes the per-regime batch
        # programs; _mc_off pins the profiles whose workload left the
        # exactness envelope (sticky capability flags)
        self._mc_k = max(int(self.config.multi_cycle_k), 1)
        self._mc_wait_s = max(float(self.config.multi_cycle_max_wait_ms), 0.0) / 1e3
        self._mc_groups: dict[str, list[tuple[float, list[Pod]]]] = {n: [] for n in names}
        self._mc_fns: dict = {}
        self._mc_off: dict[str, str] = {}
        # profiles whose delta arena a batch's host encodes left stale: the
        # next single-cycle record is stamped post_batch=1
        self._mc_stale_arena: set[str] = set()
        # incrementalEncode: ingest seconds since the last flush, and the
        # flush's phase stamps awaiting inner record 0
        self._ingest_s: dict[str, float] = {}
        self._flush_phases: dict[str, dict] = {}
        if self.extenders:
            # verdicts are consulted per host cycle: no batching
            self._mc_off = {n: "extender" for n in names}

    # ---- the packed programs ---------------------------------------------

    def _packed_fns(self, spec, profile: str):
        """The program set of `spec`'s regime: (cycle, preempt, stable_fn,
        keeper, diag, ext_keeper, pipe), memoized per pack layout and
        profile. The layout is the spec without the host-side bound
        `pref_raw_bound`, which moves with the pending set: a hit with
        another bound rebinds the three programs that unpack with the
        spec (closures; the carry, the pipeline and the stable function
        stay), which counts as no build."""
        key = (spec.layout_key(), profile)
        with self._packed_lock:
            entry = self._packed.get(key)
            if entry is not None:
                self._packed.pop(key)
                self._packed[key] = entry  # move-to-end on hit
                if entry.pop("fresh", None):
                    # first serve-path use of a speculative warm build
                    self._packed_builds += 1
                    self._last_build_s = 0.0
                    self._last_compile_source = "speculative"
        if entry is not None:
            if entry["spec"].key() != spec.key():
                self._rebind(entry, spec, profile)
            return entry["fns"]
        entry = self._build_packed_entry(spec, profile)
        with self._packed_lock:
            cur = self._packed.setdefault(key, entry)
            self._packed.pop(key)
            self._packed[key] = cur
            cur.pop("fresh", None)
            self._packed_builds += 1
            self._last_build_s = entry["build_s"]
            self._last_compile_source = entry["source"]
            while len(self._packed) > 4 * len(self.frameworks):
                self._packed.pop(next(iter(self._packed)))
        if cur["spec"].key() != spec.key():
            self._rebind(cur, spec, profile)
        return cur["fns"]

    def _programs(self, spec, profile: str):
        """(cycle, preempt, diag) of `spec` for `profile`."""
        from .cycle import build_diagnosis_fn, build_packed_cycle_carry_fn

        fw = self.frameworks[profile]
        dev = self.device
        if self._use_carry:
            ext = self._extender_carry
            cyc = _Resilient(build_packed_cycle_carry_fn(
                spec, framework=fw,
                gang_scheduling=self._cycle_kw["gang_scheduling"],
                percentage_of_nodes_to_score=self._cycle_kw[
                    "percentage_of_nodes_to_score"],
                extender_args=ext,
                device=dev,
            ), "packed_cycle_carry")
            diag = _Resilient(build_diagnosis_fn(spec, fw, extender_args=ext, device=dev),
                              "diagnosis")
        else:
            cyc = build_packed_cycle_fn(spec, framework=fw, device=dev,
                                        **self._cycle_kw)
            diag = None
        preempt = build_packed_preemption_fn(spec, fw, device=dev)
        if preempt is not None:
            preempt = _Resilient(preempt, "packed_preemption")
        return cyc, preempt, diag

    def _rebind(self, entry: dict, spec, profile: str) -> None:
        cyc, preempt, diag = self._programs(spec, profile)
        fns = entry["fns"]
        pipe = fns[6]
        pipe._cycle_fn, pipe._preempt_fn, pipe._diag_fn = cyc, preempt, diag
        entry["fns"] = (cyc, preempt) + fns[2:4] + (diag,) + fns[5:]
        entry["spec"] = spec

    def _build_packed_entry(self, spec, profile: str) -> dict:
        """One regime's full program set (the `_packed` memo entry). Pure
        with respect to scheduler state — safe on the speculative warm
        thread. The port has no ahead-of-time compile: a build is the
        program closures (the kernels build at first use, cached per
        process by `ops/kernel_build.py`)."""
        from .cycle import CarryKeeper, ExtenderVerdictKeeper
        from .pipeline import ServingPipeline

        fw = self.frameworks[profile]
        t_build = _time.perf_counter()
        cyc, preempt, diag = self._programs(spec, profile)
        keeper = (CarryKeeper(spec, fw, device=self.device)
                  if self._use_carry else None)
        ext_keeper = (ExtenderVerdictKeeper(spec, device=self.device)
                      if self._use_carry and self._extender_carry else None)
        pipe = ServingPipeline(
            cyc,
            keeper=keeper,
            diag_fn=diag,
            preempt_fn=preempt,
            forced_sync=self.forced_sync,
            metrics=self.metrics,
            events=self.events,
            dispatch_deadline_s=self._dispatch_deadline_s,
            # depth-2 speculation keeps two batches in flight: a third slot
            slots=(3 if self.config.speculative_dispatch and self._mc_k > 1 else 2),
            device=self.device,
        )
        fns = (
            cyc, preempt,
            _Resilient(build_stable_state_fn(spec, device=self.device), "stable"),
            keeper, diag, ext_keeper, pipe,
        )
        return {
            "fns": fns,
            "spec": spec,
            "build_s": _time.perf_counter() - t_build,
            "source": "cold",
        }

    def _maybe_speculate(self, profile: str, spec) -> None:
        """Speculative warm build, run at the tail of a profile's cycle:
        when the observer's demand EWMA for this profile drifts within the
        margin of the current P pad bucket's boundary, derive the adjacent
        regime's spec (`packing.respec`) and hand its build to the warm
        thread."""
        warmer = self._warmer
        obs = self.observer
        if warmer is None or obs is None:
            return
        from ..models import packing

        sig = dict(packing.shape_signature(spec))
        P = sig.get("P", 0)
        if P <= 0:
            return
        demand = obs.demand_ewma(profile)
        if demand <= 0.0:
            return
        bucket = self._pad_bucket
        targets = []
        if demand >= 0.85 * P:
            targets.append(_pad(P + 1, bucket))
        down = _pad(max(int(demand), 1), bucket)
        if down < P and demand <= down * (
            1.0 - max(self.config.pad_hysteresis_pct, 10.0) / 100.0
        ):
            targets.append(down)
        for tgt in targets:
            adj = packing.respec(spec, {"P": tgt})
            if adj is None:
                continue
            key = (adj.layout_key(), profile)
            with self._packed_lock:
                if key in self._packed:
                    continue
            warmer.enqueue_build(
                ("packed",) + key,
                lambda adj=adj, profile=profile: self._warm_regime(adj, profile),
            )

    def _warm_regime(self, spec, profile: str) -> None:
        """Warm-thread body: pre-build one predicted regime's programs into
        the `_packed` memo, and on the card build (and load) every CUDA
        kernel library, launching nothing."""
        key = (spec.layout_key(), profile)
        with self._packed_lock:
            if key in self._packed:
                return
        if self.device.type == "cuda":
            from ..ops import kernel_build

            for name in kernel_build.CUDA_KERNELS:
                kernel_build.load_cuda_library(name)
        entry = self._build_packed_entry(spec, profile)
        entry["source"] = "speculative"
        entry["fresh"] = True
        with self._packed_lock:
            self._packed.setdefault(key, entry)
            while len(self._packed) > 4 * len(self.frameworks) + 1:
                self._packed.pop(next(iter(self._packed)))

    def _stable_state(self, spec, stable_fn, wbuf, bbuf, encoder=None):
        """The stable tables on the device, rerun only when the encoder's
        stable side (nodes / existing pods / dedup tables) or the pack
        layout changes. Keyed on the encoder's stable dict identity (a
        strong reference pinned in the entry) and `fold_hits`, which the
        existing-set fold bumps while it rewrites that dict in place."""
        enc = encoder or self._encoder
        enc_st = getattr(enc, "_stable", None)
        key = (spec.layout_key(), id(enc_st), getattr(enc, "fold_hits", 0))
        hit = self._dev_stable.get(key)
        if hit is None or hit[0] is not enc_st:
            hit = (enc_st, stable_fn(wbuf, bbuf))
            self._dev_stable[key] = hit
            while len(self._dev_stable) > 4 * len(self.frameworks):
                self._dev_stable.pop(next(iter(self._dev_stable)))
        return hit[1]

    # ---- informer-style event handlers -----------------------------------

    def on_pod_add(self, pod: Pod, node_name: str = "") -> None:
        if node_name:
            # observed bound: drop any stale queue entry
            self.queue.delete(pod.uid)
            self.cache.add_pod(pod, node_name)
            self.queue.move_all_to_active_or_backoff(EVENT_POD_ADD)
            if self.flight is not None:
                self.flight.pod_event(
                    pod.uid, pod.name, "BoundObserved", node=node_name
                )
        else:
            self.queue.add(pod)
            if self.flight is not None:
                self.flight.pod_event(pod.uid, pod.name, "Queued")

    def on_pod_update(self, pod: Pod, node_name: str = "") -> None:
        if node_name:
            self.queue.delete(pod.uid)
            self.cache.add_pod(pod, node_name)
            self.queue.move_all_to_active_or_backoff(EVENT_POD_UPDATE)
            if self.flight is not None:
                self.flight.pod_event(
                    pod.uid, pod.name, "BoundObserved", node=node_name
                )
        else:
            self.queue.update(pod)
            if self.flight is not None:
                self.flight.pod_event(pod.uid, pod.name, "Updated")

    def on_pod_delete(self, pod_uid: str) -> None:
        self.cache.remove_pod(pod_uid)
        self.queue.delete(pod_uid)
        if self.admission is not None:
            # a pod deleted before binding leaves the front door's
            # accepted-pending set, or its uid stays "already pending"
            self.admission.note_delete(pod_uid)
        self.queue.move_all_to_active_or_backoff(EVENT_POD_DELETE)
        if self.flight is not None:
            self.flight.pod_event(pod_uid, "", "Deleted")

    def on_node_add(self, node: Node) -> None:
        self.cache.add_node(node)
        self.queue.move_all_to_active_or_backoff(EVENT_NODE_ADD)

    def on_node_update(self, node: Node) -> None:
        self.cache.update_node(node)
        self.queue.move_all_to_active_or_backoff(EVENT_NODE_UPDATE)

    def on_node_delete(self, node_name: str) -> None:
        self.cache.remove_node(node_name)
        self.queue.move_all_to_active_or_backoff(EVENT_NODE_DELETE)

    def add_pod_group(self, group: PodGroup) -> None:
        self._groups[group.name] = group

    # ---- volume objects (VolumeBinding inputs) ---------------------------

    def on_pvc_upsert(self, pvc) -> None:
        self._pvcs[pvc.key] = pvc
        self.queue.move_all_to_active_or_backoff(EVENT_PVC_CHANGE)

    def on_pvc_delete(self, key: str) -> None:
        self._pvcs.pop(key, None)
        self.queue.move_all_to_active_or_backoff(EVENT_PVC_CHANGE)

    def on_pv_upsert(self, pv) -> None:
        self._pvs[pv.name] = pv
        self.queue.move_all_to_active_or_backoff(EVENT_PV_CHANGE)

    def on_pv_delete(self, name: str) -> None:
        self._pvs.pop(name, None)
        self.queue.move_all_to_active_or_backoff(EVENT_PV_CHANGE)

    def on_storage_class_upsert(self, sc) -> None:
        self._storage_classes[sc.name] = sc
        self.queue.move_all_to_active_or_backoff(EVENT_STORAGE_CLASS_CHANGE)

    def on_storage_class_delete(self, name: str) -> None:
        self._storage_classes.pop(name, None)
        self.queue.move_all_to_active_or_backoff(EVENT_STORAGE_CLASS_CHANGE)

    def on_pdb_upsert(self, pdb) -> None:
        self._pdbs[pdb.key] = pdb

    def on_pdb_delete(self, key: str) -> None:
        self._pdbs.pop(key, None)

    # ---- the cycle -------------------------------------------------------

    def schedule_cycle(self) -> CycleStats:
        """One batched scheduling cycle over everything ready to run.
        Pods route to their profile's framework by
        `pod.spec.scheduler_name`; profiles run in declaration order
        within the cycle, each seeing the previous profiles' assumptions."""
        self._cycle_counter += 1
        self._cycle_fault = False
        t0 = self._now()
        if _faults.ARMED:
            # the ambient cycle index of the fault rules' windows, and the
            # clock_skew injection point
            _faults.set_cycle(self._cycle_counter)
            t0 += _faults.skew_s()
        stats = CycleStats()
        self.last_nominations = []
        self.last_evictions = []
        for pod, node in self.cache.cleanup_expired():
            self.queue.requeue_backoff(pod, event="AssumeExpired")
            self.events.assume_expired(pod, node)
            if self.flight is not None:
                self.flight.pod_event(pod.uid, pod.name, "Expired", node=node)
        self.queue.flush_unschedulable_timeout()

        # multi-cycle batching is gated on the degradation ladder: at or
        # below the `sequential` rung every cycle dispatches alone
        mc_on = self._mc_k > 1 and self.ladder.rung < RUNG_SEQUENTIAL
        if self._mc_k > 1 and not mc_on:
            # drain buffered groups as single-cycle dispatches BEFORE this
            # cycle's non-hold pop replaces the in-flight set
            for name in self._profile_order:
                buf = self._mc_groups[name]
                if not buf:
                    continue
                self._mc_groups[name] = []
                for _t_enq, g in buf:
                    stats.attempted += len(g)
                    self._schedule_profile(name, g, stats, t0)
                self.queue.retire_in_flight([p.uid for _t_enq, g in buf for p in g])
        mc_buffered = mc_on and any(self._mc_groups[n] for n in self._profile_order)
        # hold-pop while groups are buffered: their in-flight entries must
        # survive until the flush applies their outcomes
        pending_all = self.queue.pop_ready(hold=mc_buffered)
        if not pending_all and not mc_buffered and stats.attempted == 0:
            # gauges track deletions / moves between non-empty cycles too
            self._update_gauges()
            if self.state is not None:
                self.state.maybe_snapshot()
            return stats
        if pending_all:
            stats.attempted += len(pending_all)
            self.metrics.cycle_pods.observe(len(pending_all))

        by_prof: dict[str, list[Pod]] = {n: [] for n in self._profile_order}
        for pod in pending_all:
            name = pod.spec.scheduler_name or self._profile_order[0]
            lst = by_prof.get(name)
            if lst is None:
                # a pod naming a scheduler this process does not serve is
                # parked loudly, never scheduled under another profile
                self.events.failed_scheduling(
                    pod, f"no profile named {name!r} in this scheduler",
                )
                self.queue.requeue_unschedulable(
                    pod, reasons=("UnknownSchedulerName",)
                )
                stats.unschedulable += 1
                self.metrics.observe_attempt(
                    "unschedulable", self._now() - t0, name
                )
                continue
            lst.append(pod)

        for name in self._profile_order:
            group = by_prof[name]
            if mc_on and name not in self._mc_off:
                self._coalesce(name, group, stats, t0)
            elif group:
                self._schedule_profile(name, group, stats, t0)
                if self._mc_k > 1:
                    # other profiles' buffers may keep every pop holding:
                    # this profile's outcomes are applied, retire them
                    self.queue.retire_in_flight([p.uid for p in group])

        stats.cycle_seconds = self._now() - t0
        self.metrics.cycle_duration.labels(phase="total").observe(
            stats.cycle_seconds
        )
        if stats.attempted > 0 and not self._cycle_fault:
            self.ladder.note_clean_cycle(seq=self._cycle_counter)
        self._update_gauges()
        if self.state is not None:
            # interval-gated journal compaction, after cycle_seconds is
            # stamped: snapshots ride between cycles, never inside the
            # bind path
            self.state.maybe_snapshot()
        return stats

    def _encode_packed_host(self, encoder, nodes, pending, existing, kw):
        """The packed path's frame: a full encode (the reference's
        `encoder.encode` + `packing.make_spec` + `packing.pack`) into host
        buffers, for the pipeline to upload, and the extenders' per-pod
        errors. With extenders, every pending pod's verdicts (the prepass)
        ride in the frame as the snapshot's planes, mask True and score 0
        on the pads."""
        from ..framework.host import run_extender_prepass
        from ..models import packing

        fields, aux = encoder.encode_numpy(nodes, pending, existing, **kw)
        errors: dict[int, str] = {}
        if self.extenders:
            emask, escore, errors = run_extender_prepass(self.extenders, pending, nodes)
            if emask is not None:
                P, N = fields["pod_valid"].shape[0], fields["node_valid"].shape[0]
                full_mask = np.ones((P, N), bool)
                full_score = np.zeros((P, N), np.float32)
                full_mask[: len(pending), : len(nodes)] = emask
                full_score[: len(pending), : len(nodes)] = escore
                fields = dict(fields, pod_extender_mask=full_mask,
                              pod_extender_score=full_score)
                aux = dict(aux, has_extender=True)
        aux = dict(aux, pref_raw_bound=pref_raw_bound(
            fields["pod_pref_aff"], fields["pod_pref_aff_w"], fields["pod_tsc"],
            fields["exist_pref_aff"], fields["exist_pref_aff_w"]))
        spec = packing.spec_of_fields(fields, aux)
        wbuf, bbuf = packing.pack(fields, spec)
        return wbuf, bbuf, spec, errors

    def _schedule_profile(
        self, profile: str, pending: list[Pod], stats: CycleStats,
        t0: float,
    ) -> None:
        framework = self.frameworks[profile]
        encoder = self._encoders[profile]
        fr = self.flight
        rec = fr.start(profile) if fr is not None else None
        builds_before = self._packed_builds
        if rec is not None:
            rec.mark("encode_start", rec.t_start)
            # per-profile deltas: CycleStats accumulates across profiles
            _before = (
                stats.scheduled, stats.unschedulable, stats.bind_errors,
                stats.preemptors, stats.victims,
            )
        nodes = self.cache.nodes()
        existing = self.cache.existing_pods()
        # bucketed pod / node pads keep one program regime across cycles;
        # hysteresis_pad damps the down-steps (padHysteresisPct)
        encoder.pad_pods = encoder.hysteresis_pad(
            "P", _pad(len(pending), self._pad_bucket), len(pending)
        )
        encoder.pad_nodes = encoder.hysteresis_pad(
            "N", _pad(len(nodes), self._pad_bucket), len(nodes)
        )
        kw = dict(
            pod_groups=list(self._groups.values()),
            pvcs=list(self._pvcs.values()),
            pvs=list(self._pvs.values()),
            storage_classes=list(self._storage_classes.values()),
            pdbs=list(self._pdbs.values()),
        )
        extender_errors: dict[int, str] = {}
        t_start = self._now()
        if self._use_carry:
            mut = self._nominated_mut[profile]
            full_before = encoder.full_encodes
            # encode, pack and the one host->device upload of the frame
            wbuf, bbuf, spec, _snap, dirty = encoder.encode_packed(
                nodes, pending, existing, mutated_ids=frozenset(mut), **kw
            )
            mut.clear()
            # the extenders' changed slots: the pods whose content changed
            # (not the NodePorts repair slots of `dirty`); everything after a
            # full encode, whose rows the reference does not compare
            ext_dirty = (None if encoder.full_encodes != full_before
                         else encoder.last_changed_slots)
        else:
            wbuf, bbuf, spec, extender_errors = self._encode_packed_host(
                encoder, nodes, pending, existing, kw)
            dirty = None
        (
            pcycle, ppreempt, stable_fn, keeper, diag, ext_keeper, pipe,
        ) = self._packed_fns(spec, profile)
        try:
            if not self._use_carry:
                # the frame's upload, through the pipeline's next slot
                wbuf, bbuf = pipe.upload(wbuf, bbuf)
            stable = self._stable_state(spec, stable_fn, wbuf, bbuf, encoder)
        except Exception as e:
            # a device failure before any bind: step the ladder and
            # requeue — no winner exists yet
            self._cycle_failed(profile, pending, e, stats, t0, rec)
            return
        t_encode = self._now()
        self.metrics.cycle_duration.labels(phase="encode").observe(
            t_encode - t_start
        )
        enc_st = getattr(encoder, "_stable", None)
        pipe.forced_sync = (
            self.forced_sync or self.ladder.rung >= RUNG_FORCED_SYNC
        )
        pipe.dispatch_deadline_s = self._dispatch_deadline_s
        pipe.note_encode(t_encode - t_start)
        try:
            if self._use_carry:
                ext_mask = ext_score = None
                if ext_keeper is not None:
                    # the carried verdicts: the webhooks consulted for the
                    # changed slots and the errored ones; rows stay on the
                    # device
                    ext_mask, ext_score = ext_keeper.state(
                        self.extenders, pending, nodes, ext_dirty,
                        (spec.layout_key(), getattr(encoder, "_carry_key", None)),
                    )
                    extender_errors = {
                        i: m for i, m in ext_keeper.errors.items() if i < len(pending)
                    }
                handle = pipe.dispatch(
                    wbuf, bbuf, stable,
                    dirty=dirty,
                    carry_key=(
                        spec.layout_key(), id(enc_st),
                        getattr(encoder, "_carry_key", None),
                    ),
                    emask=ext_mask, escore=ext_score,
                    device_put=False,  # encode_packed uploaded the frame
                )
            else:
                handle = pipe.dispatch(wbuf, bbuf, stable, device_put=False)
        except Exception as e:
            self._cycle_failed(profile, pending, e, stats, t0, rec)
            return
        # the one blocking wait of the decision path: the slim payload. A
        # failure here (deadline expiry, device error) consumes the cycle
        # and walks the degradation ladder; every pod requeues with backoff
        try:
            assignment, _unsched, gang_dropped = handle.decisions()
        except Exception as e:
            self._cycle_failed(profile, pending, e, stats, t0, rec)
            return
        assignment = assignment[: len(pending)]
        gang_dropped = gang_dropped[: len(pending)]
        profile_gang_dropped = int(gang_dropped.sum())
        stats.gang_dropped += profile_gang_dropped
        t_device = self._now()
        self.metrics.cycle_duration.labels(phase="device").observe(
            t_device - t_encode
        )
        self.metrics.decisions.inc(len(pending) * len(nodes))

        losers = bool((assignment < 0).any())
        _rej_box: list = []

        def reject_counts_fn():
            # one force of the whole [P, F] attribution matrix
            if not _rej_box:
                _rej_box.append(handle.reject_counts_matrix(len(pending)))
            return _rej_box[0]

        def force_pre():
            # after the winners' binds: enqueue the deferred programs on
            # the cycle's stream (the diagnosis first, as the reference
            # dispatches it), then force the preemption output
            if not losers:
                return None, None
            if diag is not None:
                handle.dispatch_diagnosis()
            if ppreempt is None:
                return None, None
            self.metrics.preemption_attempts.inc()
            pre = handle.dispatch_preemption()
            return (
                pre.nominated.cpu().numpy()[: len(pending)],
                pre.victims.cpu().numpy()[: len(existing)],
            )

        self._apply_phase(
            profile, framework, pending, nodes, existing, assignment,
            gang_dropped, extender_errors, reject_counts_fn, force_pre,
            stats, t0, rec, t_device,
        )

        # ---- flight record: assemble + commit (one list store) ----
        if rec is not None:
            st = pipe.stage_report()
            extra_phases: dict = {}
            extra_counts: dict = {}
            compile_source = ""
            fold_ms = encoder.delta_profile.get("fold")
            if fold_ms:
                extra_phases["fold_ms"] = float(fold_ms)
            if self.config.incremental_encode:
                # a lone buffered group flushed through this path with
                # staged rows: its encode was the finalize
                ing_s = self._ingest_s.pop(profile, 0.0)
                if ing_s > 0.0:
                    fin_s = max(t_encode - t_start, 0.0)
                    extra_phases["encode_ingest_ms"] = ing_s * 1e3
                    extra_phases["encode_finalize_ms"] = fin_s * 1e3
                    self.metrics.encode_finalize.observe(fin_s)
            if self._packed_builds > builds_before:
                extra_phases["compile_ms"] = self._last_build_s * 1e3
                extra_counts["regime_flip"] = 1
                compile_source = self._last_compile_source
            if profile in self._mc_stale_arena:
                # the first single-cycle dispatch after a batch: a full
                # re-encode here is the batch's doing, not a fold miss
                self._mc_stale_arena.discard(profile)
                extra_counts["post_batch"] = 1
            self._commit_record(
                rec, st, spec, encoder, pending, nodes, stats,
                _before, profile_gang_dropped,
                fetch_bytes=int(st.get("fetch_bytes", 0)),
                extra_phases=extra_phases, extra_counts=extra_counts,
                compile_source=compile_source,
            )
            if "diag_lag_ms" in st:
                self.metrics.diag_lag.observe(st["diag_lag_ms"] / 1e3)
        self._maybe_speculate(profile, spec)

    # ---- multi-cycle serving (reference core/scheduler.py:1576-2559) -----

    def _coalesce(self, name: str, group: "list[Pod]", stats: CycleStats,
                  t0: float) -> None:
        """Buffer this pop's arrival group for profile `name` and flush the
        buffer as one multi-cycle dispatch when it holds K groups, the
        arrival stream paused (an empty pop) or the oldest group aged past
        `multiCycleMaxWaitMs`."""
        buf = self._mc_groups[name]
        if group:
            buf.append((t0, group))
            if self.config.incremental_encode:
                # admission-time incremental encode: stage each buffered
                # pod's row now, in the buffering pop's shadow
                self._ingest_group(name, group)
        if not buf:
            return
        if not (len(buf) >= self._mc_k or not group or (t0 - buf[0][0]) >= self._mc_wait_s):
            # buffered, not dispatched: attempted at the flush
            stats.attempted -= len(group)
            return
        self._mc_groups[name] = []
        if _spans.ARMED:
            # mc.buffer_wait: group enqueue -> this flush, one span per
            # sampled pod, ending at the recorder clock
            t_flush = _spans.now()
            for t_enq, g in buf:
                wait_s = max(t0 - t_enq, 0.0)
                for p in g:
                    c = _spans.ctx_for(p.uid)
                    if c is not None:
                        _spans.record_span("mc.buffer_wait", c, t_flush - wait_s, t_flush,
                                           uid=p.uid, groups=len(buf))
        # a pod is attempted in the cycle whose dispatch carries it
        stats.attempted += sum(len(g) for _t, g in buf) - len(group)
        if len(buf) == 1:
            # a lone group gains nothing from the stacked path
            self._schedule_profile(name, buf[0][1], stats, t0)
        else:
            self._schedule_profile_multi(name, buf, stats, t0)
        # outcomes applied: hold pops only accumulate, so retire explicitly
        self.queue.retire_in_flight([p.uid for _t_enq, g in buf for p in g])
        if self.config.incremental_encode:
            # staged rows the flush did not consume must not outlive it
            self._encoders[name].clear_ingest()
            self._ingest_s.pop(name, None)

    def _mc_programs(self, spec, profile: str):
        """The memoized multi-cycle programs of one packed regime:
        (multicycle, diagnosis, continuation or None), counted into
        `_packed_builds` like every program build (true LRU)."""
        key = (spec.key(), profile)
        with self._packed_lock:
            entry = self._mc_fns.get(key)
            if entry is not None:
                self._mc_fns.pop(key)
                self._mc_fns[key] = entry  # move-to-end on hit
                return entry["fns"]
        entry = self._build_mc_entry(spec, profile)
        with self._packed_lock:
            cur = self._mc_fns.setdefault(key, entry)
            self._mc_fns.pop(key)
            self._mc_fns[key] = cur
            self._packed_builds += 1
            self._last_build_s = entry["build_s"]
            self._last_compile_source = entry["source"]
            while len(self._mc_fns) > 4 * len(self.frameworks):
                self._mc_fns.pop(next(iter(self._mc_fns)))
        return cur["fns"]

    def _build_mc_entry(self, spec, profile: str) -> dict:
        """One regime's multi-cycle programs: the batch loop, the per-row
        diagnosis (the batch's decisions are lean, so every regime needs
        one, scan regimes too) and, under speculativeDispatch, the carry-in
        continuation."""
        from .cycle import build_diagnosis_fn, build_packed_multicycle_fn

        t_build = _time.perf_counter()
        fw = self.frameworks[profile]
        mfn = build_packed_multicycle_fn(spec, framework=fw, k=self._mc_k, device=self.device,
                                         **self._cycle_kw)
        mdiag = _Resilient(build_diagnosis_fn(spec, fw, device=self.device), "diagnosis")
        mcont = None
        if self.config.speculative_dispatch:
            mcont = build_packed_multicycle_fn(spec, framework=fw, k=self._mc_k, carry_in=True,
                                               device=self.device, **self._cycle_kw)
        return {"fns": (mfn, mdiag, mcont), "build_s": _time.perf_counter() - t_build,
                "source": "cold"}

    def _ingest_group(self, profile: str, group: "list[Pod]") -> None:
        """Stage each newly buffered pod's arena row (incrementalEncode,
        `SnapshotEncoder.ingest_pod`), so the flush's delta encode skips
        the parse; the staging seconds accumulate for the flush record's
        encode_ingest_ms."""
        enc = self._encoders[profile]
        t_ing = self._now()
        for p in group:
            enc.ingest_pod(p)
        ing_s = max(self._now() - t_ing, 0.0)
        self._ingest_s[profile] = self._ingest_s.get(profile, 0.0) + ing_s
        self.metrics.encode_ingest.observe(ing_s)
        if _spans.ARMED:
            t1 = _spans.now()
            for p in group:
                c = _spans.ctx_for(p.uid)
                if c is not None:
                    _spans.record_span("encode.ingest", c, t1 - ing_s, t1, uid=p.uid,
                                       pods=len(group))

    def _host_frame(self, encoder, nodes, pending, existing, kw):
        """One group's full host encode: (fields, aux, spec) — the
        reference's plain `encode` + `packing.make_spec`."""
        from ..models import packing

        fields, aux = encoder.encode_numpy(nodes, pending, existing, **kw)
        aux = dict(aux, pref_raw_bound=pref_raw_bound(
            fields["pod_pref_aff"], fields["pod_pref_aff_w"], fields["pod_tsc"],
            fields["exist_pref_aff"], fields["exist_pref_aff_w"]))
        return fields, aux, packing.spec_of_fields(fields, aux)

    def _stack(self, rows, spec):
        """Stack packed rows into the [K, W] / [K, B] multi-cycle feed,
        zero past the real rows (host arrays; the pipeline uploads), and
        the rows' valid-pod counts (the loop's drain exit)."""
        wbufs = np.zeros((self._mc_k, spec.n_words), np.uint32)
        bbufs = np.zeros((self._mc_k, spec.n_bytes), np.uint8)
        for i, (wr, br) in enumerate(rows):
            wbufs[i], bbufs[i] = wr, br
        pv = [off for name, _shape, off in spec.bools if name == "pod_valid"][0]
        P = [int(shape[0]) for name, shape, _off in spec.bools if name == "pod_valid"][0]
        counts = [int((bbufs[i, pv:pv + P] != 0).sum()) for i in range(len(rows))]
        return wbufs, bbufs, counts

    def _pack_rows(self, frames, spec):
        from ..models import packing

        return [packing.pack(fields, spec) for fields, _aux in frames]

    def _encode_groups_host(self, profile, encoder, groups, nodes, existing, kw):
        """The flush's groups through full host encodes, all against the
        pre-batch cache. A later group that grew an interning table (past
        row 0's regime, or within its padding: row 0's stable tables lack
        the entries) re-encodes the batch once with the sampling rotation
        rewound. Returns (frames, spec, None) or (None, None, reason)."""
        from .cycle import multicycle_unsupported_reason

        def one_pass():
            frames, specs, lens0 = [], [], None
            for _t_enq, g in groups:
                fields, aux, sp = self._host_frame(encoder, nodes, g, existing, kw)
                if lens0 is None:
                    # row 0's tables are the batch's stable side
                    lens0 = encoder._table_lens()
                reason = multicycle_unsupported_reason((fields, aux))
                if reason is not None:
                    return None, None, reason, lens0
                frames.append((fields, aux))
                specs.append(sp)
            return frames, specs, None, lens0

        ci0 = encoder._cycle_index
        frames, specs, reason, lens0 = one_pass()
        if frames is None:
            # the fall-back's dispatches re-stamp the same sampling rotation
            encoder._cycle_index = ci0
            return None, None, reason
        if encoder._table_lens() != lens0 or any(sp.key() != specs[0].key() for sp in specs[1:]):
            encoder._cycle_index = ci0
            frames, specs, reason, lens0 = one_pass()
            if frames is None:
                encoder._cycle_index = ci0
                return None, None, reason
            if any(sp.key() != specs[0].key() for sp in specs[1:]):
                # cannot happen with grow-only tables; refuse to guess
                return None, None, None
        return frames, specs[0], None

    def _encode_groups_packed(self, profile, encoder, groups, nodes, existing, kw):
        """The flush's groups through the packed delta arena
        (incrementalEncode): each group folds via `encode_packed` (staged
        rows make it an O(dirty) apply) and its host row is copied out
        before the next encode rewrites the arena. Returns (rows, spec,
        None) or (None, None, reason | None)."""
        from .cycle import multicycle_unsupported_reason

        mut = frozenset(self._nominated_mut[profile])

        def one_pass():
            rows, specs, lens0 = [], [], None
            for _t_enq, g in groups:
                f = encoder.encode_packed(nodes, g, existing, mutated_ids=mut, **kw)
                if lens0 is None:
                    lens0 = encoder._table_lens()
                reason = multicycle_unsupported_reason(f.snap)
                if reason is not None:
                    return None, None, reason, lens0
                hw, hb = encoder.host_buffers()
                rows.append((hw.copy(), hb.copy()))
                specs.append(f.spec)
            return rows, specs, None, lens0

        ci0 = encoder._cycle_index
        rows, specs, reason, lens0 = one_pass()
        if rows is None:
            encoder._cycle_index = ci0
            return None, None, reason
        if encoder._table_lens() != lens0 or any(sp.key() != specs[0].key() for sp in specs[1:]):
            encoder._cycle_index = ci0
            rows, specs, reason, lens0 = one_pass()
            if rows is None:
                encoder._cycle_index = ci0
                return None, None, reason
            if (encoder._table_lens() != lens0
                    or any(sp.key() != specs[0].key() for sp in specs[1:])):
                return None, None, None
        self._nominated_mut[profile].clear()
        return rows, specs[0], None

    def _stamp_finalize(self, profile: str, fin_s: float, pods=()) -> None:
        """Observe the flush's finalize window and park the ingest /
        finalize stamps for the batch's inner record 0."""
        fin_s = max(fin_s, 0.0)
        ing_s = self._ingest_s.pop(profile, 0.0)
        self.metrics.encode_finalize.observe(fin_s)
        self._flush_phases[profile] = {"encode_finalize_ms": fin_s * 1e3,
                                       "encode_ingest_ms": ing_s * 1e3}
        if _spans.ARMED and pods:
            t1 = _spans.now()
            for p in pods:
                c = _spans.ctx_for(p.uid)
                if c is not None:
                    _spans.record_span("flush.finalize", c, t1 - fin_s, t1, uid=p.uid)

    def _mc_fall_back(self, profile: str, groups, stats: CycleStats, t0: float,
                      reason: "str | None") -> None:
        """Dispatch `groups` as sequential single-cycle dispatches: the
        batch left the exactness envelope. Sticky capability reasons pin
        the profile out of batching for the process; host ports is a
        per-batch reason (a later port-free batch is exact again)."""
        log = logging.getLogger(__name__)
        if reason == "host_ports":
            log.info("multi-cycle batch for profile %r fell back to sequential "
                     "dispatches: pending set carries host ports", profile)
        elif reason is not None and profile not in self._mc_off:
            self._mc_off[profile] = reason
            log.warning("multi-cycle serving disabled for profile %r: workload left "
                        "the exactness envelope (%s)", profile, reason)
        for _t_enq, g in groups:
            self._schedule_profile(profile, g, stats, t0)

    def _mc_setup(self, profile, spec):
        """The regime's packed programs with the batch programs installed
        on its pipeline: (preempt, stable_fn, pipe)."""
        (_pc, ppreempt, stable_fn, _keeper, _diag, _ek, pipe) = self._packed_fns(spec, profile)
        pipe.multi_fn, pipe.multi_diag_fn, pipe.multi_cont_fn = self._mc_programs(spec, profile)
        return ppreempt, stable_fn, pipe

    def _schedule_profile_multi(self, profile: str, groups, stats: CycleStats,
                                t0: float) -> None:
        """Dispatch the buffered arrival groups as one multi-cycle batch:
        group i becomes inner cycle i. Under `speculativeDispatch` the flush
        splits depth-2 (`_schedule_profile_multi_spec`); either way the
        decision rows stream back per inner cycle (`_apply_mc_rows`) and
        each is applied through `_apply_phase` in batch order."""
        fr = self.flight
        nodes = self.cache.nodes()
        existing = self.cache.existing_pods()
        kw = dict(
            pod_groups=list(self._groups.values()),
            pvcs=list(self._pvcs.values()),
            pvs=list(self._pvs.values()),
            storage_classes=list(self._storage_classes.values()),
            pdbs=list(self._pdbs.values()),
        )
        # one spec for every row: pad to the largest group
        mc_pods = max(len(g) for _, g in groups)
        encoder = self._encoders[profile]
        encoder.pad_pods = encoder.hysteresis_pad("P", _pad(mc_pods, self._pad_bucket), mc_pods)
        encoder.pad_nodes = encoder.hysteresis_pad("N", _pad(len(nodes), self._pad_bucket),
                                                   len(nodes))
        builds_before = self._packed_builds
        t_batch = self._now()
        t_batch_rec = fr.now() if fr is not None else 0.0
        inc = self.config.incremental_encode
        if not inc:
            # the host encodes bypass the delta arena
            self._mc_stale_arena.add(profile)
        if (self.config.speculative_dispatch and len(groups) >= 2 and not self.forced_sync
                and self.ladder.rung < RUNG_SEQUENTIAL
                and (self.observer is None or self.observer.speculation_ok(profile))):
            self._schedule_profile_multi_spec(profile, groups, stats, t0, t_batch,
                                              t_batch_rec, builds_before, nodes, existing, kw)
            return
        if inc:
            rows, spec, reason = self._encode_groups_packed(profile, encoder, groups, nodes,
                                                            existing, kw)
        else:
            frames, spec, reason = self._encode_groups_host(profile, encoder, groups, nodes,
                                                            existing, kw)
            rows = None if frames is None else self._pack_rows(frames, spec)
        if rows is None:
            self._mc_fall_back(profile, groups, stats, t0, reason)
            return
        ppreempt, stable_fn, pipe = self._mc_setup(profile, spec)
        n = len(groups)
        wbufs, bbufs, counts = self._stack(rows, spec)
        batch_pods = [p for _t_enq, g in groups for p in g]
        try:
            wbufs, bbufs = pipe.upload(wbufs, bbufs)
            stable = self._stable_state(spec, stable_fn, wbufs[0], bbufs[0], encoder)
        except Exception as e:
            self._cycle_failed(profile, batch_pods, e, stats, t0, None)
            return
        t_encode = self._now()
        self.metrics.cycle_duration.labels(phase="encode").observe(t_encode - t_batch)
        if inc:
            self._stamp_finalize(profile, t_encode - t_batch, pods=batch_pods)
        pipe.forced_sync = self.forced_sync or self.ladder.rung >= RUNG_FORCED_SYNC
        pipe.dispatch_deadline_s = self._dispatch_deadline_s
        pipe.note_encode(t_encode - t_batch)
        # a failed batch dispatch consumes the whole batch before any bind
        try:
            handle = pipe.dispatch_multi(wbufs, bbufs, stable, n, device_put=False,
                                         counts=counts)
        except Exception as e:
            self._cycle_failed(profile, batch_pods, e, stats, t0, None)
            return
        self.metrics.multicycle_batch.observe(n)
        applied, exc = self._apply_mc_rows(
            profile, handle, groups, spec, encoder, stats, t0, t_batch, t_batch_rec, nodes,
            existing, ppreempt, builds_before, batch_n=n, stamp_first_bind=True,
            stamp_compile=True)
        self.metrics.multicycle_cycles.inc(applied)
        if exc is not None:
            # groups already applied stay bound; the unapplied tail requeues
            rest = [p for _t_enq, g in groups[applied:] for p in g]
            self._cycle_failed(profile, rest, exc, stats, t0, None)
            return
        self._maybe_speculate(profile, spec)

    @staticmethod
    def _fold_digest(scheduled: int, unschedulable: int, bind_errors: int,
                     victims: int) -> tuple:
        """Digest of one host fold's observable cache effects: the
        speculation's predicate (every winner binds, nothing else changes)
        against what the apply loop did. Named counts, so an abandon can
        log which one diverged."""
        return (("scheduled", scheduled), ("unschedulable", unschedulable),
                ("bind_errors", bind_errors), ("victims", victims))

    def _apply_mc_rows(self, profile, handle, group_slice, spec, encoder, stats, t0, t_batch,
                       t_batch_rec, nodes, existing, ppreempt, builds_before, batch_n: int,
                       stamp_first_bind: bool = False, stamp_compile: bool = False,
                       resolve_after_first=None):
        """Streamed apply of one dispatched batch: fetch decision row i,
        apply group i through `_apply_phase`, commit its flight record.
        `resolve_after_first(a_row, before)`, the speculation predicate,
        runs after group 0's apply and returns its record's tag. Returns
        (applied, exc): `exc` is the fetch failure that stopped the walk.
        Rows the loop never ran (a scheduler bug) requeue loudly with
        `MultiCycleUnran`."""
        fr = self.flight
        log = logging.getLogger(__name__)
        pipe = handle._pipe
        st: dict = {}
        device_win_s = 0.0
        total_attempted = sum(len(g) for _t, g in group_slice) or 1
        applied = 0
        exc = None
        for gi, (t_enq, pending) in enumerate(group_slice):
            try:
                a_full, _u_full, gd_full, att_full = handle.decisions_row(gi)
            except Exception as e:  # schedlint: disable=RB001 -- not swallowed: decisions_row attributed it and the caller routes it through _cycle_failed
                exc = e
                break
            if gi == 0:
                st = pipe.stage_report()
                device_win_s = max(st.get("t_decision_end", 0.0)
                                   - st.get("t_dispatch_end", 0.0), 0.0)
                self.metrics.cycle_duration.labels(phase="device").observe(device_win_s)
            if pending and not att_full[: len(pending)].any():
                break
            rec = fr.start(profile) if fr is not None else None
            before = (stats.scheduled, stats.unschedulable, stats.bind_errors,
                      stats.preemptors, stats.victims)
            if rec is not None:
                # the record's window opens at the batch flush
                rec.t_start = t_batch_rec
                rec.mark("encode_start", t_batch_rec)
            try:
                self._apply_mc_row(profile, handle, gi, pending, a_full, gd_full, spec, encoder,
                                   stats, t0, t_batch, nodes, existing, ppreempt, builds_before,
                                   batch_n, stamp_first_bind, stamp_compile, resolve_after_first,
                                   rec, st, device_win_s, total_attempted, t_enq, before)
            except Exception:  # schedlint: disable=RB001 -- not swallowed: releases the ordering guard, then re-raises to schedule_cycle
                handle.fetched = True
                handle.release()
                pipe._note_inflight()
                raise
            applied += 1
        if exc is None and applied < len(group_slice):
            log.error("multi-cycle dispatch ran %d of %d inner cycles; requeueing the "
                      "unran groups", applied, len(group_slice))
            handle.fetched = True
            handle.release()
            pipe._note_inflight()
            for _t_enq, g in group_slice[applied:]:
                for pod in g:
                    self.queue.requeue_backoff(pod, event="MultiCycleUnran")
                    stats.bind_errors += 1
        return applied, exc

    def _apply_mc_row(self, profile, handle, gi, pending, a_full, gd_full, spec, encoder, stats,
                      t0, t_batch, nodes, existing, ppreempt, builds_before, batch_n,
                      stamp_first_bind, stamp_compile, resolve_after_first, rec, st,
                      device_win_s, total_attempted, t_enq, before) -> None:
        """One inner cycle's apply and record commit."""
        framework = self.frameworks[profile]
        a_i = a_full[: len(pending)]
        gd_i = gd_full[: len(pending)]
        profile_gang_dropped = int(gd_i.sum())
        stats.gang_dropped += profile_gang_dropped
        self.metrics.decisions.inc(len(pending) * len(nodes))
        losers = bool((a_i < 0).any())
        if losers:
            handle.dispatch_diagnosis(gi)
        _rej_box: list = []

        def reject_counts_fn():
            # one force of inner cycle gi's [P, F] attribution matrix
            if not _rej_box:
                _rej_box.append(handle.reject_counts_matrix(gi, len(pending)))
            return _rej_box[0]

        pre_handle = None
        if ppreempt is not None and losers:
            self.metrics.preemption_attempts.inc()
            pre_handle = handle.dispatch_preemption(gi)

        def force_pre():
            if pre_handle is None:
                return None, None
            return (pre_handle.nominated.cpu().numpy()[: len(pending)],
                    pre_handle.victims.cpu().numpy()[: len(existing)])

        self._apply_phase(profile, framework, pending, nodes, existing, a_i, gd_i, {},
                          reject_counts_fn, force_pre, stats, t0, rec, self._now())
        speculation = ""
        if gi == 0 and resolve_after_first is not None:
            # group 0's fold landed: adopt or abandon the continuation
            speculation = resolve_after_first(a_i, before)
        if rec is None:
            return
        # batched decomposition: the group's wait for the batch, and its
        # share of the batch's device window by attempted pods
        extra_phases: dict = {
            "batch_wait_ms": max(t_batch - t_enq, 0.0) * 1e3,
            "device_share_ms": device_win_s * len(pending) / total_attempted * 1e3,
        }
        extra_marks: dict = {}
        extra_counts: dict = {"multi_cycle_k": batch_n}
        if gi == 0:
            extra_phases.update(self._flush_phases.pop(profile, {}))
        if gi == 0 and stamp_first_bind and "t_first_decision" in st and rec.t_start:
            extra_phases["first_bind_ms"] = max(st["t_first_decision"] - rec.t_start, 0.0) * 1e3
        dl = handle.diag_lag.get(gi)
        if dl is not None:
            lag_s, t_done = dl
            extra_phases["diag_lag_ms"] = lag_s * 1e3
            extra_marks["diag_done"] = t_done
            self.metrics.diag_lag.observe(lag_s)
        compile_source = ""
        if gi == 0 and stamp_compile and self._packed_builds > builds_before:
            extra_phases["compile_ms"] = self._last_build_s * 1e3
            extra_counts["regime_flip"] = 1
            compile_source = self._last_compile_source
        # batch-wide marks land on inner record 0 only (the dispatch's)
        st_i = st if gi == 0 else {"slot": st.get("slot", -1)}
        row_window = None
        if _spans.ARMED:
            row_window = {ri: (r0, r1) for ri, r0, r1 in st.get("decision_rows", ())}.get(gi)
        self._commit_record(
            rec, st_i, spec, encoder, pending, nodes, stats, before, profile_gang_dropped,
            fetch_bytes=int(st.get("fetch_bytes", 0)) if gi == 0 else 0,
            extra_phases=extra_phases, extra_marks=extra_marks, extra_counts=extra_counts,
            compile_source=compile_source, speculation=speculation, row_window=row_window)

    def _schedule_profile_multi_spec(self, profile, groups, stats, t0, t_batch, t_batch_rec,
                                     builds_before, nodes, existing, kw) -> None:
        """The depth-2 speculative split of one flushed batch: batch A =
        row 0 alone, batch B = the remaining rows, encoded in A's shadow
        and dispatched speculatively, chained on A's device carry. After
        A's row-0 fold the predicate digest (`_fold_digest`: every winner
        bound, no bind error, no eviction) adopts B — bit-identical to the
        combined [A; B] batch — or abandons it and re-dispatches the rows
        against the true post-fold state."""
        from .cycle import multicycle_unsupported_reason

        log = logging.getLogger(__name__)
        encoder = self._encoders[profile]
        n = len(groups)
        rest_groups = groups[1:]
        batch_pods = [p for _t_enq, g in groups for p in g]
        inc = self.config.incremental_encode
        mut = frozenset(self._nominated_mut[profile]) if inc else None

        def encode_row(g):
            if inc:
                f = encoder.encode_packed(nodes, g, existing, mutated_ids=mut, **kw)
                hw, hb = encoder.host_buffers()
                return (hw.copy(), hb.copy()), f.spec, multicycle_unsupported_reason(f.snap)
            fields, aux, sp = self._host_frame(encoder, nodes, g, existing, kw)
            return (fields, aux), sp, multicycle_unsupported_reason((fields, aux))

        ci_pre = encoder._cycle_index
        row0, spec, reason = encode_row(groups[0][1])
        if reason is not None:
            encoder._cycle_index = ci_pre
            self._mc_fall_back(profile, groups, stats, t0, reason)
            return
        # growth watermark: B's rows may not reference entries A's lack
        lens0 = encoder._table_lens()
        # the sampling rotation after row 0: rows 1..n-1 that are dispatched
        # again (skipped, abandoned, left the envelope) re-stamp the indices
        # of their first encode, as the combined batch and K sequential
        # dispatches stamp them (the reference re-encodes them past it)
        ci_a = encoder._cycle_index
        ppreempt, stable_fn, pipe = self._mc_setup(profile, spec)
        rows_a = [row0] if inc else self._pack_rows([row0], spec)
        wa, ba, counts_a = self._stack(rows_a, spec)
        try:
            wa, ba = pipe.upload(wa, ba)
            stable = self._stable_state(spec, stable_fn, wa[0], ba[0], encoder)
        except Exception as e:
            self._cycle_failed(profile, batch_pods, e, stats, t0, None)
            return
        t_encode = self._now()
        self.metrics.cycle_duration.labels(phase="encode").observe(t_encode - t_batch)
        pipe.forced_sync = False
        pipe.dispatch_deadline_s = self._dispatch_deadline_s
        pipe.note_encode(t_encode - t_batch)
        try:
            handle_a = pipe.dispatch_multi(wa, ba, stable, 1, device_put=False, counts=counts_a)
        except Exception as e:
            self._cycle_failed(profile, batch_pods, e, stats, t0, None)
            return

        # rows 1..n-1 encode in A's dispatch shadow
        t_enc_b0 = self._now()
        rows_b, specs_b = [], []
        bad_reason = None
        for _t_enq, g in rest_groups:
            row, sp, bad_reason = encode_row(g)
            if bad_reason is not None:
                break
            rows_b.append(row)
            specs_b.append(sp)
        if inc:
            if bad_reason is None:
                self._nominated_mut[profile].clear()
            self._stamp_finalize(profile, (t_encode - t_batch) + (self._now() - t_enc_b0),
                                 pods=batch_pods)
        handle_b = None
        if bad_reason is None:
            if encoder._table_lens() != lens0 or any(sp.key() != spec.key() for sp in specs_b):
                log.info("speculative batch for profile %r skipped: rows 1..%d grew the "
                         "interning tables past row 0's", profile, n - 1)
            else:
                packed = rows_b if inc else self._pack_rows(rows_b, spec)
                wb, bb, counts_b = self._stack(packed, spec)
                pipe.note_encode(self._now() - t_enc_b0)
                try:
                    wb, bb = pipe.upload(wb, bb)
                    handle_b = pipe.dispatch_multi(
                        wb, bb, stable, n - 1, device_put=False, counts=counts_b,
                        carry0=(handle_a.result.carry_node_requested,
                                handle_a.result.carry_gplaced),
                        speculative=True)
                except Exception as e:  # schedlint: disable=RB001 -- the speculation failing never fails the batch: B re-dispatches after A's fold
                    log.warning("speculative dispatch failed for profile %r (%s); "
                                "re-dispatching sequentially", profile, e)
                    handle_b = None

        outcome: dict = {}

        def resolve(a_row, before):
            wins = int((a_row >= 0).sum())
            predicted = self._fold_digest(wins, len(a_row) - wins, 0, 0)
            sb, ub, bb_, _pb, vb = before
            actual = self._fold_digest(stats.scheduled - sb, stats.unschedulable - ub,
                                       stats.bind_errors - bb_, stats.victims - vb)
            outcome["predicted"], outcome["actual"] = predicted, actual
            if handle_b is None:
                outcome["tag"] = "none"
            elif actual == predicted:
                pipe.adopt_speculative()
                outcome["tag"] = "adopted"
            else:
                pipe.abandon_speculative()
                outcome["tag"] = "abandoned"
            return outcome["tag"]

        self.metrics.multicycle_batch.observe(n)
        try:
            applied_a, exc_a = self._apply_mc_rows(
                profile, handle_a, groups[:1], spec, encoder, stats, t0, t_batch, t_batch_rec,
                nodes, existing, ppreempt, builds_before, batch_n=n, stamp_first_bind=True,
                stamp_compile=True, resolve_after_first=resolve)
        except BaseException:  # schedlint: disable=RB001 -- a leak guard: the speculation's slot must not outlive the batch; the error re-raises
            pipe.abandon_speculative()
            raise
        if exc_a is not None:
            pipe.abandon_speculative()
            self._cycle_failed(profile, batch_pods, exc_a, stats, t0, None)
            return
        if applied_a == 0:
            pipe.abandon_speculative()
            for _t_enq, g in rest_groups:
                for pod in g:
                    self.queue.requeue_backoff(pod, event="MultiCycleUnran")
                    stats.bind_errors += 1
            return
        tag = outcome.get("tag", "none")
        if tag == "adopted":
            applied_b, exc_b = self._apply_mc_rows(
                profile, handle_b, rest_groups, spec, encoder, stats, t0, t_batch,
                t_batch_rec, nodes, existing, ppreempt, builds_before, batch_n=n)
            self.metrics.multicycle_cycles.inc(applied_a + applied_b)
            if exc_b is not None:
                rest = [p for _t_enq, g in rest_groups[applied_b:] for p in g]
                self._cycle_failed(profile, rest, exc_b, stats, t0, None)
                return
        else:
            self.metrics.multicycle_cycles.inc(applied_a)
            encoder._cycle_index = ci_a
            if tag == "abandoned":
                pipe.note_redispatch()
                diverged = [f"{name} {pv}->{av}" for (name, pv), (_n2, av)
                            in zip(outcome["predicted"], outcome["actual"]) if pv != av]
                log.info("speculative batch abandoned for profile %r (host fold diverged "
                         "from the predicate digest: %s); re-dispatching %d group(s)",
                         profile, ", ".join(diverged), len(rest_groups))
            if bad_reason is not None:
                self._mc_fall_back(profile, rest_groups, stats, t0, bad_reason)
            elif len(rest_groups) == 1:
                self._schedule_profile(profile, rest_groups[0][1], stats, t0)
            else:
                self._schedule_profile_multi(profile, rest_groups, stats, t0)
        self._maybe_speculate(profile, spec)

    def speculation_ledger(self) -> dict:
        """The depth-2 speculation ledger {'adopted', 'abandoned',
        'redispatched'}, read from this scheduler's
        scheduler_speculation_total{outcome} counters (they survive the
        regime pipelines' eviction)."""
        return {o: int(self.metrics.speculation.labels(outcome=o).get())
                for o in ("adopted", "abandoned", "redispatched")}

    def _commit_record(
        self,
        rec,
        st: dict,
        spec,
        encoder,
        pending: "list[Pod]",
        nodes,
        stats: CycleStats,
        before: tuple,
        gang_dropped: int,
        fetch_bytes: int,
        extra_phases: "dict | None" = None,
        extra_marks: "dict | None" = None,
        extra_counts: "dict | None" = None,
        compile_source: str = "",
        speculation: str = "",
        row_window: "tuple | None" = None,
    ) -> None:
        """Assemble + commit one cycle flight record: pipeline stage
        marks / phases, pad-regime signature, queue depths, and the
        per-profile outcome deltas. `speculation` is a depth-2 outcome
        (adopted | abandoned | none); `row_window` an inner cycle's streamed
        decision window."""
        from ..models import packing as _packing
        from .cycle import RESILIENT_STRIKES

        rec.slot = int(st.get("slot", -1))
        rec.forced_sync = bool(self.forced_sync)
        for k, v in st.items():
            if k.startswith("t_"):
                rec.mark(k[2:], v)
        rec.phases.update(
            {k: float(v) for k, v in st.items() if k.endswith("_ms")}
        )
        for k, v in (extra_marks or {}).items():
            rec.mark(k, v)
        rec.phases.update(extra_phases or {})
        if self.admission is not None:
            # front door: worst admission-accept -> bind latency among this
            # record's binds (collected by _bind via note_bind)
            sb_ms = self.admission.take_bind_latency_ms()
            if sb_ms > 0.0:
                rec.phases["submit_bind_ms"] = sb_ms
        rec.sig = _packing.shape_signature(spec)
        if compile_source:
            rec.compile_source = compile_source
        if speculation:
            # one sample per speculation: the observer's thrash EWMA
            rec.speculation = speculation
        qc = self.queue.pending_counts()
        sb, ub, bb, pb, vb = before
        rec.counts.update(
            pods=len(pending),
            nodes=len(nodes),
            scheduled=stats.scheduled - sb,
            unschedulable=stats.unschedulable - ub,
            bind_errors=stats.bind_errors - bb,
            preemptors=stats.preemptors - pb,
            victims=stats.victims - vb,
            gang_dropped=gang_dropped,
            fetch_bytes=fetch_bytes,
            retry_strikes_total=sum(RESILIENT_STRIKES.values()),
            full_encodes=int(encoder.full_encodes),
            delta_hits=int(encoder.delta_hits),
            fold_hits=int(getattr(encoder, "fold_hits", 0)),
            ingest_hits=int(getattr(encoder, "ingest_hits", 0)),
            queue_active=qc.get("active", 0),
            queue_backoff=qc.get("backoff", 0),
            queue_unschedulable=qc.get("unschedulable", 0),
            rung=self.ladder.rung,
            n_devices=self.n_devices,
            collective_payload_bytes=self._collective_payload.get(
                rec.profile, 0
            ),
            **(extra_counts or {}),
        )
        if _spans.ARMED:
            self._emit_cycle_spans(rec, pending, speculation, row_window)
        self.flight.commit(rec)

    def _emit_cycle_spans(self, rec, pending, speculation: str = "",
                          row_window: "tuple | None" = None) -> None:
        """Armed-only: this record's serve-side spans (dispatch,
        dispatch.speculative, decision.row, apply.fold) for every sampled
        pod it carried, and the record's `trace_ids` exemplar join. All
        windows come from the record's own marks (the recorder's
        perf_counter clock, the span ring's base too); `row_window`
        overrides the decision window for an inner cycle of a batch."""
        ctxs = []
        for p in pending:
            c = _spans.ctx_for(p.uid)
            if c is not None:
                ctxs.append((p.uid, c))
        if not ctxs:
            return
        m = rec.marks
        d0, d1 = m.get("dispatch_start"), m.get("dispatch_end")
        r0, r1 = row_window or (m.get("decision_start"), m.get("decision_end"))
        a0, a1 = m.get("apply_start"), m.get("winners_end")
        for uid, c in ctxs:
            if d0 is not None and d1 is not None:
                _spans.record_span("dispatch", c, d0, d1, uid=uid, seq=rec.seq)
            if speculation in ("adopted", "abandoned"):
                # the speculative continuation this batch resolved, on the
                # dispatch window it rode
                _spans.record_span(
                    "dispatch.speculative", c,
                    d0 if d0 is not None else rec.t_start,
                    d1 if d1 is not None else rec.t_start,
                    uid=uid, seq=rec.seq, outcome=speculation)
            if r0 is not None and r1 is not None:
                _spans.record_span("decision.row", c, r0, r1, uid=uid, seq=rec.seq)
            if a0 is not None and a1 is not None:
                _spans.record_span("apply.fold", c, a0, a1, uid=uid, seq=rec.seq)
        rec.trace_ids = tuple(dict.fromkeys(c.trace_id for _u, c in ctxs))

    def _cycle_failed(
        self,
        profile: str,
        pending: "list[Pod]",
        e: BaseException,
        stats: CycleStats,
        t0: float,
        rec,
    ) -> None:
        """A dispatch / fetch failure consumed the cycle before any bind:
        classify it, step the degradation ladder, requeue every pod with
        backoff, and commit an aborted flight record."""
        from .pipeline import DispatchDeadlineExceeded

        cls = (
            "deadline" if isinstance(e, DispatchDeadlineExceeded)
            else classify_failure(e)
        )
        self._cycle_fault = True
        seq = rec.seq if rec is not None else -1
        logging.getLogger(__name__).error(
            "cycle dispatch failed for profile %r (%s: %s); stepping "
            "the degradation ladder and requeueing %d pods",
            profile, cls, e, len(pending),
        )
        new_rung = self.ladder.degrade(f"{cls}: {str(e)[:200]}", seq=seq)
        per_pod_s = (self._now() - t0) / max(len(pending), 1)
        for pod in pending:
            self.queue.requeue_backoff(pod, event="DispatchFailed")
            stats.bind_errors += 1
            if self.flight is not None:
                self.flight.pod_event(
                    pod.uid, pod.name, "DispatchFailed", cycle=seq,
                    failure=cls,
                )
            self.metrics.observe_attempt("error", per_pod_s, profile)
        if rec is not None:
            rec.counts.update(
                pods=len(pending),
                aborted=1,
                bind_errors=len(pending),
                rung=new_rung,
            )
            self.flight.commit(rec)
        if _blackbox.ARMED and cls == "deadline":
            # a watchdog-aborted dispatch is a black-box trigger: capture
            # the rings now — a later kill -9 must still find this bundle
            _blackbox.trigger("watchdog", f"profile={profile} seq={seq} {e}")

    def _on_rung_transition(self, old: int, new: int, reason: str) -> None:
        """A rung's side effects (outside the ladder lock). `sequential`
        and `forced_sync` are read at dispatch time; `retrace` drops every
        memoized program set and stable table so the next cycle rebuilds
        them; `stateless` seals durable state for failover and detaches
        it, pins the ladder's floor there, and dumps the black box."""
        if new >= old and new >= RUNG_RETRACE:
            with self._packed_lock:
                self._packed.clear()
            self._dev_stable.clear()
        if new >= RUNG_STATELESS and old < RUNG_STATELESS and self.state is not None:
            # seal-for-failover: a final snapshot + journal close, so the
            # standby restores a clean boundary; then detach so this
            # process's further mutations stop journaling
            try:
                self.state.seal()
                self.state.detach()
                logging.getLogger(__name__).warning(
                    "durable state sealed + detached for failover "
                    "(degradation rung 'stateless'): %s", reason)
            except Exception:
                logging.getLogger(__name__).exception(
                    "seal-for-failover failed; continuing stateless "
                    "(journal tail on disk is the fallback)")
            # durability is gone for this process either way: the ladder
            # never reports "normal" while mutations go unjournaled
            self.ladder.floor = RUNG_STATELESS
        if new >= RUNG_STATELESS and old < RUNG_STATELESS:
            logging.getLogger(__name__).warning(
                "degradation rung 'stateless' reached: %s", reason)
            if _blackbox.ARMED:
                _blackbox.trigger("stateless", reason)

    def _apply_phase(
        self,
        profile: str,
        framework,
        pending: "list[Pod]",
        nodes,
        existing,
        assignment,
        gang_dropped,
        extender_errors: "dict[int, str]",
        reject_counts_fn,
        force_pre,
        stats: CycleStats,
        t0: float,
        rec,
        t_device: float,
    ) -> None:
        """The host apply phase of one cycle: winner bind loop,
        preemption force, loser requeue, victim eviction. Winners and
        losers are classified once with numpy, the per-plugin attribution
        is forced once as a matrix (`reject_counts_fn()`), outcome metrics
        batch per cycle, and every journal record of the fold coalesces
        into ONE batch record (`state.batch()`, which replays to the digest
        of N single records); per-pod calls that carry semantics — assume,
        host plugins, bind, events, timelines — stay per pod, in slot
        order.

        `force_pre()` enqueues the deferred programs and forces the
        cycle's preemption output: `(nominated[:P_real] | None,
        victims[:E_real] | None)`."""
        fr = self.flight
        filter_names = framework.filter_names
        if rec is not None:
            rec.mark("apply_start", fr.now())

        def per_pod_s() -> float:
            return (self._now() - t0) / max(len(pending), 1)

        def _pev(pod, kind: str, **detail) -> None:
            if fr is not None:
                fr.pod_event(pod.uid, pod.name, kind, cycle=rec.seq, **detail)

        from ..framework.host import (
            HostPluginRejection,
            run_post_bind,
            run_reserve_permit_prebind,
            run_unreserve,
        )

        a = np.asarray(assignment[: len(pending)])
        win_idx = np.flatnonzero(a >= 0)
        lose_idx = np.flatnonzero(a < 0)
        # ONE journal group-append per cycle: every record the fold emits
        # (assume / bind / requeue / evict) buffers into a single batch
        # record, appended when the scope exits
        batch_cm = (self.state.batch() if self.state is not None
                    else contextlib.nullcontext())
        with batch_cm:
            n_bound = 0
            for i in win_idx:
                i = int(i)
                pod = pending[i]
                node_name = nodes[int(a[i])].name
                try:
                    # a per-pod error (the uid raced to bound via an informer
                    # echo mid-cycle) must not kill the loop
                    self.cache.assume(pod, node_name)
                except ValueError:
                    stats.bind_errors += 1
                    _pev(pod, "BindError", node=node_name, stage="assume")
                    self.metrics.observe_attempt("error", per_pod_s(), profile)
                    continue
                # Reserve -> Permit -> PreBind host extension points
                try:
                    run_reserve_permit_prebind(self.host_plugins, pod, node_name)
                except HostPluginRejection as rej:
                    self.cache.forget(pod.uid)
                    if rej.point == "PreBind":
                        # transient pre-bind failure: retry with backoff
                        self.queue.requeue_backoff(pod)
                        stats.bind_errors += 1
                        _pev(pod, "BindError", node=node_name,
                             stage="PreBind", plugin=rej.plugin)
                        self.metrics.observe_attempt("error", per_pod_s(), profile)
                    else:
                        # Reserve / Permit veto: unschedulable, attributed to
                        # the vetoing host plugin
                        self.events.failed_scheduling(
                            pod, f"{rej.plugin} rejected at {rej.point}: {rej.reason}"
                        )
                        self.queue.requeue_unschedulable(pod, reasons=(rej.plugin,))
                        stats.unschedulable += 1
                        _pev(pod, "Rejected", node=node_name,
                             stage=rej.point, plugin=rej.plugin)
                        self.metrics.observe_attempt(
                            "unschedulable", per_pod_s(), profile)
                    continue
                t_bind = self._now()
                try:
                    self._bind(pod, node_name)
                except Exception:
                    run_unreserve(self.host_plugins, pod, node_name)
                    self.cache.forget(pod.uid)
                    self.queue.requeue_backoff(pod)
                    stats.bind_errors += 1
                    _pev(pod, "BindError", node=node_name, stage="bind")
                    self.metrics.observe_attempt("error", per_pod_s(), profile)
                    continue
                self.metrics.binding_duration.observe(self._now() - t_bind)
                self.cache.finish_binding(pod.uid)
                run_post_bind(self.host_plugins, pod, node_name)
                self.events.scheduled(pod, node_name)
                _pev(pod, "Bound", node=node_name)
                stats.scheduled += 1
                self.metrics.pod_scheduling_attempts.observe(
                    self.queue.attempts_of(pod.uid)
                )
                n_bound += 1
            if n_bound:
                self.metrics.observe_attempts("scheduled", per_pod_s(), profile, n_bound)

            # losers: enqueue the deferred programs and force preemption now
            t_winners = self._now()
            if rec is not None:
                rec.mark("winners_end", fr.now())
            nominated, victims = force_pre()
            t_post = self._now()
            if rec is not None:
                rec.mark("postfilter_end", fr.now())
            self.metrics.cycle_duration.labels(phase="postfilter").observe(
                t_post - t_winners
            )

            rej_mat = None
            n_unsched = 0
            reason_incs: dict[str, int] = {}
            for i in lose_idx:
                i = int(i)
                pod = pending[i]
                if i in extender_errors:
                    self.queue.requeue_backoff(pod)
                    stats.bind_errors += 1
                    _pev(pod, "BindError", stage="extender")
                    self.metrics.observe_attempt("error", per_pod_s(), profile)
                    continue
                if nominated is not None and nominated[i] >= 0:
                    pod.nominated_node_name = nodes[int(nominated[i])].name
                    _pev(pod, "Nominated", node=pod.nominated_node_name)
                    # in-place mutation: the delta encoder must re-read this
                    # pod's slot next cycle
                    self._nominated_mut[profile].add(id(pod))
                    self.last_nominations.append((pod, pod.nominated_node_name))
                    stats.preemptors += 1
                if gang_dropped[i]:
                    reasons = ("Coscheduling",)
                    message = (
                        f"pod group {pod.spec.pod_group!r} did not "
                        "reach minMember; all-or-nothing placement "
                        "rolled back"
                    )
                else:
                    if rej_mat is None:
                        rej_mat = reject_counts_fn()
                    per_plugin = list(zip(filter_names, rej_mat[i]))
                    reasons = tuple(name for name, n in per_plugin if n > 0)
                    message = failed_scheduling_message(len(nodes), per_plugin)
                for r in reasons:
                    reason_incs[r] = reason_incs.get(r, 0) + 1
                _pev(pod, "Unschedulable", plugin=reasons[0] if reasons else "")
                self.events.failed_scheduling(pod, message)
                self.queue.requeue_unschedulable(pod, reasons=reasons)
                stats.unschedulable += 1
                n_unsched += 1
            for r, cnt in reason_incs.items():
                self.metrics.unschedulable_reasons.labels(
                    plugin=r, profile=profile
                ).inc(cnt)
            if n_unsched:
                self.metrics.observe_attempts(
                    "unschedulable", per_pod_s(), profile, n_unsched
                )

            if victims is not None and victims.any():
                # victims belong to the preemptor nominated onto their node
                preemptor_by_node = {
                    node: pod.name for pod, node in self.last_nominations
                }
                # armed-only: the preemptor pod by node, so a victim's span
                # joins the PREEMPTOR's trace
                preemptor_pod_by_node = (
                    {node: pod for pod, node in self.last_nominations}
                    if _spans.ARMED else {}
                )
                n_vict = 0
                for e in np.flatnonzero(victims):
                    vpod, vnode = existing[int(e)]
                    t_ev0 = _spans.now() if _spans.ARMED else 0.0
                    self.evictor(vpod, vnode)
                    self.last_evictions.append((vpod, vnode))
                    _pev(vpod, "Evicted", node=vnode,
                         preemptor=preemptor_by_node.get(vnode, ""))
                    self.events.preempted(
                        vpod, preemptor_by_node.get(vnode, "<pending>")
                    )
                    if _spans.ARMED:
                        pre = preemptor_pod_by_node.get(vnode)
                        c = _spans.ctx_for(pre.uid) if pre is not None else None
                        if c is not None:
                            _spans.record_span(
                                "preempt.victim", c, t_ev0, _spans.now(),
                                uid=pre.uid, victim=vpod.uid, node=vnode,
                                seq=rec.seq if rec is not None else -1)
                    n_vict += 1
                stats.victims += n_vict
                self.metrics.preemption_victims.observe(n_vict)

        # apply = winner bind loop + loser requeue loop (the preemption
        # force between them is the "postfilter" phase)
        self.metrics.cycle_duration.labels(phase="apply").observe(
            (t_winners - t_device) + (self._now() - t_post)
        )

    def _bind(self, pod: Pod, node_name: str) -> None:
        """Bind, delegating to the first bind-verb extender (upstream: an
        extender with a bind verb replaces the default binder). A bind
        that returns closes the pod's submit->bind window at the front
        door and stamps its bind.confirm span; a raising one is a bind
        error and does neither."""
        t_b0 = _spans.now() if _spans.ARMED else 0.0
        for ext in self.extenders:
            if ext.is_binder:
                ext.bind(pod, node_name)
                break
        else:
            self.binder(pod, node_name)
        if self.admission is not None:
            self.admission.note_bind(pod.uid)
        if _spans.ARMED:
            c = _spans.ctx_for(pod.uid)
            if c is not None:
                _spans.record_span("bind.confirm", c, t_b0, _spans.now(),
                                   uid=pod.uid, node=node_name)

    def _update_gauges(self) -> None:
        self.metrics.set_pending(self.queue.pending_counts())
        c = self.cache.counts()
        self.metrics.set_cache(
            c.get("nodes", 0),
            c.get("bound", 0) + c.get("assumed", 0),
            c.get("assumed", 0),
        )
        if self.flight is not None and self.flight.cycles:
            d = self.flight.derived()
            self.metrics.pipeline_overlap.set(d["overlap_ratio"])
        if self.admission is not None:
            # the cycle refresh keeps the gauge falling as the queue drains
            # when no new submission arrives to re-stamp it
            self.metrics.admission_queue_depth.set(self.admission.queue_depth())

    def pod_timeline(self, uid: str) -> dict | None:
        """The per-pod scheduling timeline: the flight recorder's pod
        events (queued -> attempts -> bound / evicted) joined with what is
        still in the events ring. None for a pod neither side has seen."""
        tl = self.flight.pods.get(uid) if self.flight is not None else None
        ring = self.events.events_for(uid)
        if tl is None and not ring:
            return None
        out = tl or {"uid": uid, "name": "", "events": []}
        attempt_kinds = {
            "Bound", "Unschedulable", "BindError", "Rejected", "Expired",
            "DispatchFailed",
        }
        out["attempts"] = [
            {
                "cycle": e.get("cycle", -1),
                "result": e["kind"],
                **{k: e[k] for k in ("plugin", "node", "stage") if k in e},
            }
            for e in out["events"]
            if e["kind"] in attempt_kinds
        ]
        terminal = [
            e for e in out["events"]
            if e["kind"] in ("Bound", "Evicted", "Deleted", "BoundObserved")
        ]
        out["state"] = (
            terminal[-1]["kind"] if terminal
            else ("Unschedulable" if any(
                e["kind"] == "Unschedulable" for e in out["events"]
            ) else "Pending")
        )
        out["ring_events"] = [dataclasses.asdict(e) for e in ring]
        return out

    def profile_cycle(self, repeats: int = 3) -> dict:
        """The sampled per-plugin observability pass: times each enabled
        plugin's functions alone over the CURRENT pending set and cluster
        state (the queue is not drained), filling the upstream per-plugin
        and per-extension-point histograms. Not the hot path."""
        from .profiling import profile_plugins

        pending = list(self.queue.all_pending())
        nodes = self.cache.nodes()
        if not pending or not nodes:
            return {}
        self._encoder.pad_pods = self._encoder.hysteresis_pad(
            "P", _pad(len(pending), self._pad_bucket), len(pending))
        self._encoder.pad_nodes = self._encoder.hysteresis_pad(
            "N", _pad(len(nodes), self._pad_bucket), len(nodes))
        snap = self._encoder.encode(
            nodes,
            pending,
            self.cache.existing_pods(),
            pod_groups=list(self._groups.values()),
            pvcs=list(self._pvcs.values()),
            pvs=list(self._pvs.values()),
            storage_classes=list(self._storage_classes.values()),
        )
        return profile_plugins(self.framework, snap, self.metrics, repeats)

    def run(self, max_cycles: int | None = None,
            idle_sleep: float = 0.01) -> None:
        """The scheduling loop: runs until `max_cycles` cycles have
        executed (None = forever), sleeping `idle_sleep` after an empty
        cycle."""
        cycles = 0
        while max_cycles is None or cycles < max_cycles:
            stats = self.schedule_cycle()
            cycles += 1
            if stats.attempted == 0:
                _time.sleep(idle_sleep)
