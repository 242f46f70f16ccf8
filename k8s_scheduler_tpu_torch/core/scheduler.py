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

Not in this slice, and refused when a configuration turns them on:
multi-cycle dispatch and speculation (`multiCycleK` > 1, ROADMAP A11), the
persistent compile cache (`compileCacheDir`), fault injection
(`faultSpec`) and durable state (`state=`) (ROADMAP A10b), and
multi-device serving (`shardDevices` > 1, ROADMAP A13)."""

from __future__ import annotations

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
    DegradationLadder,
)
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


def _refuse_unported(config: SchedulerConfiguration, state) -> None:
    """Serving features later slices port: a configuration that turns one
    on is refused by name, never ignored."""
    cc = config.compile_cache_dir
    checks = (
        (int(config.multi_cycle_k) > 1,
         f"multiCycleK={config.multi_cycle_k} (multi-cycle dispatch and its "
         "depth-2 speculation) is not ported yet (ROADMAP A11)"),
        (bool(cc) and cc.lower() not in ("off", "none"),
         "compileCacheDir (the persistent compile cache) is not ported yet "
         "(ROADMAP A10b)"),
        (int(config.shard_devices) > 1,
         f"shardDevices={config.shard_devices} (multi-device serving) is not "
         "ported yet (ROADMAP A13)"),
        (bool(config.fault_spec or os.environ.get("SCHED_FAULTS", "")),
         "faultSpec / SCHED_FAULTS (fault injection) is not ported yet "
         "(ROADMAP A10b)"),
        (state is not None,
         "durable state (state=) is not ported yet (ROADMAP A10b)"),
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
        state: "object | None" = None,  # durable state: ROADMAP A10b
        device=None,  # None = the card (raises without one); "cpu" runs
        # the plain versions
    ) -> None:
        self.config = config or SchedulerConfiguration()
        _refuse_unported(self.config, state)
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
        # watchdog bound on the blocking decision fetch (0 = unbounded)
        self._dispatch_deadline_s = (
            max(float(self.config.dispatch_deadline_ms), 0.0) / 1e3
        )
        self._cycle_counter = 0
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
        self._warmer = None
        if self.config.speculative_compile and self.observer is not None:
            from .compile_cache import CompileWarmer

            # lazy daemon thread: nothing starts until the first submit
            self._warmer = CompileWarmer(metrics=self.metrics)
        self.n_devices = 1
        self.metrics.shard_devices.set(self.n_devices)
        self._collective_payload: dict[str, int] = {}
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
            slots=2,
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
        stats = CycleStats()
        self.last_nominations = []
        self.last_evictions = []
        for pod, node in self.cache.cleanup_expired():
            self.queue.requeue_backoff(pod, event="AssumeExpired")
            self.events.assume_expired(pod, node)
            if self.flight is not None:
                self.flight.pod_event(pod.uid, pod.name, "Expired", node=node)
        self.queue.flush_unschedulable_timeout()

        pending_all = self.queue.pop_ready()
        if not pending_all:
            # gauges track deletions / moves between non-empty cycles too
            self._update_gauges()
            return stats
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
            if group:
                self._schedule_profile(name, group, stats, t0)

        stats.cycle_seconds = self._now() - t0
        self.metrics.cycle_duration.labels(phase="total").observe(
            stats.cycle_seconds
        )
        if stats.attempted > 0 and not self._cycle_fault:
            self.ladder.note_clean_cycle(seq=self._cycle_counter)
        self._update_gauges()
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
            if self._packed_builds > builds_before:
                extra_phases["compile_ms"] = self._last_build_s * 1e3
                extra_counts["regime_flip"] = 1
                compile_source = self._last_compile_source
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
    ) -> None:
        """Assemble + commit one cycle flight record: pipeline stage
        marks / phases, pad-regime signature, queue depths, and the
        per-profile outcome deltas."""
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
        rec.sig = _packing.shape_signature(spec)
        if compile_source:
            rec.compile_source = compile_source
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
        self.flight.commit(rec)

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

    def _on_rung_transition(self, old: int, new: int, reason: str) -> None:
        """A rung's side effects (outside the ladder lock). `sequential`
        and `forced_sync` are read at dispatch time; `retrace` drops every
        memoized program set and stable table so the next cycle rebuilds
        them; `stateless` would seal durable state, which this slice does
        not have."""
        if new >= old and new >= RUNG_RETRACE:
            with self._packed_lock:
                self._packed.clear()
            self._dev_stable.clear()
        if new >= RUNG_STATELESS and old < RUNG_STATELESS:
            logging.getLogger(__name__).warning(
                "degradation rung 'stateless' reached: %s", reason)

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
        batch per cycle; per-pod calls that carry semantics — assume, host
        plugins, bind, events, timelines — stay per pod, in slot order.

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
            n_vict = 0
            for e in np.flatnonzero(victims):
                vpod, vnode = existing[int(e)]
                self.evictor(vpod, vnode)
                self.last_evictions.append((vpod, vnode))
                _pev(vpod, "Evicted", node=vnode,
                     preemptor=preemptor_by_node.get(vnode, ""))
                self.events.preempted(
                    vpod, preemptor_by_node.get(vnode, "<pending>")
                )
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
        extender with a bind verb replaces the default binder)."""
        for ext in self.extenders:
            if ext.is_binder:
                ext.bind(pod, node_name)
                return
        self.binder(pod, node_name)

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
        """The per-plugin profiling pass (reference `core/profiling.py`)
        is ROADMAP A10b."""
        raise NotImplementedError(
            "profile_cycle (core/profiling.py) is not ported yet (ROADMAP A10b)")

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
