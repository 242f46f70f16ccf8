"""Process entry: flags, config load, serving, leader election (the port's
copy of `k8s_scheduler_tpu/cmd/main.py`, with the same flags).

Parse flags, load the KubeSchedulerConfiguration-shaped YAML, start the
health/metrics HTTP endpoints, optionally win a leader lease, then run the
gRPC shim that the cluster agent talks to:

    python -m k8s_scheduler_tpu_torch \
        --config scheduler.yaml --address 127.0.0.1:50051 --http-port 10251

The scheduler runs on the card; `--device cpu` asks for the plain-torch
versions explicitly (tests), and a machine without a GPU refuses to serve
rather than fall back. grpc is imported only when the process serves, so
`--help` needs none. Multi-host serving (`shardDevices` > 1, a launcher's
coordinator address) is refused by name (ROADMAP A13).
"""

from __future__ import annotations

import argparse
import os
import signal
import threading

from ..config import SchedulerConfiguration, load_config
from .httpserver import start_http_server, stop_http_server
from .leaderelection import FileLease


def new_scheduler_command() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="k8s-scheduler-tpu-torch",
        description="GPU scheduling service (kube-scheduler-compatible "
        "semantics; snapshot in, bindings out over gRPC)",
    )
    ap.add_argument(
        "--device", default=None,
        help="torch device of the cycle programs: the card by default "
        "(refused without one); 'cpu' runs the plain-torch versions",
    )
    ap.add_argument(
        "--config", default="", help="KubeSchedulerConfiguration-style YAML"
    )
    ap.add_argument(
        "--address", default="127.0.0.1:50051", help="gRPC bind address"
    )
    ap.add_argument(
        "--http-port", type=int, default=10251,
        help="/healthz + /metrics port (0 = ephemeral, -1 = disabled)",
    )
    ap.add_argument(
        "--http-host", default="127.0.0.1", help="/healthz + /metrics host"
    )
    ap.add_argument(
        "--leader-elect", action="store_true",
        help="block on the lease file until elected (active/standby HA)",
    )
    ap.add_argument(
        "--leader-elect-lease-file", default="/tmp/k8s-scheduler-tpu.lease",
        help="shared lease file used for election",
    )
    ap.add_argument(
        "--profile-every", type=int, default=0,
        help="every N cycles, run the per-plugin profiling pass (0 = off)",
    )
    ap.add_argument(
        "--forced-sync", action="store_true",
        help="block every cycle dispatch to completion (disables the "
        "split-phase serving pipeline's overlap; for debugging and "
        "latency measurement — results are identical either way)",
    )
    ap.add_argument(
        "--flight-record-n", type=int, default=-1,
        help="cycle flight-recorder ring capacity (per-cycle phase "
        "records behind /debug/flightrecorder, /debug/trace and the "
        "derived pipeline gauges); 0 disables, -1 = keep config "
        "flightRecorderSize (default 512)",
    )
    ap.add_argument(
        "--trace-dir", default="",
        help="on shutdown, dump the flight recorder's full ring as a "
        "Chrome-trace/Perfetto JSON into this directory (live download: "
        "/debug/trace?last=N)",
    )
    ap.add_argument(
        "--health-max-cycle-age", type=float, default=-1.0,
        help="/healthz reports 503 when no scheduling cycle completed "
        "within this many seconds (staleness from the flight recorder; "
        "0 disables, -1 = keep config healthMaxCycleAge)",
    )
    ap.add_argument(
        "--pad-ma", type=int, default=0,
        help="pre-size the sticky per-pod affinity-term pad (MA) so a "
        "mid-serving arrival of a many-term pod cannot flip the packed "
        "regime (overrides config padMa; 0 = keep config)",
    )
    ap.add_argument(
        "--pad-mc", type=int, default=0,
        help="pre-size the sticky per-pod topology-spread-constraint pad "
        "(MC) the same way (overrides config padMc; 0 = keep config)",
    )
    ap.add_argument(
        "--multi-cycle-k", type=int, default=0,
        help="multi-cycle on-device serving: coalesce up to K arrival "
        "groups into one device dispatch running K scheduling cycles in "
        "a device-resident loop (amortizes the dispatch round trip "
        "K-fold for small-delta cycles; config multiCycleK; 1 disables, "
        "0 = keep config). Workloads outside the exactness envelope "
        "fall back to sequential single-cycle dispatches",
    )
    ap.add_argument(
        "--multi-cycle-max-wait-ms", type=float, default=-1.0,
        help="latency bound on the multi-cycle coalescing buffer: a "
        "delta group is never held back longer than this many ms "
        "waiting for the batch to fill (config multiCycleMaxWaitMs; "
        "-1 = keep config)",
    )
    ap.add_argument(
        "--slo-p99-ms", type=float, default=-1.0,
        help="latency SLO objective: at most 1%% of cycles in the "
        "sloWindowCycles window may exceed this many milliseconds of "
        "cycle wall time; drives scheduler_slo_burn_rate{window}, "
        "scheduler_slo_budget_remaining and the /healthz degraded flag "
        "(config sloP99Ms; 0 disables, -1 = keep config)",
    )
    ap.add_argument(
        "--pad-hysteresis-pct", type=float, default=-1.0,
        help="regime hysteresis: a shrinking pod/node count only steps "
        "the pad bucket DOWN when it leaves at least this many percent "
        "of headroom inside the smaller bucket, so an oscillating "
        "workload holds the larger (already-compiled) regime instead "
        "of flip-flopping (config padHysteresisPct; 0 disables, "
        "-1 = keep config)",
    )
    ap.add_argument(
        "--compile-cache-dir", default="",
        help="persistent kernel cache directory (config "
        "compileCacheDir): the nvcc-built kernel libraries keyed by "
        "source, flags and nvcc/torch/CUDA/sm fingerprint, so a warm "
        "restart builds no kernel it built before. Empty = <stateDir>/compile_cache when --state-dir is "
        "set, else disabled; 'off' disables even with a state dir",
    )
    ap.add_argument(
        "--shard-devices", type=int, default=-1,
        help="shard the device-resident carry over a 1-D pods mesh of "
        "this many local devices (config shardDevices); placements "
        "stay bit-identical to the single-device run (shard-invariant "
        "tie-breaking). 0/1 = single device, -1 = keep config",
    )
    ap.add_argument(
        "--speculative-compile", type=int, default=-1, choices=(-1, 0, 1),
        help="background pre-compilation of the adjacent pad regime on "
        "a warm thread when demand drifts toward a bucket boundary "
        "(config speculativeCompile; 1 on, 0 off, -1 = keep config)",
    )
    ap.add_argument(
        "--speculative-dispatch", type=int, default=-1, choices=(-1, 0, 1),
        help="depth-2 speculative dispatch pipelining: while multi-cycle "
        "batch k is on device, dispatch batch k+1 against the predicted "
        "post-k carry; adopted on a predicate match, abandoned and "
        "re-dispatched on a mismatch — results are bit-identical either "
        "way. Forced off under --forced-sync and at/below the ladder's "
        "sequential rung (config speculativeDispatch; 1 on, 0 off, "
        "-1 = keep config)",
    )
    ap.add_argument(
        "--incremental-encode", type=int, default=-1, choices=(-1, 0, 1),
        help="admission-time incremental encode: parse each buffered pod "
        "into staged row data at multi-cycle buffer time (the ack "
        "path's shadow) so the flush encode is an O(dirty) finalize "
        "over pre-parsed rows; falls back to a full rebuild on "
        "interning-table growth or a pad-regime flip, bit-identical "
        "either way (config incrementalEncode; 1 on, 0 off, "
        "-1 = keep config)",
    )
    ap.add_argument(
        "--dispatch-deadline-ms", type=float, default=-1.0,
        help="dispatch watchdog: bound on the blocking per-cycle "
        "decision fetch in milliseconds — on expiry the fetch is "
        "abandoned, the cycle's pods requeue, and the degradation "
        "ladder steps down a rung (config dispatchDeadlineMs; "
        "0 disables, -1 = keep config)",
    )
    ap.add_argument(
        "--degrade-promote-cycles", type=int, default=0,
        help="degradation ladder: consecutive clean cycles before the "
        "ladder steps one rung back up toward normal (config "
        "degradePromoteCycles; 0 = keep config)",
    )
    ap.add_argument(
        "--fault-spec", default="",
        help="fault injection plan, e.g. 'fetch_hang@cycle=40:ms=5000' "
        "(config faultSpec; env SCHED_FAULTS also read when both are "
        "empty) — soaks/benches/tests only, never production",
    )
    ap.add_argument(
        "--submit-addr", default="",
        help="submission front door: serve the admission-controlled "
        "Submit/NodeChurn RPCs on this extra gRPC address (own accept "
        "queue + worker pool) and run the internal serve loop — "
        "arrivals coalesce straight into the multi-cycle batcher "
        "instead of waiting for agent-driven Cycle RPCs. Accepted "
        "pods are journaled through the WAL before the ack returns "
        "when --state-dir is set. Empty = front door disabled",
    )
    ap.add_argument(
        "--admission-queue-depth", type=int, default=-1,
        help="bound on the admission queue (pending pods + coalescing "
        "buffers): a Submit that would push the depth past this is "
        "shed with RESOURCE_EXHAUSTED + retry-after instead of "
        "buffered (config admissionQueueDepth; 0 = unbounded, "
        "-1 = keep config)",
    )
    ap.add_argument(
        "--state-dir", default="",
        help="durable scheduler state: write-ahead journal + snapshots "
        "of the queue/cache live here (config stateDir). A process "
        "starting against a non-empty dir — e.g. a standby that just "
        "won the lease — restores the exact pre-crash state before its "
        "first cycle. Empty = durability disabled",
    )
    ap.add_argument(
        "--snapshot-interval", type=float, default=-1.0,
        help="seconds between journal-compacting snapshots (config "
        "snapshotInterval; 0 = journal only, -1 = keep config)",
    )
    ap.add_argument(
        "--trace-sample-rate", type=float, default=-1.0,
        help="pod-lifecycle tracing: head-sampling probability for "
        "submissions arriving without a traceparent (deterministic "
        "per pod uid; an explicit traceparent always samples). Spans "
        "serve at /debug/traces and join /debug/explain (config "
        "traceSampleRate, default 1/64; 0 disables tracing, "
        "-1 = keep config)",
    )
    ap.add_argument(
        "--trace-export-dir", default="",
        help="on shutdown, dump the span ring as OTLP-JSON "
        "(spans-NNNNNN.json) into this directory for external "
        "ingestion; repeated runs append the next file and the "
        "directory is size-rotated (oldest dumps deleted past 64 MB). "
        "Empty = no OTLP export (spans still serve at /debug/traces)",
    )
    ap.add_argument(
        "--metrics-history-samples", type=int, default=-1,
        help="watchtower: per-series raw ring capacity of the "
        "in-process metrics history TSDB; arming it also evaluates "
        "the built-in alert rule pack and serves "
        "/debug/metrics/history, /debug/alerts and /debug/dashboard "
        "(config metricsHistorySamples, default 512; 0 disables the "
        "watchtower, -1 = keep config)",
    )
    ap.add_argument(
        "--alert-rules-file", default="",
        help="extra alert/recording rules (YAML/JSON list, the "
        "metrics/rules.py shape) appended to the built-in pack "
        "(config alertRulesFile; empty = built-ins only)",
    )
    ap.add_argument(
        "--blackbox-retention", type=int, default=-1,
        help="crash black box: post-mortem bundles kept under "
        "<stateDir>/blackbox/ — dumped on SIGTERM, degrade-to-"
        "stateless, watchdog aborts and serve-loop faults; read them "
        "with scripts/blackbox_read.py (config blackboxRetention, "
        "default 8; 0 disables, -1 = keep config; needs --state-dir)",
    )
    return ap


def main(argv: list[str] | None = None) -> int:
    args = new_scheduler_command().parse_args(argv)
    config = (
        load_config(args.config) if args.config else SchedulerConfiguration()
    )
    if args.pad_ma:
        config.pad_ma = args.pad_ma
    if args.pad_mc:
        config.pad_mc = args.pad_mc
    if args.forced_sync:
        config.forced_sync = True
    if args.flight_record_n >= 0:
        config.flight_recorder_size = args.flight_record_n
    if args.health_max_cycle_age >= 0:
        config.health_max_cycle_age_seconds = args.health_max_cycle_age
    if args.slo_p99_ms >= 0:
        config.slo_p99_ms = args.slo_p99_ms
    if args.multi_cycle_k > 0:
        config.multi_cycle_k = args.multi_cycle_k
    if args.multi_cycle_max_wait_ms >= 0:
        config.multi_cycle_max_wait_ms = args.multi_cycle_max_wait_ms
    if args.pad_hysteresis_pct >= 0:
        config.pad_hysteresis_pct = args.pad_hysteresis_pct
    if args.compile_cache_dir:
        config.compile_cache_dir = args.compile_cache_dir
    if args.shard_devices >= 0:
        config.shard_devices = args.shard_devices
    if args.speculative_compile >= 0:
        config.speculative_compile = bool(args.speculative_compile)
    if args.speculative_dispatch >= 0:
        config.speculative_dispatch = bool(args.speculative_dispatch)
    if args.incremental_encode >= 0:
        config.incremental_encode = bool(args.incremental_encode)
    if args.dispatch_deadline_ms >= 0:
        config.dispatch_deadline_ms = args.dispatch_deadline_ms
    if args.degrade_promote_cycles > 0:
        config.degrade_promote_cycles = args.degrade_promote_cycles
    if args.fault_spec:
        config.fault_spec = args.fault_spec
    if args.admission_queue_depth >= 0:
        config.admission_queue_depth = args.admission_queue_depth
    if args.state_dir:
        config.state_dir = args.state_dir
    if args.snapshot_interval >= 0:
        config.snapshot_interval_seconds = args.snapshot_interval
    if args.trace_sample_rate >= 0:
        config.trace_sample_rate = args.trace_sample_rate
    if args.metrics_history_samples >= 0:
        config.metrics_history_samples = args.metrics_history_samples
    if args.alert_rules_file:
        config.alert_rules_file = args.alert_rules_file
    if args.blackbox_retention >= 0:
        config.blackbox_retention = args.blackbox_retention
    if (
        config.health_max_cycle_age_seconds > 0
        and config.flight_recorder_size <= 0
    ):
        # contradictory config: the staleness deadline reads the flight
        # recorder's last-cycle age — with the recorder disabled it
        # would be silently inert and /healthz would report 200 while
        # wedged, the exact failure the deadline exists to catch
        raise SystemExit(
            "--health-max-cycle-age/healthMaxCycleAge requires the "
            "flight recorder (--flight-record-n/flightRecorderSize > 0)"
        )

    # multi-host serving (the reference's initialize_distributed) is not
    # ported: a launcher that set a coordinator address is refused by name.
    # The persistent kernel cache opens in the Scheduler (compileCacheDir or
    # <stateDir>/compile_cache); shardDevices > 1 is refused there.
    for var in ("JAX_COORDINATOR_ADDRESS", "MASTER_ADDR"):
        if os.environ.get(var):
            raise SystemExit(
                f"{var} is set: multi-host serving (initialize_distributed) "
                "is not ported yet (ROADMAP A13)"
            )

    # the shim owns the Scheduler; import deferred so --help stays instant
    from ..service.server import serve

    lease = None
    if args.leader_elect:
        lease = FileLease(args.leader_elect_lease_file)
        print(
            f"waiting for leader lease {args.leader_elect_lease_file} ...",
            flush=True,
        )
        lease.acquire()
        lease.start_renewing()
        print("became leader", flush=True)

    # serve the PROCESS-WIDE registry: process-level counters that never
    # reach a Scheduler handle (program retry strikes from _Resilient)
    # must appear on /metrics. Library/test constructions get a fresh
    # registry by default — only the CLI opts into the global one.
    from ..metrics.metrics import global_metrics

    gm = global_metrics()

    # build identity: one constant-1 gauge stamped at startup so
    # dashboards can correlate latency shifts with binary/runtime
    # changes (bench headlines carry the same fingerprint)
    from ..metrics.metrics import build_fingerprint

    fp = build_fingerprint()
    gm.set_build_info(fp)
    print(
        "build: "
        + " ".join(f"{k}={v}" for k, v in sorted(fp.items())),
        flush=True,
    )

    # leader gauges evaluate at scrape so a failover is visible the
    # moment it happens, not at the next heartbeat write
    gm.leader_state.set_function(
        lambda: 1.0 if (lease.is_leader() if lease else True) else 0.0
    )
    gm.leader_lease_age.set_function(
        lambda: lease.lease_age_seconds() if lease else 0.0
    )

    # durable state: created AFTER the lease is won — a standby must not
    # touch (or journal into) the shared state dir while the active owns
    # it. Scheduler.__init__ restores snapshot+tail before its first
    # cycle, so a takeover resumes with the dead active's exact queue/
    # cache state instead of an empty rebuild.
    state = None
    if config.state_dir:
        from ..state import DurableState

        state = DurableState(
            config.state_dir,
            snapshot_interval_seconds=config.snapshot_interval_seconds,
            metrics=gm,
        )

    server, service, port = serve(
        args.address,
        config=config,
        profile_every=args.profile_every,
        metrics=gm,
        state=state,
        device=args.device,
    )
    print(f"scheduler shim listening on port {port}", flush=True)

    # submission front door: the admission-controlled Submit/NodeChurn
    # RPCs on their own address (own accept queue + worker pool, so a
    # flood of submissions cannot starve the agent channel) plus the
    # internal serve loop — with a network feed there is no agent to
    # drive Cycle, so the scheduler runs its own ScheduleOne loop,
    # serialized against any stray Cycle RPC by the service cycle lock.
    front_door = None
    submit_server = None
    spans_recorder = None
    if args.submit_addr:
        from concurrent import futures as _futures

        import grpc as _grpc

        from ..service.admission import self_confirming_front_door
        from ..service.server import add_to_server

        # pod-lifecycle tracing: armed BEFORE the front door starts so
        # the very first submission can be sampled. Only the front-door
        # path mints trace contexts (Submit is where a pod's lifecycle
        # begins), so agent-driven runs skip the armed cost entirely.
        if config.trace_sample_rate > 0:
            from ..core import spans as _spans

            spans_recorder = _spans.arm(
                rate=config.trace_sample_rate,
                counter=(
                    lambda name: gm.trace_spans.labels(name=name).inc()
                ),
            )
            print(
                "tracing armed: sample rate "
                f"{config.trace_sample_rate:g} "
                "(/debug/traces, /debug/explain)",
                flush=True,
            )

        admission = service.enable_front_door()
        submit_server = _grpc.server(
            _futures.ThreadPoolExecutor(max_workers=8),
            options=(("grpc.so_reuseport", 0),),
        )
        add_to_server(service, submit_server)
        sport = submit_server.add_insecure_port(args.submit_addr)
        if sport == 0 and not args.submit_addr.rstrip().endswith(":0"):
            raise OSError(
                f"failed to bind submit address {args.submit_addr!r}"
            )
        submit_server.start()
        # self-confirming: the local loop is the binder of record (no
        # agent fetches bindings in this mode) — without post-cycle
        # confirmation every assumed bind would TTL-expire and re-bind
        front_door = self_confirming_front_door(service, admission)
        front_door.start()
        print(
            f"front door: submissions on port {sport} "
            f"(admission depth {admission.depth_bound})",
            flush=True,
        )

    if state is not None:
        r = state.last_restore
        print(
            "durable state: restored "
            f"snapshot={r.get('snapshot')} "
            f"replayed={r.get('records_replayed')} records "
            f"pending={r.get('pending')} cache={r.get('cache')}",
            flush=True,
        )

    # health is no longer a static closure: staleness comes from the
    # flight recorder, so a scheduler that stopped completing cycles
    # (wedged device, deadlocked loop) flips /healthz to 503 instead of
    # reporting healthy forever
    from .httpserver import staleness_healthz

    recorder = service.scheduler.flight
    observer = service.scheduler.observer
    healthz = staleness_healthz(
        lambda: {
            "bootId": service.boot_id,
            "leader": lease.is_leader() if lease else True,
            # lease identity + heartbeat age so probes/dashboards see
            # WHO leads and how fresh the lease is, not just a boolean
            **({"lease": lease.describe()} if lease else {}),
            "pending": service.scheduler.queue.pending_counts(),
        },
        recorder,
        config.health_max_cycle_age_seconds,
        observer=observer,
        ladder=service.scheduler.ladder,
        admission=service.admission,
    )

    # the watchtower (metrics history + alert rules): armed only by
    # the CLI, like tracing — library/test constructions pay one
    # module-flag check at the flight-recorder hook and nothing else
    from .watchtower import arm_watchtower

    tsdb_store, alert_engine = arm_watchtower(config, service.scheduler, metrics=gm)
    if tsdb_store is not None:
        print(
            "watchtower armed: "
            f"{len(alert_engine.rules)} rules, history {config.metrics_history_samples} "
            f"raw samples/series, ticker {config.metrics_ticker_seconds:g}s "
            "(/debug/metrics/history, /debug/alerts, /debug/dashboard)",
            flush=True,
        )

    # crash black box: bundles dump at the moment of the trigger
    # (degrade-to-stateless, watchdog abort, serve-loop fault), not at
    # exit — a later kill -9 still finds the bundle on disk
    blackbox_box = None
    if config.state_dir and config.blackbox_retention > 0:
        from ..core import blackbox as _bb
        from ..config.types import to_dict as _config_to_dict

        blackbox_box = _bb.arm(_bb.BlackBox(
            os.path.join(config.state_dir, "blackbox"),
            retention=config.blackbox_retention,
            config=_config_to_dict(config),
            recorder=recorder,
            observer=observer,
            spans_recorder=spans_recorder,
            tsdb=tsdb_store,
            engine=alert_engine,
            ladder=service.scheduler.ladder,
            fault_plan=getattr(service.scheduler, "_fault_plan", None),
            events=service.scheduler.events,
        ))
        print(
            f"black box armed: {blackbox_box.directory} "
            f"(retention {blackbox_box.retention})",
            flush=True,
        )

    http_server = None
    if args.http_port >= 0:
        http_server = start_http_server(
            service.scheduler.metrics,
            port=args.http_port,
            host=args.http_host,
            healthz=healthz,
            recorder=recorder,
            pod_timeline=service.scheduler.pod_timeline,
            state=state,
            observer=observer,
            admission=service.admission,
            spans_recorder=spans_recorder,
            tsdb=tsdb_store,
            alerts=alert_engine,
            dashboard=config.debug_dashboard,
        )
        print(
            "serving /healthz /metrics on port "
            f"{http_server.server_address[1]}",
            flush=True,
        )

    stop = threading.Event()

    def _shutdown(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)
    try:
        stop.wait()
    finally:
        if blackbox_box is not None:
            # FIRST in shutdown: the sigterm bundle captures the rings
            # before the drains below start mutating them
            from ..core import blackbox as _bb

            bpath = _bb.trigger("sigterm", "clean shutdown")
            if bpath:
                print(f"black box dumped: {bpath}", flush=True)
        if front_door is not None:
            # graceful drain BEFORE anything seals: admission closes
            # (late submits answer UNAVAILABLE "draining"), buffered
            # multi-cycle groups flush, the active tier empties — no
            # pod stranded between ack and dispatch — then the loop
            # thread joins
            drained = front_door.stop()
            print(
                f"front door drained: {drained} "
                f"(cycles {front_door.cycles})",
                flush=True,
            )
        if submit_server is not None:
            submit_server.stop(grace=1.0)
        server.stop(grace=2.0)
        if http_server is not None:
            # shutdown + JOIN + close, not a bare shutdown(): the serve
            # thread must be drained before the lease release below
            # hands the socket's port story to a successor
            stop_http_server(http_server)
        if state is not None:
            # seal the journal: a final clean-shutdown snapshot (same
            # pattern as the --trace-dir dump below) so the next start
            # — or the standby about to win the lease — restores from
            # one file with an empty tail. Guarded: a failing seal
            # (disk full) must not abort the rest of shutdown — the
            # journal tail already written is the fallback.
            try:
                state.seal()
                print(
                    "durable state sealed: "
                    f"{state.last_snapshot.get('path')}",
                    flush=True,
                )
            except Exception as e:
                print(f"durable state seal FAILED: {e}", flush=True)
        if args.trace_dir and recorder is not None:
            # post-mortem trace: the full ring as one Perfetto-loadable
            # file (same payload as /debug/trace, taken at shutdown)
            import json
            import time as _t

            from ..core.flight_recorder import to_chrome_trace

            os.makedirs(args.trace_dir, exist_ok=True)
            path = os.path.join(
                args.trace_dir, f"scheduler-trace-{int(_t.time())}.json"
            )
            with open(path, "w") as f:
                json.dump(
                    to_chrome_trace(
                        recorder.snapshot(),
                        epoch=recorder.epoch,
                        # pod-trace tracks merged into the cycle lanes
                        # when tracing was armed this run
                        spans=(
                            spans_recorder.snapshot()
                            if spans_recorder is not None
                            else None
                        ),
                    ),
                    f,
                )
            print(f"flight-recorder trace written to {path}", flush=True)
        if spans_recorder is not None:
            from ..core import spans as _spans

            if args.trace_export_dir:
                # post-mortem OTLP dump (same pattern as --trace-dir):
                # guarded — a failing export must not abort shutdown
                try:
                    opath = _spans.export_otlp_dir(
                        spans_recorder, args.trace_export_dir
                    )
                    if opath:
                        print(
                            f"OTLP span export written to {opath}",
                            flush=True,
                        )
                except Exception as e:  # schedlint: disable=RB001 -- best-effort shutdown dump
                    print(f"OTLP span export FAILED: {e}", flush=True)
            _spans.disarm()
        if tsdb_store is not None:
            # stops the ticker thread and detaches the cycle hook's
            # flag; the store object itself stays readable (the sigterm
            # bundle above already captured it)
            from .watchtower import disarm_watchtower

            disarm_watchtower(service.scheduler, tsdb_store)
        if blackbox_box is not None:
            from ..core import blackbox as _bb

            _bb.disarm()
        if lease is not None:
            lease.release()
    return 0
