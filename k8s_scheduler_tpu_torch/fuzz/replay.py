"""Trace replay: the live engine vs the trace-semantics oracle (the port
of `k8s_scheduler_tpu/fuzz/replay.py`).

Both sides consume the SAME trace, drive the SAME host bookkeeping
classes (`SchedulingQueue`, `SchedulerCache` — deliberately shared: the
differential isolates the DECISION ENGINE), and advance the same fake
clock. The only thing that differs is who decides: the port's
`Scheduler.schedule_cycle` on the card (K1, K13 and the preemption
kernels K7-K9 at the trace's small shapes; the plain versions with
`device="cpu"`), or `oracle.schedule_cycle_trace`, the port's copy of the
reference's independent sequential oracle.

Per cycle each side records (pending uids, binds, unschedulable+
reasons, nominations, evictions, gang drops, PDB overruns); after each
cycle the harness plays the informer back — bind confirmations
(`on_pod_add(pod, node)`) and eviction deletes (`on_pod_delete`) — and
ticks the clock past the max backoff, so requeued pods return
deterministically. `compare()` asserts the two streams bit-equal, cycle
by cycle.

Standing invariants checked engine-side every cycle (chaos traces,
where faults make the queues legitimately diverge from the oracle's,
keep these as their whole contract):

- no node capacity overcommit (every resource, bound+assumed);
- gang all-or-nothing (placed members + running members >= minMember);
- zero duplicate binds (a uid binds at most once while bound);
- zero lost accepted pods at end of trace (bound, or still in a tier);
- PDB respected (per-cycle overruns recorded and compared with the
  oracle's).

Chaos traces additionally assert the soak invariants: the watchdog
bounds every injected hang, the ladder recovers to rung 0 on the
recovery tail, and (with a state dir) the journal restores to a
digest-identical queue/cache.

Multi-cycle traces (`multi_cycle_k` > 1) compare the flattened streams
with the oracle's. The incremental variant on a multi-cycle trace is the
reference's: admission-time ingest on against off, per-cycle streams and
dispatched arenas equal, staged rows consumed. On a single-cycle trace
(`config["incremental_encode"]` set by hand) the port replays it twice on
the device-carry path — the encoder's delta path (`encode_packed` with its
fold) and every frame a full encode — and requires the decision streams
and the dispatched packed arenas equal. Speculative traces compare the
engine against itself with speculation off (`compare_speculative`).

The arrivals-via-API variant (`replay_engine(via_api=True)`,
`run_api_case`) routes every arrival through the port's gRPC shim on a
localhost channel and compares the stream with direct enqueue's
(`compare_via_api`).

Refused by name, never ignored: sharded traces (A13); tenant traces,
`run_tenant_case` and the `tenant_row_skew` bug (A12).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time as _time

from .. import oracle
from ..internal.cache import SchedulerCache
from ..internal.queue import (
    EVENT_NODE_ADD,
    EVENT_NODE_DELETE,
    EVENT_NODE_UPDATE,
    EVENT_POD_ADD,
    EVENT_POD_DELETE,
    SchedulingQueue,
)
from ..models.api import Pod
from ..ops import preemption as preemption_ops
from .trace import (
    Trace,
    materialize,
    materialize_event,
    trace_from_dict,
    trace_to_dict,
)

_SHARDED = "sharded traces (shardDevices > 1) are not ported yet (ROADMAP A13)"
_TENANT = ("multi-tenant traces and the tenant arena are not ported yet "
           "(ROADMAP A12)")


@dataclasses.dataclass
class Failure:
    """One check that did not hold. `cls` is the failure CLASS the
    shrinker preserves (shrink-to-a-different-bug is a rejected
    reduction); `cycle` anchors truncation; `detail` is human-readable
    and carries the first diverging payloads."""

    cls: str
    cycle: int = -1
    detail: str = ""

    def __str__(self) -> str:
        at = f" at cycle {self.cycle}" if self.cycle >= 0 else ""
        return f"{self.cls}{at}: {self.detail}"


@dataclasses.dataclass
class ReplayResult:
    records: list  # per-cycle dicts
    failures: list  # list[Failure] (invariants; chaos checks)
    binds: list  # flattened [(uid, node), ...] in bind order
    stats: dict

    def stream(self, key: str) -> list:
        return [x for r in self.records for x in r[key]]


def _require_scan_mode(cfgd: dict) -> None:
    """The differential is defined for the SCAN engine only: its
    decisions are exact vs the sequential oracle, and its reject
    attribution is at-turn (oracle.schedule_cycle_trace mirrors that).
    The rounds engine diverges by design (integer rounding, hash
    tie-break) and attributes against the final state — a rounds trace
    here would report phantom divergences, so refuse it loudly."""
    mode = cfgd.get("commit_mode", "scan")
    if mode != "scan":
        raise ValueError(
            f"fuzz replay requires commit_mode='scan', got {mode!r} "
            "(the rounds engine's legal divergences need the "
            "soak_differential-style validity/regret checks, not "
            "bit-equality)"
        )


class _Clock:
    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def tick(self, dt: float) -> None:
        self.t += dt


def _alloc_tol(used: float, alloc: float) -> bool:
    return used > alloc * (1 + 1e-5) + 1e-5


def _capacity_violations(cache: SchedulerCache) -> list[str]:
    by_node: dict[str, dict[str, float]] = {}
    for pod, node in cache.existing_pods():
        agg = by_node.setdefault(node, {})
        for r, v in pod.resource_requests().items():
            agg[r] = agg.get(r, 0.0) + v
    out = []
    nodes = {n.name: n for n in cache.nodes()}
    for name, agg in by_node.items():
        nd = nodes.get(name)
        if nd is None:
            continue  # node deleted out from under its pods (churn)
        for r, v in agg.items():
            if _alloc_tol(v, nd.status.allocatable.get(r, 0.0)):
                out.append(
                    f"node {name}: {r} overcommitted "
                    f"({v} > {nd.status.allocatable.get(r, 0.0)})"
                )
    return out


def _pdb_overruns(pdbs, evicted_pods) -> list[int]:
    """Per-PDB count of this cycle's evictions beyond its budget."""
    out = []
    for pdb in pdbs:
        n = sum(
            1 for p in evicted_pods
            if p.namespace == pdb.namespace
            and oracle.match_label_selector(pdb.selector, p.metadata.labels)
        )
        out.append(max(0, n - pdb.disruptions_allowed))
    return out


def _gang_violations(groups, existing_before, binds, all_pods) -> list[str]:
    """All-or-nothing: any group that placed >=1 member this cycle must
    reach minMember counting members already running."""
    if not groups:
        return []
    running: dict[str, int] = {}
    for pod, _n in existing_before:
        if pod.spec.pod_group:
            running[pod.spec.pod_group] = running.get(pod.spec.pod_group, 0) + 1
    placed: dict[str, int] = {}
    for uid, _node in binds:
        g = all_pods[uid].spec.pod_group if uid in all_pods else ""
        if g:
            placed[g] = placed.get(g, 0) + 1
    out = []
    for g in groups:
        got = placed.get(g.name, 0)
        if got and got + running.get(g.name, 0) < g.min_member:
            out.append(
                f"gang {g.name}: {got} placed + "
                f"{running.get(g.name, 0)} running < minMember "
                f"{g.min_member}"
            )
    return out


def _refuse_unported(cfgd: dict) -> None:
    """Trace variants later slices port: refused by name, never ignored."""
    if cfgd.get("tenancy"):
        raise NotImplementedError(_TENANT)
    if int(cfgd.get("shard_devices", 0)) > 1:
        raise NotImplementedError(_SHARDED)


# --------------------------------------------------------------------------
# engine side
# --------------------------------------------------------------------------


def replay_engine(
    trace: Trace, *, state_dir: str = "", via_api: bool = False,
    carry: bool = False, full_encode: bool = False, device=None,
) -> ReplayResult:
    """Drive the trace through a LIVE port `Scheduler` on `device` (None =
    the card, "cpu" the plain versions). Chaos traces arm the trace's
    FaultPlan for the duration; `state_dir` makes the engine durable.
    `carry` serves the trace on the device-carry path (`commitMode:
    rounds`, the delta encode) in place of its scan, and `full_encode`
    makes every frame a full encode: the incremental variant's two sides,
    compared engine against engine, never against the oracle.

    `via_api` routes every pending-pod arrival through a real gRPC Submit
    round trip and every node add/update/delete through NodeChurn (the
    port's server on a localhost channel, the wire conversion and the
    admission layer) instead of the direct informer calls. Deletions and
    bound-pod confirmations stay direct, the admission depth bound is
    lifted, and the harness still drives `schedule_cycle` itself, so any
    stream difference from the direct engine is the API path's doing."""
    from ..config import SchedulerConfiguration
    from ..core import Scheduler, faults

    cfgd = trace.config
    if not carry:
        _require_scan_mode(cfgd)
    _refuse_unported(cfgd)
    cfg = SchedulerConfiguration(
        commit_mode="rounds" if carry else cfgd.get("commit_mode", "scan"),
        gang_scheduling=bool(cfgd.get("gang_scheduling", True)),
        multi_cycle_k=int(cfgd.get("multi_cycle_k", 1)),
        multi_cycle_max_wait_ms=float(cfgd.get("multi_cycle_max_wait_ms", 1e12)),
        speculative_dispatch=bool(cfgd.get("speculative_dispatch", False)),
        incremental_encode=bool(cfgd.get("incremental_encode", False)),
        shard_devices=int(cfgd.get("shard_devices", 0)),
        dispatch_deadline_ms=float(cfgd.get("dispatch_deadline_ms", 0.0)),
        degrade_promote_cycles=int(cfgd.get("degrade_promote_cycles", 2)),
        fault_spec=trace.fault_spec,
        speculative_compile=False,
        # "off" beats "": with a state dir, "" derives a cache path; the
        # kernels are process-wide, so the harness leaves the process's
        # cache as it is
        compile_cache_dir="off",
        state_dir=state_dir,
        snapshot_interval_seconds=0.0,
    )
    clock = _Clock()
    cycle_binds: list[tuple[Pod, str]] = []
    cycle_evicts: list[tuple[Pod, str]] = []
    state = None
    if state_dir:
        from ..state import DurableState

        state = DurableState(state_dir, snapshot_interval_seconds=0)
    sched = Scheduler(
        config=cfg,
        binder=lambda pod, node: cycle_binds.append((pod, node)),
        evictor=lambda pod, node: cycle_evicts.append((pod, node)),
        now=clock,
        pad_bucket=int(cfgd.get("pad_bucket", 8)),
        state=state,
        device=device,
    )
    # why each full encode of a packed frame was full (the incremental
    # variant's ledger)
    full_reasons: list[str] = []
    for enc in sched._encoders.values():
        if full_encode:
            enc.incremental = False

        def encode_packed(*a, _enc=enc, _orig=enc.encode_packed, **k):
            before = _enc.full_encodes
            out = _orig(*a, **k)
            if _enc.full_encodes != before:
                full_reasons.append(_enc.full_reason)
            return out

        enc.encode_packed = encode_packed

    popped: list[list[str]] = []
    orig_pop = sched.queue.pop_ready

    def pop_capture(hold: bool = False):
        ready = orig_pop(hold)
        popped.append([p.uid for p in ready])
        return ready

    sched.queue.pop_ready = pop_capture
    unsched_log: list[tuple[str, tuple]] = []
    orig_unsched = sched.queue.requeue_unschedulable

    def unsched_capture(pod, reasons=()):
        r = (reasons,) if isinstance(reasons, str) else tuple(reasons)
        unsched_log.append((pod.uid, r))
        return orig_unsched(pod, reasons=reasons)

    sched.queue.requeue_unschedulable = unsched_capture
    backoff_log: list[tuple[str, str]] = []
    orig_backoff = sched.queue.requeue_backoff

    def backoff_capture(pod, event="BindError"):
        backoff_log.append((pod.uid, event))
        return orig_backoff(pod, event=event)

    sched.queue.requeue_backoff = backoff_capture

    api_server = None
    api_client = None
    if via_api:
        from concurrent import futures as _futures

        import grpc as _grpc

        from ..service.client import SchedulerClient
        from ..service.server import SchedulerService, add_to_server

        svc = SchedulerService(scheduler=sched)
        # the servicer rebinds the binder to its Cycle collector; the
        # replay's capture binder must win (the harness never calls Cycle)
        sched.binder = lambda pod, node: cycle_binds.append((pod, node))
        svc.enable_front_door(queue_depth=0)
        api_server = _grpc.server(_futures.ThreadPoolExecutor(max_workers=2),
                                  options=(("grpc.so_reuseport", 0),))
        add_to_server(svc, api_server)
        api_port = api_server.add_insecure_port("127.0.0.1:0")
        api_server.start()
        api_client = SchedulerClient(f"127.0.0.1:{api_port}")

    objs = materialize(trace)
    pdbs = objs["pdbs"]
    groups = objs["pod_groups"]
    for nd in objs["nodes"]:
        sched.on_node_add(nd)
    for g in groups:
        sched.add_pod_group(g)
    for c in objs["pvcs"]:
        sched.on_pvc_upsert(c)
    for v in objs["pvs"]:
        sched.on_pv_upsert(v)
    for s in objs["storage_classes"]:
        sched.on_storage_class_upsert(s)
    for p in pdbs:
        sched.on_pdb_upsert(p)

    records: list[dict] = []
    failures: list[Failure] = []
    all_binds: list[tuple[str, str]] = []
    all_pods: dict[str, Pod] = {}
    added: set[str] = set()
    deleted: set[str] = set()
    evicted: set[str] = set()
    bound_now: set[str] = set()
    walls: dict[int, float] = {}
    try:
        for ci, events in enumerate(trace.cycles):
            for raw in events:
                ev = materialize_event(raw)
                op = ev["op"]
                if op == "add_pod":
                    all_pods[ev["pod"].uid] = ev["pod"]
                    added.add(ev["pod"].uid)
                    if api_client is not None:
                        _api_submit(api_client, ev["pod"], ci, failures, sched)
                    else:
                        sched.on_pod_add(ev["pod"])
                elif op == "add_bound_pod":
                    all_pods[ev["pod"].uid] = ev["pod"]
                    added.add(ev["pod"].uid)
                    bound_now.add(ev["pod"].uid)
                    sched.on_pod_add(ev["pod"], ev["bind_node"])
                elif op == "delete_pod":
                    deleted.add(ev["uid"])
                    bound_now.discard(ev["uid"])
                    sched.on_pod_delete(ev["uid"])
                elif op == "add_node":
                    if api_client is not None:
                        api_client.node_churn(adds=[ev["node"]])
                    else:
                        sched.on_node_add(ev["node"])
                elif op == "update_node":
                    if api_client is not None:
                        api_client.node_churn(updates=[ev["node"]])
                    else:
                        sched.on_node_update(ev["node"])
                elif op == "delete_node":
                    if api_client is not None:
                        api_client.node_churn(deletes=[ev["name"]])
                    else:
                        sched.on_node_delete(ev["name"])
                else:
                    raise ValueError(f"unknown trace op {op!r}")
            existing_before = sched.cache.existing_pods()
            cycle_binds.clear()
            cycle_evicts.clear()
            unsched_log.clear()
            backoff_log.clear()
            n_pops_before = len(popped)
            t_wall = _time.perf_counter()
            sched.schedule_cycle()
            walls[ci + 1] = _time.perf_counter() - t_wall

            binds = [(p.uid, n) for p, n in cycle_binds]
            for uid, node in binds:
                if uid in bound_now:
                    failures.append(Failure(
                        "invariant/duplicate_bind", ci,
                        f"{uid} bound again (-> {node}) while bound",
                    ))
                bound_now.add(uid)
            evs = [(p.uid, n) for p, n in cycle_evicts]
            noms = [(p.uid, n) for p, n in sched.last_nominations]
            pend = [u for lst in popped[n_pops_before:] for u in lst]
            records.append({
                "cycle": ci,
                "pending": pend,
                "binds": binds,
                "unschedulable": list(unsched_log),
                "nominated": noms,
                "evicted": [u for u, _n in evs],
                "gang_dropped": sorted(
                    u for u, r in unsched_log if r == ("Coscheduling",)
                ),
                "pdb_overruns": _pdb_overruns(
                    pdbs, [p for p, _n in cycle_evicts]
                ),
                "requeues": list(backoff_log),
                "rung": sched.ladder.rung,
            })
            all_binds.extend(binds)
            for msg in _capacity_violations(sched.cache):
                failures.append(Failure("invariant/capacity", ci, msg))
            for msg in _gang_violations(
                groups, existing_before, binds, all_pods
            ):
                failures.append(Failure("invariant/gang", ci, msg))

            # informer playback: bind confirmations + eviction deletes
            for pod, node in cycle_binds:
                sched.on_pod_add(pod, node)
            for pod, _node in cycle_evicts:
                evicted.add(pod.uid)
                bound_now.discard(pod.uid)
                sched.on_pod_delete(pod.uid)
            clock.tick(trace.tick_s)

        # ---- end-of-trace accounting ----
        tracked = {p.uid for p in sched.queue.all_pending()}
        tracked |= {p.uid for p, _n in sched.cache.existing_pods()}
        lost = sorted(added - deleted - evicted - tracked)
        if lost:
            failures.append(Failure(
                "invariant/lost_pods", len(trace.cycles) - 1,
                f"accepted pods neither bound nor queued: {lost[:6]}",
            ))
        if trace.chaos:
            failures.extend(_chaos_checks(trace, sched, walls, state_dir))
        encs = list(sched._encoders.values())
        stats = {
            "bound": len(all_binds),
            "added": len(added),
            "degradations": sched.ladder.degradations,
            "final_rung": sched.ladder.rung,
            "fired_points": sorted(
                faults.plan().fired_points()
            ) if faults.plan() is not None else [],
            # the encoders' paths: the incremental variant asserts the
            # delta path actually ran
            # depth-2 speculation outcomes (all zero without
            # speculativeDispatch): the variant asserts the path ran
            "speculation": sched.speculation_ledger(),
            # admission-time ingest (the multi-cycle incremental variant)
            "ingest": {"hits": sum(int(e.ingest_hits) for e in encs),
                       "misses": sum(int(e.ingest_misses) for e in encs)},
            "encode": {
                "full": sum(int(e.full_encodes) for e in encs),
                "delta": sum(int(e.delta_hits) for e in encs),
                "fold": sum(int(e.fold_hits) for e in encs),
                "ingest_hits": sum(int(e.ingest_hits) for e in encs),
                "full_reasons": sorted(set(full_reasons)),
            },
        }
    finally:
        faults.disarm()
        if api_client is not None:
            with contextlib.suppress(Exception):
                api_client.close()
        if api_server is not None:
            with contextlib.suppress(Exception):
                api_server.stop(grace=0)
        if state is not None:
            with contextlib.suppress(Exception):
                state.journal.flush()
            with contextlib.suppress(Exception):
                state.journal.close()
    return ReplayResult(records, failures, all_binds, stats)


def _api_submit(client, pod, cycle: int, failures: list, sched) -> None:
    """One Submit round trip; a rejection is recorded as a failure (the
    unbounded front door must accept every generated arrival) and the pod
    falls back to direct enqueue so the stream comparison still runs."""
    import grpc as _grpc

    try:
        client.submit([pod])
    except _grpc.RpcError as e:
        failures.append(Failure(
            "via_api/rejected", cycle,
            f"Submit({pod.uid}) -> {e.code().name}: {e.details()}",
        ))
        sched.on_pod_add(pod)


def _chaos_checks(trace, sched, walls, state_dir) -> list[Failure]:
    """The PR 8 soak invariants, asserted on a chaos replay: watchdog
    bound held, ladder recovered on the tail, digest-verified restore."""
    import re

    from ..core import faults

    out: list[Failure] = []
    deadline_ms = float(trace.config.get("dispatch_deadline_ms", 0.0))
    plan = faults.plan()
    hang_fired = plan is not None and "fetch_hang" in plan.fired_points()
    for m in re.finditer(
        r"fetch_hang@cycle=(\d+)[^;]*?ms=([0-9.]+)", trace.fault_spec
    ):
        cyc, hang_ms = int(m.group(1)), float(m.group(2))
        if not (hang_fired and deadline_ms and hang_ms > 2 * deadline_ms):
            continue
        # two-part watchdog proof, robust to in-cycle compile cost (a
        # retrace recovery can legally spend seconds rebuilding programs
        # in the same host cycle): (a) the loop never slept the full
        # hang; (b) the ladder recorded a deadline-classified step —
        # the watchdog, not the hang expiring, ended the fetch
        wall = walls.get(cyc, 0.0) * 1e3
        if wall >= hang_ms:
            out.append(Failure(
                "chaos/watchdog", cyc,
                f"serve loop blocked {wall:.0f}ms >= the injected "
                f"{hang_ms:.0f}ms hang (deadline {deadline_ms:.0f}ms)",
            ))
        if not any(
            e["reason"].startswith("deadline")
            for e in sched.ladder.transitions
        ):
            out.append(Failure(
                "chaos/watchdog", cyc,
                "fetch_hang fired but no deadline-classified ladder "
                "step was recorded — the watchdog never expired the "
                "fetch",
            ))
    if sched.ladder.rung != sched.ladder.floor:
        out.append(Failure(
            "chaos/ladder", len(trace.cycles) - 1,
            f"ladder never recovered: rung {sched.ladder.rung} "
            f"(floor {sched.ladder.floor}) after the recovery tail",
        ))
    if state_dir:
        from ..state import DurableState, state_digest

        with contextlib.suppress(Exception):
            sched.state.journal.flush()
        live = state_digest(sched.queue, sched.cache)
        q2 = SchedulingQueue()
        c2 = SchedulerCache()
        st2 = DurableState(state_dir, snapshot_interval_seconds=0)
        try:
            st2.restore_into(q2, c2)
            restored = state_digest(q2, c2)
        finally:
            with contextlib.suppress(Exception):
                st2.journal.close()
        if restored != live:
            out.append(Failure(
                "chaos/digest", len(trace.cycles) - 1,
                "journal restore digest != live queue/cache digest",
            ))
    return out


# --------------------------------------------------------------------------
# oracle side
# --------------------------------------------------------------------------


def replay_oracle(trace: Trace) -> ReplayResult:
    """Drive the trace through the sequential oracle under IDENTICAL
    host bookkeeping: same queue/cache classes, same informer playback,
    same clock ticks — so any stream difference is the decision
    engine's."""
    _require_scan_mode(trace.config)
    clock = _Clock()
    queue = SchedulingQueue(
        initial_backoff_seconds=1.0, max_backoff_seconds=10.0, now=clock
    )
    cache = SchedulerCache(now=clock)
    objs = materialize(trace)
    pdbs = objs["pdbs"]
    groups = objs["pod_groups"]
    pvcs = {c.key: c for c in objs["pvcs"]}
    pvs = {v.name: v for v in objs["pvs"]}
    classes = {s.name: s for s in objs["storage_classes"]}
    for nd in objs["nodes"]:
        cache.add_node(nd)
    gang = bool(trace.config.get("gang_scheduling", True))

    records: list[dict] = []
    failures: list[Failure] = []
    all_binds: list[tuple[str, str]] = []
    all_pods: dict[str, Pod] = {}
    added: set[str] = set()
    deleted: set[str] = set()
    evicted: set[str] = set()

    def informer_bound(pod: Pod, node: str) -> None:
        queue.delete(pod.uid)
        cache.add_pod(pod, node)
        queue.move_all_to_active_or_backoff(EVENT_POD_ADD)

    def informer_delete(uid: str) -> None:
        cache.remove_pod(uid)
        queue.delete(uid)
        queue.move_all_to_active_or_backoff(EVENT_POD_DELETE)

    for ci, events in enumerate(trace.cycles):
        for raw in events:
            ev = materialize_event(raw)
            op = ev["op"]
            if op == "add_pod":
                all_pods[ev["pod"].uid] = ev["pod"]
                added.add(ev["pod"].uid)
                queue.add(ev["pod"])
            elif op == "add_bound_pod":
                all_pods[ev["pod"].uid] = ev["pod"]
                added.add(ev["pod"].uid)
                informer_bound(ev["pod"], ev["bind_node"])
            elif op == "delete_pod":
                deleted.add(ev["uid"])
                informer_delete(ev["uid"])
            elif op == "add_node":
                cache.add_node(ev["node"])
                queue.move_all_to_active_or_backoff(EVENT_NODE_ADD)
            elif op == "update_node":
                cache.update_node(ev["node"])
                queue.move_all_to_active_or_backoff(EVENT_NODE_UPDATE)
            elif op == "delete_node":
                cache.remove_node(ev["name"])
                queue.move_all_to_active_or_backoff(EVENT_NODE_DELETE)
            else:
                raise ValueError(f"unknown trace op {op!r}")

        # the cycle, mirroring Scheduler.schedule_cycle's host order
        for pod, _node in cache.cleanup_expired():
            queue.requeue_backoff(pod, event="AssumeExpired")
        queue.flush_unschedulable_timeout()
        pending = queue.pop_ready()
        rec = {
            "cycle": ci, "pending": [p.uid for p in pending],
            "binds": [], "unschedulable": [], "nominated": [],
            "evicted": [], "gang_dropped": [], "pdb_overruns":
            [0] * len(pdbs), "requeues": [], "rung": 0,
        }
        cycle_binds: list[tuple[Pod, str]] = []
        cycle_evicts: list[Pod] = []
        if pending:
            nodes = cache.nodes()
            existing = cache.existing_pods()
            out = oracle.schedule_cycle_trace(
                nodes, pending, existing,
                pod_groups=groups, pvcs=list(pvcs.values()),
                pvs=list(pvs.values()),
                storage_classes=list(classes.values()),
                pdbs=pdbs, gang_scheduling=gang,
                budget=preemption_ops.DEFAULT_BUDGET,
                scan_budget=preemption_ops.DEFAULT_SCAN_BUDGET,
            )
            # winners bind in pending order (the engine's apply order)
            for i, pod in enumerate(pending):
                ni = out.decisions[i].node_index
                if ni < 0:
                    continue
                node = nodes[ni].name
                cache.assume(pod, node)
                cache.finish_binding(pod.uid)
                rec["binds"].append((pod.uid, node))
                cycle_binds.append((pod, node))
            nominated = {o.pod_index: o.node_index for o in out.preemptions}
            for i, pod in enumerate(pending):
                if out.decisions[i].node_index >= 0:
                    continue
                if i in nominated:
                    pod.nominated_node_name = nodes[nominated[i]].name
                    rec["nominated"].append(
                        (pod.uid, pod.nominated_node_name)
                    )
                reasons = out.reasons.get(i, ())
                rec["unschedulable"].append((pod.uid, tuple(reasons)))
                queue.requeue_unschedulable(pod, reasons=reasons)
            vict: set[int] = set()
            for o in out.preemptions:
                vict.update(o.victims)
            for e in sorted(vict):
                vpod = existing[e][0]
                rec["evicted"].append(vpod.uid)
                cycle_evicts.append(vpod)
            rec["gang_dropped"] = sorted(
                pending[i].uid for i in out.dropped
            )
            rec["pdb_overruns"] = _pdb_overruns(pdbs, cycle_evicts)
        records.append(rec)
        all_binds.extend(rec["binds"])
        for pod, node in cycle_binds:
            informer_bound(pod, node)
        for vpod in cycle_evicts:
            evicted.add(vpod.uid)
            informer_delete(vpod.uid)
        clock.tick(trace.tick_s)

    tracked = {p.uid for p in queue.all_pending()}
    tracked |= {p.uid for p, _n in cache.existing_pods()}
    lost = sorted(added - deleted - evicted - tracked)
    if lost:
        failures.append(Failure(
            "invariant/lost_pods", len(trace.cycles) - 1,
            f"oracle-side accepted pods neither bound nor queued: "
            f"{lost[:6]}",
        ))
    for msg in _capacity_violations(cache):
        failures.append(Failure(
            "invariant/capacity", len(trace.cycles) - 1,
            f"oracle-side {msg}",
        ))
    return ReplayResult(
        records, failures, all_binds, {"bound": len(all_binds)}
    )


# --------------------------------------------------------------------------
# comparison + the one-call driver
# --------------------------------------------------------------------------

_PER_CYCLE_KEYS = (
    "pending", "binds", "unschedulable", "nominated", "evicted",
    "gang_dropped", "pdb_overruns",
)


def compare(trace: Trace, eng: ReplayResult, orc: ReplayResult) -> list[Failure]:
    """Bit-equality of the two decision streams. Single-cycle serving
    compares cycle by cycle (first diverging cycle + field named);
    multi-cycle serving compares the flattened streams — coalescing moves
    WHEN outcomes land (to the flush cycle), never what they are or their
    order."""
    out: list[Failure] = []
    if int(trace.config.get("multi_cycle_k", 1)) <= 1:
        for er, orr in zip(eng.records, orc.records):
            for key in _PER_CYCLE_KEYS:
                if er[key] != orr[key]:
                    out.append(Failure(
                        f"divergence/{key}", er["cycle"],
                        f"engine={er[key]!r} oracle={orr[key]!r}",
                    ))
            if out:
                return out
        return out
    for key in ("binds", "unschedulable", "nominated", "evicted", "gang_dropped"):
        e, o = eng.stream(key), orc.stream(key)
        if key == "gang_dropped":
            # sorted per record, and a flush record merges K inner cycles:
            # compare the multiset (the ordered truth rides the
            # unschedulable stream)
            e, o = sorted(e), sorted(o)
        if e != o:
            i = next((j for j, (a, b) in enumerate(zip(e, o)) if a != b),
                     min(len(e), len(o)))
            out.append(Failure(
                f"divergence/{key}", -1,
                f"stream differs from element {i}: engine={e[i:i+3]!r} "
                f"oracle={o[i:i+3]!r} (lengths {len(e)}/{len(o)})",
            ))
            return out
    return out


def compare_incremental(
    eng_on: ReplayResult, eng_off: ReplayResult
) -> list[Failure]:
    """Per-cycle bit-equality of the incremental-encode engine against
    the rebuild engine (every frame a full encode) on the same trace. This
    — not the oracle — is the delta path's contract: it must not change
    WHAT is encoded or decided, only what the encode costs. The
    dispatched packed arenas are additionally compared byte for byte by
    run_case via _capture_arenas — the decision streams could mask a
    compensating arena difference, the arena bytes cannot."""
    out: list[Failure] = []
    for er, orr in zip(eng_on.records, eng_off.records):
        for key in _PER_CYCLE_KEYS + ("requeues", "rung"):
            if er[key] != orr[key]:
                out.append(Failure(
                    f"incremental/{key}", er["cycle"],
                    f"inc-on={er[key]!r} inc-off={orr[key]!r}",
                ))
        if out:
            return out
    return out


@contextlib.contextmanager
def _capture_arenas(out: list):
    """Record the packed-arena bytes of every dispatch issued inside the
    scope: `out` collects `(kind, words_bytes, bytes_bytes)` tuples in
    dispatch order, copied to the host as they were uploaded. Class-level
    patch — replays are sequential, and the finally-restore keeps it
    scoped."""
    import numpy as _np

    from ..core.pipeline import ServingPipeline

    orig_d = ServingPipeline.dispatch
    orig_m = ServingPipeline.dispatch_multi

    def host_bytes(buf) -> bytes:
        a = _np.asarray(buf.cpu() if hasattr(buf, "cpu") else buf)
        return a.view(_np.uint8).tobytes()

    def dispatch(self, wbuf, bbuf, *a, **kw):
        out.append(("1", host_bytes(wbuf), host_bytes(bbuf)))
        return orig_d(self, wbuf, bbuf, *a, **kw)

    def dispatch_multi(self, wbufs, bbufs, *a, **kw):
        out.append(("K", host_bytes(wbufs), host_bytes(bbufs)))
        return orig_m(self, wbufs, bbufs, *a, **kw)

    ServingPipeline.dispatch = dispatch
    ServingPipeline.dispatch_multi = dispatch_multi
    try:
        yield
    finally:
        ServingPipeline.dispatch = orig_d
        ServingPipeline.dispatch_multi = orig_m


def compare_speculative(eng_on: ReplayResult, eng_off: ReplayResult) -> list[Failure]:
    """Per-cycle bit-equality of the speculative engine against the
    non-speculative engine on the same trace: adoption and abandonment
    must not change what is decided, when it lands, or in what order (the
    two share the batching cadence, so even cycle placement must match)."""
    out: list[Failure] = []
    for er, orr in zip(eng_on.records, eng_off.records):
        for key in _PER_CYCLE_KEYS + ("requeues", "rung"):
            if er[key] != orr[key]:
                out.append(Failure(
                    f"speculation/{key}", er["cycle"],
                    f"spec-on={er[key]!r} spec-off={orr[key]!r}",
                ))
        if out:
            return out
    return out


def compare_via_api(eng_api: ReplayResult, eng_direct: ReplayResult) -> list[Failure]:
    """Per-cycle bit-equality of the arrivals-via-API engine against the
    direct-enqueue engine on the same trace. Both share the exact cadence
    (same trace, same K, same frozen clock), so even cycle placement must
    match: any difference is the Submit / NodeChurn path perturbing state
    (conversion loss, ordering drift, admission side effects)."""
    out: list[Failure] = []
    for er, orr in zip(eng_api.records, eng_direct.records):
        for key in _PER_CYCLE_KEYS + ("requeues", "rung"):
            if er[key] != orr[key]:
                out.append(Failure(
                    f"via_api/{key}", er["cycle"],
                    f"via-api={er[key]!r} direct={orr[key]!r}",
                ))
        if out:
            return out
    return out


def run_api_case(trace: Trace, *, device=None) -> list[Failure]:
    """The arrivals-via-API variant: replay the trace with every arrival
    through real Submit / NodeChurn RPCs, then again with direct enqueue,
    and require bit-equal streams (engine bugs cancel out; this variant
    hunts API-path bugs)."""
    eng_api = replay_engine(trace, via_api=True, device=device)
    failures = list(eng_api.failures)
    eng_direct = replay_engine(trace, device=device)
    failures.extend(eng_direct.failures)
    failures.extend(compare_via_api(eng_api, eng_direct))
    return failures


def run_tenant_case(trace: Trace, *, bug: "str | None" = None) -> list[Failure]:
    """Refused: the tenant arena and its differential are ROADMAP A12."""
    raise NotImplementedError(_TENANT)


def run_case(
    trace: Trace, *, state_dir: str = "", bug: "str | None" = None, device=None,
) -> list[Failure]:
    """Replay one trace end to end on `device` and return every failure:
    engine invariants (+ chaos checks), oracle invariants, and — for plain
    traces — the differential divergences. `bug` injects a deliberate
    engine mutation (see `engine_bug`) for harness self-tests.

    Incremental traces (`config["incremental_encode"]` on a single-cycle
    trace) compare the engine against ITSELF with every frame a full
    encode (compare_incremental), and additionally require the dispatched
    packed arenas byte-identical, the rebuild side all full encodes and the
    delta path never switched off — a variant that silently fell back to
    full encodes would otherwise be a permanent green (a frame the encoder
    finds structurally ineligible, `full_reason`, is no fault). The port's
    one incremental encode at K = 1 is the device-carry path's delta
    encode, so both sides serve on that path.

    On a multi-cycle trace the incremental variant is the reference's:
    admission-time ingest on against off (same cadence), per-cycle streams
    and dispatched arenas equal, staged rows consumed at flush. Speculative
    traces compare the engine against itself with speculation off and fail
    when nothing was speculated. Tenant and sharded traces are refused by
    name."""
    if trace.config.get("tenancy"):
        return run_tenant_case(trace, bug=bug)
    _refuse_unported(trace.config)
    multi = int(trace.config.get("multi_cycle_k", 1)) > 1
    inc = bool(trace.config.get("incremental_encode")) and not trace.chaos
    arenas_on: list = []
    cap = _capture_arenas(arenas_on) if inc else contextlib.nullcontext()
    with engine_bug(bug), cap:
        eng = replay_engine(trace, state_dir=state_dir, carry=inc and not multi,
                            device=device)
    failures = list(eng.failures)
    if trace.chaos:
        return failures
    if inc and multi:
        off = trace_from_dict(trace_to_dict(trace))
        off.config["incremental_encode"] = False
        arenas_off: list = []
        with engine_bug(bug), _capture_arenas(arenas_off):
            eng_off = replay_engine(off, device=device)
        failures.extend(eng_off.failures)
        failures.extend(compare_incremental(eng, eng_off))
        if arenas_on != arenas_off:
            i = next((j for j, (a, b) in enumerate(zip(arenas_on, arenas_off)) if a != b),
                     min(len(arenas_on), len(arenas_off)))
            failures.append(Failure(
                "incremental/arena", -1,
                f"dispatched packed arenas diverge at dispatch {i} "
                f"(counts {len(arenas_on)}/{len(arenas_off)})"))
        ing = eng.stats.get("ingest", {})
        if not ing.get("hits", 0):
            failures.append(Failure(
                "incremental/never_exercised", -1,
                f"incrementalEncode trace consumed no staged row at flush (ledger {ing})"))
        return failures
    if trace.config.get("speculative_dispatch"):
        off = trace_from_dict(trace_to_dict(trace))
        off.config["speculative_dispatch"] = False
        with engine_bug(bug):
            eng_off = replay_engine(off, device=device)
        failures.extend(eng_off.failures)
        failures.extend(compare_speculative(eng, eng_off))
        led = eng.stats.get("speculation", {})
        if not (led.get("adopted", 0) + led.get("abandoned", 0)):
            failures.append(Failure(
                "speculation/never_exercised", -1,
                f"speculativeDispatch trace dispatched no speculative batch (ledger {led})"))
        return failures
    if inc:
        off = trace_from_dict(trace_to_dict(trace))
        arenas_off: list = []
        with engine_bug(bug), _capture_arenas(arenas_off):
            eng_off = replay_engine(off, carry=True, full_encode=True, device=device)
        failures.extend(eng_off.failures)
        failures.extend(compare_incremental(eng, eng_off))
        if arenas_on != arenas_off:
            i = next(
                (j for j, (a, b) in enumerate(zip(arenas_on, arenas_off))
                 if a != b),
                min(len(arenas_on), len(arenas_off)),
            )
            failures.append(Failure(
                "incremental/arena", -1,
                f"dispatched packed arenas diverge at dispatch {i} "
                f"(counts {len(arenas_on)}/{len(arenas_off)})",
            ))
        # at K = 1 a trace whose every frame is structurally ineligible
        # (a pad flip, node churn: the encoder's full_reason) takes no delta
        # frame by design; what must never happen is the variant silently
        # serving without its switch, or the rebuild side taking a delta
        led = eng.stats.get("encode", {})
        if (not (led.get("delta", 0) + led.get("fold", 0))
                and "incremental encode off" in led.get("full_reasons", ())):
            failures.append(Failure(
                "incremental/never_exercised", -1,
                f"incremental trace served with the delta path off (ledger {led})",
            ))
        led_off = eng_off.stats.get("encode", {})
        if led_off.get("delta", 0) + led_off.get("fold", 0):
            failures.append(Failure(
                "incremental/rebuild_took_delta", -1,
                f"the rebuild side took a delta or fold frame (ledger {led_off})",
            ))
        return failures
    orc = replay_oracle(trace)
    failures.extend(orc.failures)
    failures.extend(compare(trace, eng, orc))
    return failures


@contextlib.contextmanager
def engine_bug(name: "str | None"):
    """Deliberately break the ENGINE (never the oracle) for harness
    self-tests: the fuzzer must CATCH a seeded bug.

    - `tiebreak`: flip the claim-path tie-break from first-max to LAST-max,
      as the reference does by swapping `ops/argsel.argmax_first`. The
      plain versions take the patched `argsel.argmax_first` (the scan's
      `ops/commit.py greedy_commit`, the preemption claim's
      `ops/preemption.py claim_loop_plain`, as in the reference, whose swap
      reaches both programs); on the card the scan launches K13's last-max
      instance and the preemption claim K9's (`kernel_build.TIE_LAST`,
      `HARNESS_KERNELS`), which exist for this harness alone.
    - `tenant_row_skew` is refused by name (ROADMAP A12).

    Program closures are per-Scheduler and kernels are chosen at each
    launch; callers must not reuse a Scheduler across the boundary —
    run_case never does."""
    if name is None:
        yield
        return
    if name == "tenant_row_skew":
        raise NotImplementedError(_TENANT)
    if name != "tiebreak":
        raise ValueError(f"unknown engine bug {name!r}")
    import torch

    from ..ops import argsel, kernel_build

    orig = argsel.argmax_first

    def argmax_last(x, dim: int = -1):
        dim = dim % x.ndim
        m = torch.amax(x, dim=dim, keepdim=True)
        shape = [1] * x.ndim
        shape[dim] = x.shape[dim]
        idx = torch.arange(x.shape[dim], dtype=torch.int32, device=x.device).view(shape)
        return torch.amax(torch.where(x == m, idx, torch.full_like(idx, -1)), dim=dim)

    argsel.argmax_first = argmax_last
    kernel_build.TIE_LAST = True
    try:
        yield
    finally:
        argsel.argmax_first = orig
        kernel_build.TIE_LAST = False
