"""Cluster-trace model + seeded generator (the port's copy of
`k8s_scheduler_tpu/fuzz/trace.py`: the same traces for the same seed and
kwargs, over the port's `state/codec.py`).

A trace is PLAIN DATA (JSON-able end to end): the scheduler config
knobs, the initial cluster objects, and per-cycle event lists. Both
replay sides (`replay.py`) materialize their OWN `Pod`/`Node` objects
from it — the live engine mutates pods in place (nominated_node_name),
so sharing objects across sides would leak decisions between them, and
plain data is what the shrinker (`shrink.py`) and the committed corpus
format (`corpus.py`) operate on.

Pod/node payloads reuse the journal codec (`state/codec.py`
pod_to_state / node_to_state) — one serialization dialect for the whole
repo; the volume/PDB/group objects get small local codecs in the same
style.

Every draw comes from ONE `random.Random(seed)`, so a trace is fully
reproducible from its seed + the generator kwargs — the reproducibility
stamp every failure artifact carries (see scripts/fuzz_scheduler.py).
"""

from __future__ import annotations

import dataclasses
import json
import random
from typing import Any

from ..models import api
from ..models.api import (
    LabelSelector,
    PersistentVolume,
    PersistentVolumeClaim,
    PodDisruptionBudget,
    PodGroup,
    StorageClass,
)
from ..models.builders import MakeNode, MakePod
from ..state.codec import (
    _lsel_from,
    _lsel_to,
    _term_from,
    _term_to,
    node_from_state,
    node_to_state,
    pod_from_state,
    pod_to_state,
)

TRACE_VERSION = 1

ZONES = ("zone-a", "zone-b", "zone-c")
NODE_TYPES = ("general", "compute", "memory")
APPS = tuple(f"app-{i}" for i in range(8))


@dataclasses.dataclass
class Trace:
    """One reproducible scenario: config + initial objects + cycles.

    `cycles` is a list of per-cycle EVENT lists; each event is a dict
    with an `op` key (`add_pod`, `add_bound_pod`, `delete_pod`,
    `add_node`, `update_node`, `delete_node`) delivered to the informer
    handlers before that cycle's `schedule_cycle()`. `chaos` traces
    carry a `fault_spec` (core/faults.py grammar) armed on the ENGINE
    side only — they are checked against the standing invariants, not
    the oracle (faults make the two queues legitimately diverge)."""

    seed: int
    config: dict
    nodes: list  # initial nodes (codec dicts)
    pod_groups: list
    pvcs: list
    pvs: list
    storage_classes: list
    pdbs: list
    cycles: list  # list[list[event dict]]
    fault_spec: str = ""
    tick_s: float = 16.0  # > podMaxBackoffSeconds: every backoff expires
    version: int = TRACE_VERSION

    @property
    def chaos(self) -> bool:
        return bool(self.fault_spec)


# --------------------------------------------------------------------------
# (de)serialization — small codecs for the objects state/codec.py lacks
# --------------------------------------------------------------------------


def _pvc_to(c: PersistentVolumeClaim) -> dict:
    return {
        "n": c.name, "ns": c.namespace, "sc": c.storage_class,
        "req": c.request, "vn": c.volume_name,
    }


def _pvc_from(d: dict) -> PersistentVolumeClaim:
    return PersistentVolumeClaim(
        d["n"], namespace=d.get("ns", "default"),
        storage_class=d.get("sc", ""), request=float(d.get("req", 0.0)),
        volume_name=d.get("vn", ""),
    )


def _pv_to(v: PersistentVolume) -> dict:
    return {
        "n": v.name, "cap": v.capacity, "sc": v.storage_class,
        "na": [_term_to(t) for t in v.node_affinity],
        "cr": v.claim_ref,
    }


def _pv_from(d: dict) -> PersistentVolume:
    return PersistentVolume(
        d["n"], capacity=float(d.get("cap", 0.0)),
        storage_class=d.get("sc", ""),
        node_affinity=tuple(_term_from(t) for t in d.get("na", ())),
        claim_ref=d.get("cr", ""),
    )


def _sc_to(s: StorageClass) -> dict:
    return {
        "n": s.name, "m": s.volume_binding_mode, "p": s.provisioner,
        "at": [_term_to(t) for t in s.allowed_topologies],
    }


def _sc_from(d: dict) -> StorageClass:
    return StorageClass(
        d["n"], volume_binding_mode=d.get("m", api.VOLUME_BINDING_IMMEDIATE),
        provisioner=bool(d.get("p", True)),
        allowed_topologies=tuple(_term_from(t) for t in d.get("at", ())),
    )


def _pdb_to(p: PodDisruptionBudget) -> dict:
    return {
        "n": p.name, "ns": p.namespace, "s": _lsel_to(p.selector),
        "da": p.disruptions_allowed,
    }


def _pdb_from(d: dict) -> PodDisruptionBudget:
    return PodDisruptionBudget(
        d["n"], namespace=d.get("ns", "default"),
        selector=_lsel_from(d.get("s", {})),
        disruptions_allowed=int(d.get("da", 0)),
    )


def trace_to_dict(t: Trace) -> dict:
    return dataclasses.asdict(t)


def trace_from_dict(d: dict) -> Trace:
    if int(d.get("version", 1)) != TRACE_VERSION:
        raise ValueError(
            f"trace version {d.get('version')!r} != {TRACE_VERSION}"
        )
    return Trace(**{
        f.name: d[f.name]
        for f in dataclasses.fields(Trace)
        if f.name in d
    })


def save_trace(path: str, t: Trace) -> None:
    with open(path, "w") as f:
        json.dump(trace_to_dict(t), f, indent=1, sort_keys=True)


def load_trace(path: str) -> Trace:
    with open(path) as f:
        return trace_from_dict(json.load(f))


def materialize(t: Trace) -> dict:
    """Fresh API objects for ONE replay side (never share across
    sides: the engine mutates pods in place)."""
    return {
        "nodes": [node_from_state(d) for d in t.nodes],
        "pod_groups": [PodGroup(g["n"], int(g["mm"])) for g in t.pod_groups],
        "pvcs": [_pvc_from(d) for d in t.pvcs],
        "pvs": [_pv_from(d) for d in t.pvs],
        "storage_classes": [_sc_from(d) for d in t.storage_classes],
        "pdbs": [_pdb_from(d) for d in t.pdbs],
    }


def materialize_event(ev: dict) -> dict:
    """Decode one event's payload into fresh objects."""
    out: dict[str, Any] = {"op": ev["op"]}
    if "pod" in ev:
        out["pod"] = pod_from_state(ev["pod"])
    if "node" in ev:
        out["node"] = node_from_state(ev["node"])
    for k in ("uid", "name", "bind_node"):
        if k in ev:
            out[k] = ev[k]
    return out


# --------------------------------------------------------------------------
# the generator
# --------------------------------------------------------------------------


def _gen_node(rng: random.Random, name: str, *, uniform: bool,
              taint_p: float) -> dict:
    if uniform:
        cpu, mem = 8, 16
    else:
        cpu = rng.choice((4, 8))
        mem = rng.choice((8, 16))
    b = MakeNode(name).capacity(
        {"cpu": str(cpu), "memory": f"{mem}Gi", "pods": 110}
    ).labels({
        "topology.kubernetes.io/zone": rng.choice(ZONES),
        "node-type": rng.choice(NODE_TYPES),
    })
    if rng.random() < taint_p:
        b.taint("dedicated", "special")
    return node_to_state(b.obj())


def _gen_pod(
    rng: random.Random,
    name: str,
    created: float,
    *,
    groups: list,
    claims: list,
    churn_ok: bool,
    heavy: bool = False,
    flat_priority: bool = False,
    envelope_only: bool = False,
) -> dict:
    app = rng.choice(APPS)
    if heavy:
        cpu_m = rng.choice((2000, 3000, 4000))
    else:
        cpu_m = rng.choice((250, 500, 1000))
    if flat_priority:
        # uniform priorities make preemption structurally impossible
        # (no victim can rank below a preemptor) — multi-cycle traces
        # need that, see generate_trace
        pri = 0
    else:
        pri = rng.choice((0, 0, 5, 10)) if not heavy else 100
    b = (
        MakePod(name)
        .req({"cpu": f"{cpu_m}m", "memory": f"{rng.choice((256, 512))}Mi"})
        .labels({"app": app})
        .priority(pri)
        .created(created)
    )
    if rng.random() < 0.30:
        b.node_selector({"node-type": rng.choice(NODE_TYPES)})
    if rng.random() < 0.30:
        b.toleration("dedicated", "special", "NoSchedule")
    # envelope_only (speculative depth-2 traces): the capability draws
    # are still consumed — the stamp's spec flag must not shift the rng
    # stream — but the envelope-leaving features (affinity / spread /
    # volumes / host ports, cycle.multicycle_unsupported_reason) are
    # not applied, so the trace actually exercises the device loop the
    # variant pipelines instead of pinning the profile out of batching
    # on its first affinity pod. Plain multi-cycle traces keep drawing
    # them: the envelope-exit fallback is itself a fuzzed path.
    if rng.random() < 0.25 and not envelope_only:
        b.pod_affinity("topology.kubernetes.io/zone", {"app": app})
    if rng.random() < 0.25 and not envelope_only:
        b.pod_affinity("kubernetes.io/hostname", {"app": app}, anti=True)
    if rng.random() < 0.20 and not envelope_only:
        b.spread(rng.choice((1, 2)), "topology.kubernetes.io/zone",
                 {"app": app},
                 when_unsatisfiable=rng.choice(
                     (api.DO_NOT_SCHEDULE, api.SCHEDULE_ANYWAY)))
    if churn_ok and rng.random() < 0.08:
        b.host_port(8000 + rng.randrange(4))
    if groups and rng.random() < 0.30:
        b.group(rng.choice(groups)["n"])
    if claims and rng.random() < 0.5 and not envelope_only:
        b.volume(claims.pop(0)["n"])
    if rng.random() < 0.08:
        b.preemption_policy("Never")
    return pod_to_state(b.obj())


def _gen_tenant_node(rng: random.Random, tenant: str, name: str) -> dict:
    n = MakeNode(name).capacity(
        {"cpu": str(rng.choice((4, 8))),
         "memory": f"{rng.choice((8, 16))}Gi", "pods": 110}
    ).labels({
        "topology.kubernetes.io/zone": rng.choice(ZONES),
        "node-type": rng.choice(NODE_TYPES),
    }).obj()
    # virtual clusters own their nodes: tenant identity rides the
    # namespace, uid stays namespace-qualified like every object
    n.metadata.namespace = tenant
    n.metadata.uid = f"{tenant}/{name}"
    return node_to_state(n)


def _gen_tenant_pod(rng: random.Random, tenant: str, name: str,
                    created: float) -> dict:
    """Deliberately inside the shared-shape envelope: requests, labels
    and selectors from the SAME vocabulary every tenant draws from, no
    affinity/volumes/gangs — tenant workloads must quantize into a
    small set of PackSpec keys for the arena to stack them, and the
    leak-injection self-test needs >= 2 tenants per bucket to have a
    row to roll."""
    b = (
        MakePod(name, namespace=tenant)
        .req({"cpu": f"{rng.choice((250, 500, 1000))}m",
              "memory": f"{rng.choice((256, 512))}Mi"})
        .labels({"app": rng.choice(APPS)})
        .created(created)
    )
    if rng.random() < 0.25:
        b.node_selector({"node-type": rng.choice(NODE_TYPES)})
    return pod_to_state(b.obj())


def generate_multitenant_trace(
    seed: int, *, tenants: "int | None" = None
) -> Trace:
    """Multi-tenant arena scenario: N virtual clusters, each with its
    own namespaced nodes and pod arrivals, plus tenant lifecycle churn
    (suspend/resume, pod deletes). Replayed by `replay.run_tenant_case`
    — the packed arena against the per-tenant sequential reference,
    per-tenant decision streams bit-equal — NOT by the single-cluster
    engine/oracle differential (`config["tenancy"]` is the routing
    flag run_case dispatches on). Every tenant draws the same node
    count and the same pod vocabulary so shapes quantize into shared
    PackSpec keys; the same seed + kwargs reproduce the same trace."""
    rng = random.Random(seed)
    n_t = tenants if tenants is not None else rng.randint(2, 4)
    tids = [f"team-{i}" for i in range(n_t)]
    n_nodes = rng.randint(2, 6)  # one draw: same N pad bucket fleet-wide
    nodes = [
        _gen_tenant_node(rng, tid, f"{tid}-n{i}")
        for tid in tids
        for i in range(n_nodes)
    ]
    tenancy = {
        tid: {"quota": 0, "weight": rng.choice((1.0, 1.0, 2.0))}
        for tid in tids
    }

    n_cycles = rng.randint(3, 6)
    cycles: list[list[dict]] = []
    live: dict[str, list[str]] = {tid: [] for tid in tids}
    suspended: set[str] = set()
    uid_counter = 0
    created = 0.0
    for _c in range(n_cycles):
        evs: list[dict] = []
        for tid in tids:
            if tid in suspended:
                continue
            for _ in range(rng.randint(0, 3)):
                name = f"p{uid_counter}"
                uid_counter += 1
                evs.append({
                    "op": "add_pod",
                    "pod": _gen_tenant_pod(rng, tid, name, created),
                })
                created += 1.0
                live[tid].append(f"{tid}/{name}")
        r = rng.random()
        if r < 0.15 and len(tids) - len(suspended) > 1:
            tid = rng.choice([t for t in tids if t not in suspended])
            suspended.add(tid)
            evs.append({"op": "suspend_tenant", "tenant": tid})
        elif r < 0.25 and suspended:
            tid = rng.choice(sorted(suspended))
            suspended.discard(tid)
            evs.append({"op": "resume_tenant", "tenant": tid})
        elif r < 0.35:
            all_live = [(t, u) for t in tids for u in live[t]]
            if all_live:
                tid, u = all_live[rng.randrange(len(all_live))]
                live[tid].remove(u)
                evs.append({"op": "delete_pod", "tenant": tid, "uid": u})
        cycles.append(evs)
    cycles.extend([[], []])  # drain ticks: losers get their next cycle

    config = {
        "commit_mode": "scan",
        "gang_scheduling": True,
        "tenancy": {"tenants": tenancy},
    }
    return Trace(
        seed=seed, config=config, nodes=nodes, pod_groups=[], pvcs=[],
        pvs=[], storage_classes=[], pdbs=[], cycles=cycles, tick_s=0.0,
    )


def generate_trace(
    seed: int,
    *,
    devices: int = 1,
    chaos: bool = False,
    multi_cycle: "bool | None" = None,
    speculative: bool = False,
    incremental: bool = False,
) -> Trace:
    """One random scenario. `devices` > 1 turns on sharded serving
    (`shardDevices`; placements must stay bit-identical — PR 9's
    contract). `multi_cycle` forces the K=4 coalescing path (None =
    seeded coin); multi-cycle traces are ARRIVALS-ONLY, FROZEN-CLOCK
    (tick_s=0), and PREEMPTION-FREE (uniform priorities, so no victim
    can ever rank below a preemptor) — churn between buffered groups,
    backoff retries whose re-activation shifts to the flush cycle, and
    eviction informer echoes that land after the flush instead of
    between inner cycles are all legitimate semantic differences of
    the batch window, not engine bugs, so the generator keeps those
    traces inside the exactness envelope the PR 6 equivalence suite
    defines (whose own drive freezes the clock for the same reason).
    `chaos` fuses a random `FaultPlan` over the trace (engine side
    only) and appends a recovery tail so the ladder invariants are
    decidable. `speculative` turns on the depth-2 speculative dispatch
    variant (speculativeDispatch; forces the K=4 coalescing path it
    pipelines) — a pure config switch drawing nothing from the rng, so
    a stamp's spec=<0|1> reproduces the identical trace either way.
    `incremental` turns on admission-time incremental encode
    (incrementalEncode; forces the K=4 coalescing path it feeds) —
    like `speculative`, a pure config switch drawing nothing from the
    rng, so a stamp's inc=<0|1> reproduces the identical trace."""
    rng = random.Random(seed)
    # the coin is drawn UNCONDITIONALLY so an explicit multi_cycle flag
    # (replaying a FUZZ-FAIL stamp's mc=<0|1>) consumes the same rng
    # stream as the seeded coin did — the stamp must reproduce the
    # identical trace, not a shifted one
    mc_coin = rng.random() < 0.25
    if speculative or incremental:
        multi_cycle = True
    elif multi_cycle is None:
        multi_cycle = mc_coin
    churn_ok = not multi_cycle
    uniform = rng.random() < 0.5  # identical nodes -> score ties abound
    n_nodes = rng.randint(4, 10)
    nodes = [
        _gen_node(rng, f"n{i}", uniform=uniform, taint_p=0.2)
        for i in range(n_nodes)
    ]

    pod_groups = []
    if rng.random() < 0.4:
        pod_groups = [
            {"n": f"job-{g}", "mm": rng.randint(2, 3)}
            for g in range(rng.randint(1, 2))
        ]

    pvcs, pvs, classes = [], [], []
    claims: list = []
    if rng.random() < 0.35:
        GiB = 2 ** 30
        classes = [_sc_to(StorageClass(
            "local", api.VOLUME_BINDING_WAIT, provisioner=False,
        ))]
        n_pv = rng.randint(2, 5)
        for v in range(n_pv):
            na = ()
            if rng.random() < 0.5:  # PV topology: zone-pinned volumes
                na = (api.NodeSelectorTerm((api.NodeSelectorRequirement(
                    "topology.kubernetes.io/zone", api.OP_IN,
                    (rng.choice(ZONES),),
                ),)),)
            pvs.append(_pv_to(PersistentVolume(
                f"pv-{v}", capacity=10 * GiB, storage_class="local",
                node_affinity=na,
            )))
        for j in range(rng.randint(2, n_pv + 2)):
            c = PersistentVolumeClaim(
                f"claim-{j}", storage_class="local", request=5 * GiB
            )
            pvcs.append(_pvc_to(c))
            claims.append({"n": c.name})

    pdbs = []
    if rng.random() < 0.4:
        for i in range(rng.randint(1, 2)):
            pdbs.append(_pdb_to(PodDisruptionBudget(
                f"pdb-{i}",
                selector=LabelSelector(
                    match_labels={"app": rng.choice(APPS)}
                ),
                disruptions_allowed=rng.randint(0, 2),
            )))

    n_cycles = rng.randint(5, 9)
    cycles: list[list[dict]] = []
    uid_counter = 0
    live_uids: list[str] = []  # added, not yet deleted (pending or bound)
    churn_nodes: list[str] = []  # nodes added mid-trace (delete targets)
    created = 0.0

    # cycle 0 pre-load: a low-priority existing workload occupying
    # capacity, so high-priority arrivals exercise real preemption
    # pressure (they must fit where placed: <=2 small pods per node)
    ev0: list[dict] = []
    n_exist = rng.randint(0, 2 * n_nodes)
    for i in range(n_exist):
        p = (
            MakePod(f"run{seed % 1000}-{i}")
            .req({"cpu": "500m", "memory": "256Mi"})
            .labels({"app": rng.choice(APPS)})
            .priority(0)
            .created(created)
        )
        created += 1.0
        ev0.append({
            "op": "add_bound_pod",
            "pod": pod_to_state(p.obj()),
            "bind_node": f"n{i % n_nodes}",
        })
    cycles.append(ev0)

    for _c in range(n_cycles):
        evs: list[dict] = []
        n_heavy = 1 if (churn_ok and rng.random() < 0.3) else 0
        n_arrive = rng.randint(1, 5)
        for ai in range(n_arrive + n_heavy):
            heavy = n_heavy > 0 and ai == n_arrive  # last arrival
            name = f"f{seed % 1000}-p{uid_counter}"
            uid_counter += 1
            evs.append({
                "op": "add_pod",
                "pod": _gen_pod(
                    rng, name, created, groups=pod_groups,
                    claims=claims, churn_ok=churn_ok, heavy=heavy,
                    flat_priority=multi_cycle,
                    # envelope_only for the same reason as speculative:
                    # the incremental variant tests the coalescing
                    # flush's encode, so the trace must actually stay
                    # on the multi-cycle path
                    envelope_only=speculative or incremental,
                ),
            })
            created += 1.0
            live_uids.append(f"default/{name}")
        if churn_ok:
            if live_uids and rng.random() < 0.3:
                u = live_uids.pop(rng.randrange(len(live_uids)))
                evs.append({"op": "delete_pod", "uid": u})
            r = rng.random()
            if r < 0.10:
                nm = f"nx{uid_counter}"
                evs.append({
                    "op": "add_node",
                    "node": _gen_node(rng, nm, uniform=uniform,
                                      taint_p=0.2),
                })
                churn_nodes.append(nm)
            elif r < 0.18:
                # drain: re-deliver an initial node as unschedulable
                nd = node_from_state(rng.choice(nodes))
                nd.spec.unschedulable = True
                evs.append({"op": "update_node",
                            "node": node_to_state(nd)})
            elif r < 0.24 and churn_nodes:
                evs.append({
                    "op": "delete_node",
                    "name": churn_nodes.pop(
                        rng.randrange(len(churn_nodes))
                    ),
                })
        cycles.append(evs)

    # drain tail: empty pops flush any coalescing buffer; under chaos a
    # recovery tail with trivial arrivals (promotion only counts cycles
    # that exercised the dispatch path) lets the ladder walk back to 0
    fault_spec = ""
    if chaos:
        rules = []
        fault_cycles = sorted(
            rng.sample(range(3, 3 + n_cycles), k=min(3, n_cycles))
        )
        points = rng.sample(
            ["fetch_delay", "fetch_hang", "device_error", "clock_skew"],
            k=len(fault_cycles),
        )
        for cyc, point in zip(fault_cycles, points):
            if point == "fetch_delay":
                rules.append(f"fetch_delay@cycle={cyc}:ms={rng.choice((60, 120))}:n=1")
            elif point == "fetch_hang":
                # far past the deadline AND past any plausible compile:
                # the watchdog check (_chaos_checks) requires the hang
                # cycle's wall to stay strictly UNDER the full ms plus
                # a deadline-classified ladder step, and early-trace
                # cycles legitimately pay seconds of XLA compile before
                # the bounded fetch — ms must dominate that budget
                rules.append(f"fetch_hang@cycle={cyc}:ms=15000:n=1")
            elif point == "device_error":
                kind = rng.choice(("transport", "corrupt", "wedge"))
                rules.append(f"device_error@cycle={cyc}:kind={kind}:n=1")
            else:
                rules.append(f"clock_skew@cycle={cyc}:ms={rng.choice((100, 400))}:n=1")
        fault_spec = f"seed={seed};" + ";".join(rules)
        for i in range(14):
            name = f"f{seed % 1000}-tail{i}"
            p = (MakePod(name).req({"cpu": "250m", "memory": "128Mi"})
                 .labels({"app": "app-0"}).created(created))
            created += 1.0
            live_uids.append(f"default/{name}")
            cycles.append([{"op": "add_pod", "pod": pod_to_state(p.obj())}])
    cycles.extend([[], []])

    config = {
        "commit_mode": "scan",
        "gang_scheduling": True,
        "multi_cycle_k": 4 if multi_cycle else 1,
        # never the flush trigger: the ticking trace clock would trip a
        # real-units bound every cycle — batches flush on K or idle pops
        "multi_cycle_max_wait_ms": 1e12,
        "shard_devices": devices if devices > 1 else 0,
        # depth-2 speculative dispatch pipelining over the coalesced
        # batches: the differential asserts the adopted/abandoned/
        # re-dispatched streams stay bit-equal to the oracle's
        "speculative_dispatch": bool(speculative),
        # admission-time incremental encode over the coalesced batches:
        # the differential asserts the packed arenas stay byte-identical
        # and the decision/journal/event streams bit-equal to the
        # rebuild engine's
        "incremental_encode": bool(incremental),
        "pad_bucket": 8,
        "dispatch_deadline_ms": 300.0 if chaos else 0.0,
        "degrade_promote_cycles": 2,
    }
    return Trace(
        seed=seed, config=config, nodes=nodes, pod_groups=pod_groups,
        pvcs=pvcs, pvs=pvs, storage_classes=classes, pdbs=pdbs,
        cycles=cycles, fault_spec=fault_spec,
        # frozen clock under coalescing: backoff re-activation times
        # shift to the flush cycle, a legal batch-window difference the
        # differential must not read as divergence
        tick_s=0.0 if multi_cycle else 16.0,
    )
