"""Pod/Node <-> plain-dict converters for the journal/snapshot wire format
(the port's copy of `k8s_scheduler_tpu/state/codec.py`: every object
serialises to the same dict, key for key, as the reference's).

Hand-rolled instead of `dataclasses.asdict` because the journal emits on
the scheduling hot path: asdict deep-copies recursively through every
nested dataclass (~10x slower than building the dict directly). Omit-empty
convention: fields at their dataclass
default are skipped, and `*_from_state` fills the same defaults back in,
so records stay small and the round trip is exact.

Also home to `state_digest`: the canonical SHA-256 over a queue+cache
state dump, used by the differential failover tests and the smoke run's
failover check to prove a restored standby is bit-identical to the
pre-crash active.
"""

from __future__ import annotations

import hashlib
import json

from ..models.api import (
    Affinity,
    Container,
    ContainerImage,
    ContainerPort,
    LabelSelector,
    Node,
    NodeAffinity,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PodAntiAffinity,
    PodSpec,
    PreferredSchedulingTerm,
    Taint,
    Toleration,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
)

# ---------------------------------------------------------------------------
# selector / affinity helpers
# ---------------------------------------------------------------------------


def _req_to(r: NodeSelectorRequirement) -> dict:
    d = {"k": r.key, "o": r.operator}
    if r.values:
        d["v"] = list(r.values)
    return d


def _req_from(d: dict) -> NodeSelectorRequirement:
    return NodeSelectorRequirement(
        key=d["k"], operator=d["o"], values=tuple(d.get("v", ()))
    )


def _term_to(t: NodeSelectorTerm) -> dict:
    d = {}
    if t.match_expressions:
        d["e"] = [_req_to(r) for r in t.match_expressions]
    if t.match_fields:
        d["f"] = [_req_to(r) for r in t.match_fields]
    return d


def _term_from(d: dict) -> NodeSelectorTerm:
    return NodeSelectorTerm(
        match_expressions=tuple(_req_from(r) for r in d.get("e", ())),
        match_fields=tuple(_req_from(r) for r in d.get("f", ())),
    )


def _lsel_to(s: LabelSelector) -> dict:
    d = {}
    if s.match_labels:
        d["l"] = dict(s.match_labels)
    if s.match_expressions:
        d["e"] = [_req_to(r) for r in s.match_expressions]
    return d


def _lsel_from(d: dict) -> LabelSelector:
    return LabelSelector(
        match_labels=dict(d.get("l", {})),
        match_expressions=tuple(_req_from(r) for r in d.get("e", ())),
    )


def _pat_to(t: PodAffinityTerm) -> dict:
    d = {"s": _lsel_to(t.label_selector), "tk": t.topology_key}
    if t.namespaces:
        d["ns"] = list(t.namespaces)
    return d


def _pat_from(d: dict) -> PodAffinityTerm:
    return PodAffinityTerm(
        label_selector=_lsel_from(d.get("s", {})),
        topology_key=d.get("tk", ""),
        namespaces=tuple(d.get("ns", ())),
    )


def _aff_to(a: Affinity | None) -> dict | None:
    if a is None:
        return None
    out: dict = {}
    na = a.node_affinity
    if na is not None:
        out["n"] = {
            "r": [_term_to(t) for t in na.required],
            "p": [
                {"w": p.weight, "t": _term_to(p.preference)}
                for p in na.preferred
            ],
        }
    for key, pa in (("a", a.pod_affinity), ("x", a.pod_anti_affinity)):
        if pa is not None:
            out[key] = {
                "r": [_pat_to(t) for t in pa.required],
                "p": [
                    {"w": w.weight, "t": _pat_to(w.term)}
                    for w in pa.preferred
                ],
            }
    return out


def _aff_from(d: dict | None) -> Affinity | None:
    if not d:
        return None
    na = None
    if "n" in d:
        nd = d["n"]
        na = NodeAffinity(
            required=tuple(_term_from(t) for t in nd.get("r", ())),
            preferred=tuple(
                PreferredSchedulingTerm(p["w"], _term_from(p["t"]))
                for p in nd.get("p", ())
            ),
        )
    pa = pan = None
    for key, cls in (("a", PodAffinity), ("x", PodAntiAffinity)):
        if key in d:
            pd = d[key]
            obj = cls(
                required=tuple(_pat_from(t) for t in pd.get("r", ())),
                preferred=tuple(
                    WeightedPodAffinityTerm(w["w"], _pat_from(w["t"]))
                    for w in pd.get("p", ())
                ),
            )
            if key == "a":
                pa = obj
            else:
                pan = obj
    return Affinity(node_affinity=na, pod_affinity=pa, pod_anti_affinity=pan)


# ---------------------------------------------------------------------------
# Pod
# ---------------------------------------------------------------------------


def pod_to_state(p: Pod) -> dict:
    m = p.metadata
    s = p.spec
    meta: dict = {"n": m.name}
    if m.namespace != "default":
        meta["ns"] = m.namespace
    meta["u"] = m.uid
    if m.labels:
        meta["l"] = dict(m.labels)
    if m.annotations:
        meta["a"] = dict(m.annotations)
    if m.creation_timestamp:
        meta["ct"] = m.creation_timestamp
    spec: dict = {}
    if s.containers:
        spec["c"] = [
            {
                "n": c.name,
                **({"i": c.image} if c.image else {}),
                **({"r": dict(c.requests)} if c.requests else {}),
                **(
                    {
                        "p": [
                            {
                                "cp": pt.container_port,
                                "hp": pt.host_port,
                                "pr": pt.protocol,
                                "ip": pt.host_ip,
                            }
                            for pt in c.ports
                        ]
                    }
                    if c.ports
                    else {}
                ),
            }
            for c in s.containers
        ]
    if s.node_name:
        spec["nn"] = s.node_name
    if s.node_selector:
        spec["sel"] = dict(s.node_selector)
    aff = _aff_to(s.affinity)
    if aff is not None:
        spec["af"] = aff
    if s.tolerations:
        spec["tol"] = [
            {
                "k": t.key,
                "o": t.operator,
                "v": t.value,
                "e": t.effect,
                **(
                    {"s": t.toleration_seconds}
                    if t.toleration_seconds is not None
                    else {}
                ),
            }
            for t in s.tolerations
        ]
    if s.topology_spread_constraints:
        spec["tsc"] = [
            {
                "ms": c.max_skew,
                "tk": c.topology_key,
                "wu": c.when_unsatisfiable,
                "s": _lsel_to(c.label_selector),
            }
            for c in s.topology_spread_constraints
        ]
    if s.priority:
        spec["pri"] = s.priority
    if s.priority_class_name:
        spec["pcn"] = s.priority_class_name
    if s.preemption_policy != "PreemptLowerPriority":
        spec["pp"] = s.preemption_policy
    if s.scheduler_name != "default-scheduler":
        spec["sn"] = s.scheduler_name
    if s.overhead:
        spec["ov"] = dict(s.overhead)
    if s.pod_group:
        spec["pg"] = s.pod_group
    if s.volumes:
        spec["vol"] = list(s.volumes)
    out = {"m": meta, "s": spec}
    if p.nominated_node_name:
        out["nom"] = p.nominated_node_name
    return out


def pod_from_state(d: dict) -> Pod:
    m = d.get("m", {})
    s = d.get("s", {})
    containers = tuple(
        Container(
            name=c.get("n", "main"),
            image=c.get("i", ""),
            requests=dict(c.get("r", {})),
            ports=tuple(
                ContainerPort(
                    container_port=pt.get("cp", 0),
                    host_port=pt.get("hp", 0),
                    protocol=pt.get("pr", "TCP"),
                    host_ip=pt.get("ip", ""),
                )
                for pt in c.get("p", ())
            ),
        )
        for c in s.get("c", ())
    )
    tolerations = tuple(
        Toleration(
            key=t.get("k", ""),
            operator=t.get("o", "Equal"),
            value=t.get("v", ""),
            effect=t.get("e", ""),
            toleration_seconds=t.get("s"),
        )
        for t in s.get("tol", ())
    )
    tsc = tuple(
        TopologySpreadConstraint(
            max_skew=c["ms"],
            topology_key=c["tk"],
            when_unsatisfiable=c["wu"],
            label_selector=_lsel_from(c.get("s", {})),
        )
        for c in s.get("tsc", ())
    )
    return Pod(
        metadata=ObjectMeta(
            name=m.get("n", ""),
            namespace=m.get("ns", "default"),
            uid=m.get("u", ""),
            labels=dict(m.get("l", {})),
            annotations=dict(m.get("a", {})),
            creation_timestamp=m.get("ct", 0.0),
        ),
        spec=PodSpec(
            containers=containers,
            node_name=s.get("nn", ""),
            node_selector=dict(s.get("sel", {})),
            affinity=_aff_from(s.get("af")),
            tolerations=tolerations,
            topology_spread_constraints=tsc,
            priority=s.get("pri", 0),
            priority_class_name=s.get("pcn", ""),
            preemption_policy=s.get("pp", "PreemptLowerPriority"),
            scheduler_name=s.get("sn", "default-scheduler"),
            overhead=dict(s.get("ov", {})),
            pod_group=s.get("pg", ""),
            volumes=tuple(s.get("vol", ())),
        ),
        nominated_node_name=d.get("nom", ""),
    )


# ---------------------------------------------------------------------------
# Node
# ---------------------------------------------------------------------------


def node_to_state(n: Node) -> dict:
    m = n.metadata
    meta: dict = {"n": m.name, "u": m.uid}
    if m.namespace != "default":
        # cluster-scoped in stock k8s, but virtual clusters own their
        # nodes: tenant identity rides the namespace (tenancy/)
        meta["ns"] = m.namespace
    if m.labels:
        meta["l"] = dict(m.labels)
    if m.creation_timestamp:
        meta["ct"] = m.creation_timestamp
    spec: dict = {}
    if n.spec.taints:
        spec["t"] = [
            {"k": t.key, "v": t.value, "e": t.effect} for t in n.spec.taints
        ]
    if n.spec.unschedulable:
        spec["u"] = True
    status: dict = {}
    if n.status.allocatable:
        status["a"] = dict(n.status.allocatable)
    if n.status.images:
        status["i"] = [
            {"n": list(i.names), "s": i.size_bytes} for i in n.status.images
        ]
    return {"m": meta, "s": spec, "st": status}


def node_from_state(d: dict) -> Node:
    m = d.get("m", {})
    s = d.get("s", {})
    st = d.get("st", {})
    return Node(
        metadata=ObjectMeta(
            name=m.get("n", ""),
            namespace=m.get("ns", "default"),
            uid=m.get("u", ""),
            labels=dict(m.get("l", {})),
            creation_timestamp=m.get("ct", 0.0),
        ),
        spec=NodeSpec(
            taints=tuple(
                Taint(t["k"], t.get("v", ""), t.get("e", "NoSchedule"))
                for t in s.get("t", ())
            ),
            unschedulable=bool(s.get("u", False)),
        ),
        status=NodeStatus(
            allocatable=dict(st.get("a", {})),
            images=tuple(
                ContainerImage(tuple(i.get("n", ())), i.get("s", 0))
                for i in st.get("i", ())
            ),
        ),
    )


# ---------------------------------------------------------------------------
# digest
# ---------------------------------------------------------------------------


def state_digest(queue, cache) -> str:
    """Canonical SHA-256 over the full durable state of a
    (SchedulingQueue, SchedulerCache) pair. Two instances with
    bit-identical logical state — tiers, attempt counts, backoff
    expiries, in-flight set, bound/assumed pods, TTL deadlines — hash
    equal; anything else does not. Tier entry ORDER is part of the
    digest on purpose: replay reproduces insertion order, so a restored
    standby drains pop_ready() in the same order the active would have."""
    blob = json.dumps(
        {"queue": queue.dump_state(), "cache": cache.dump_state()},
        sort_keys=True,
        separators=(",", ":"),
    ).encode()
    return hashlib.sha256(blob).hexdigest()
