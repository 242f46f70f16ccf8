"""proto <-> models.api converters for the gRPC shim (the port's copy of
`k8s_scheduler_tpu/service/convert.py`).

Quantities travel as Kubernetes Quantity strings and are normalized here
(cpu -> millicores, bytes elsewhere) exactly like the JSON constructors in
models/api.py — the two wire formats are interchangeable."""

from __future__ import annotations

from ..models import api
from . import scheduler_pb2 as pb


# ---- proto -> api ----------------------------------------------------------


def _req_from(r: pb.LabelSelectorRequirement) -> api.NodeSelectorRequirement:
    return api.NodeSelectorRequirement(r.key, r.operator, tuple(r.values))


def _term_from(t: pb.NodeSelectorTerm) -> api.NodeSelectorTerm:
    return api.NodeSelectorTerm(
        match_expressions=tuple(_req_from(e) for e in t.match_expressions),
        match_fields=tuple(_req_from(e) for e in t.match_fields),
    )


def _selector_from(s: pb.LabelSelector) -> api.LabelSelector:
    return api.LabelSelector(
        match_labels=dict(s.match_labels),
        match_expressions=tuple(_req_from(e) for e in s.match_expressions),
    )


def _aff_term_from(t: pb.PodAffinityTerm) -> api.PodAffinityTerm:
    return api.PodAffinityTerm(
        label_selector=_selector_from(t.label_selector),
        topology_key=t.topology_key,
        namespaces=tuple(t.namespaces),
    )


def _pod_aff_from(p: pb.PodAffinity, cls):
    return cls(
        required=tuple(_aff_term_from(t) for t in p.required),
        preferred=tuple(
            api.WeightedPodAffinityTerm(w.weight, _aff_term_from(w.term))
            for w in p.preferred
        ),
    )


def affinity_from(a: pb.Affinity) -> api.Affinity | None:
    has_na = a.HasField("node_affinity")
    has_pa = a.HasField("pod_affinity")
    has_pan = a.HasField("pod_anti_affinity")
    if not (has_na or has_pa or has_pan):
        return None
    na = None
    if has_na:
        na = api.NodeAffinity(
            required=tuple(_term_from(t) for t in a.node_affinity.required),
            preferred=tuple(
                api.PreferredSchedulingTerm(p.weight, _term_from(p.preference))
                for p in a.node_affinity.preferred
            ),
        )
    pa = _pod_aff_from(a.pod_affinity, api.PodAffinity) if has_pa else None
    pan = (
        _pod_aff_from(a.pod_anti_affinity, api.PodAntiAffinity)
        if has_pan
        else None
    )
    return api.Affinity(node_affinity=na, pod_affinity=pa, pod_anti_affinity=pan)


def meta_from(m: pb.ObjectMeta) -> api.ObjectMeta:
    return api.ObjectMeta(
        name=m.name,
        namespace=m.namespace or "default",
        uid=m.uid,
        labels=dict(m.labels),
        annotations=dict(m.annotations),
        creation_timestamp=m.creation_timestamp,
    )


def pod_from(p: pb.Pod) -> api.Pod:
    s = p.spec
    containers = tuple(
        api.Container.make(
            c.name or "main",
            c.image,
            dict(c.requests),
            tuple(
                api.ContainerPort(
                    container_port=cp.container_port,
                    host_port=cp.host_port,
                    protocol=cp.protocol or "TCP",
                    host_ip=cp.host_ip,
                )
                for cp in c.ports
            ),
        )
        for c in s.containers
    )
    return api.Pod(
        metadata=meta_from(p.metadata),
        spec=api.PodSpec(
            containers=containers,
            node_name=s.node_name,
            node_selector=dict(s.node_selector),
            affinity=affinity_from(s.affinity) if s.HasField("affinity") else None,
            tolerations=tuple(
                api.Toleration(t.key, t.operator or "Equal", t.value, t.effect)
                for t in s.tolerations
            ),
            topology_spread_constraints=tuple(
                api.TopologySpreadConstraint(
                    max_skew=c.max_skew,
                    topology_key=c.topology_key,
                    when_unsatisfiable=c.when_unsatisfiable,
                    label_selector=_selector_from(c.label_selector),
                )
                for c in s.topology_spread_constraints
            ),
            priority=s.priority,
            priority_class_name=s.priority_class_name,
            preemption_policy=s.preemption_policy or "PreemptLowerPriority",
            scheduler_name=s.scheduler_name or "default-scheduler",
            overhead=api._req_to_internal(dict(s.overhead)),
            pod_group=s.pod_group,
            volumes=tuple(s.volumes),
        ),
        nominated_node_name=p.nominated_node_name,
    )


def pvc_from(c: pb.PersistentVolumeClaim) -> api.PersistentVolumeClaim:
    return api.PersistentVolumeClaim(
        name=c.name,
        namespace=c.namespace or "default",
        storage_class=c.storage_class,
        request=c.request,
        volume_name=c.volume_name,
    )


def pvc_to(c: api.PersistentVolumeClaim) -> pb.PersistentVolumeClaim:
    return pb.PersistentVolumeClaim(
        name=c.name,
        namespace=c.namespace,
        storage_class=c.storage_class,
        request=c.request,
        volume_name=c.volume_name,
    )


def pv_from(v: pb.PersistentVolume) -> api.PersistentVolume:
    return api.PersistentVolume(
        name=v.name,
        capacity=v.capacity,
        storage_class=v.storage_class,
        node_affinity=tuple(_term_from(t) for t in v.node_affinity),
        claim_ref=v.claim_ref,
    )


def pv_to(v: api.PersistentVolume) -> pb.PersistentVolume:
    return pb.PersistentVolume(
        name=v.name,
        capacity=v.capacity,
        storage_class=v.storage_class,
        node_affinity=[_term_to(t) for t in v.node_affinity],
        claim_ref=v.claim_ref,
    )


def storage_class_from(s: pb.StorageClass) -> api.StorageClass:
    return api.StorageClass(
        name=s.name,
        volume_binding_mode=s.volume_binding_mode or api.VOLUME_BINDING_IMMEDIATE,
        provisioner=s.provisioner,
        allowed_topologies=tuple(_term_from(t) for t in s.allowed_topologies),
    )


def pdb_from(p: pb.PodDisruptionBudget) -> api.PodDisruptionBudget:
    return api.PodDisruptionBudget(
        name=p.name,
        namespace=p.namespace or "default",
        selector=_selector_from(p.selector),
        disruptions_allowed=p.disruptions_allowed,
    )


def pdb_to(p: api.PodDisruptionBudget) -> pb.PodDisruptionBudget:
    return pb.PodDisruptionBudget(
        name=p.name,
        namespace=p.namespace,
        selector=_selector_to(p.selector),
        disruptions_allowed=p.disruptions_allowed,
    )


def storage_class_to(s: api.StorageClass) -> pb.StorageClass:
    return pb.StorageClass(
        name=s.name,
        volume_binding_mode=s.volume_binding_mode,
        provisioner=s.provisioner,
        allowed_topologies=[_term_to(t) for t in s.allowed_topologies],
    )


def node_from(n: pb.Node) -> api.Node:
    return api.Node(
        metadata=meta_from(n.metadata),
        spec=api.NodeSpec(
            taints=tuple(
                api.Taint(t.key, t.value, t.effect or api.NO_SCHEDULE)
                for t in n.spec.taints
            ),
            unschedulable=n.spec.unschedulable,
        ),
        status=api.NodeStatus(
            allocatable=api._req_to_internal(dict(n.status.allocatable)),
            images=tuple(
                api.ContainerImage(tuple(i.names), i.size_bytes)
                for i in n.status.images
            ),
        ),
    )


# ---- api -> proto (the client agent's side) --------------------------------


def _req_to(r: api.NodeSelectorRequirement) -> pb.LabelSelectorRequirement:
    return pb.LabelSelectorRequirement(
        key=r.key, operator=r.operator, values=list(r.values)
    )


def _term_to(t: api.NodeSelectorTerm) -> pb.NodeSelectorTerm:
    return pb.NodeSelectorTerm(
        match_expressions=[_req_to(e) for e in t.match_expressions],
        match_fields=[_req_to(e) for e in t.match_fields],
    )


def _selector_to(s: api.LabelSelector) -> pb.LabelSelector:
    return pb.LabelSelector(
        match_labels=dict(s.match_labels),
        match_expressions=[_req_to(e) for e in s.match_expressions],
    )


def _aff_term_to(t: api.PodAffinityTerm) -> pb.PodAffinityTerm:
    return pb.PodAffinityTerm(
        label_selector=_selector_to(t.label_selector),
        topology_key=t.topology_key,
        namespaces=list(t.namespaces),
    )


def _pod_aff_to(p) -> pb.PodAffinity:
    return pb.PodAffinity(
        required=[_aff_term_to(t) for t in p.required],
        preferred=[
            pb.WeightedPodAffinityTerm(weight=w.weight, term=_aff_term_to(w.term))
            for w in p.preferred
        ],
    )


def affinity_to(a: api.Affinity | None) -> pb.Affinity | None:
    if a is None:
        return None
    out = pb.Affinity()
    if a.node_affinity is not None:
        out.node_affinity.CopyFrom(
            pb.NodeAffinity(
                required=[_term_to(t) for t in a.node_affinity.required],
                preferred=[
                    pb.PreferredSchedulingTerm(
                        weight=p.weight, preference=_term_to(p.preference)
                    )
                    for p in a.node_affinity.preferred
                ],
            )
        )
    if a.pod_affinity is not None:
        out.pod_affinity.CopyFrom(_pod_aff_to(a.pod_affinity))
    if a.pod_anti_affinity is not None:
        out.pod_anti_affinity.CopyFrom(_pod_aff_to(a.pod_anti_affinity))
    return out


def meta_to(m: api.ObjectMeta) -> pb.ObjectMeta:
    return pb.ObjectMeta(
        name=m.name,
        namespace=m.namespace,
        uid=m.uid,
        labels=dict(m.labels),
        annotations=dict(m.annotations),
        creation_timestamp=m.creation_timestamp,
    )


def _qty(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else str(v)


def _requests_to(requests: dict[str, float]) -> dict[str, str]:
    # internal units back to Quantity strings; format_millis keeps
    # sub-millicore cpu exact ("500u" survives the round-trip)
    from ..utils.quantity import format_millis

    return {
        name: (format_millis(v) if name == api.CPU else _qty(v))
        for name, v in requests.items()
    }


def pod_to(p: api.Pod) -> pb.Pod:
    s = p.spec
    msg = pb.Pod(
        metadata=meta_to(p.metadata),
        spec=pb.PodSpec(
            containers=[
                pb.Container(
                    name=c.name,
                    image=c.image,
                    requests=_requests_to(c.requests),
                    ports=[
                        pb.ContainerPort(
                            container_port=cp.container_port,
                            host_port=cp.host_port,
                            protocol=cp.protocol,
                            host_ip=cp.host_ip,
                        )
                        for cp in c.ports
                    ],
                )
                for c in s.containers
            ],
            node_name=s.node_name,
            node_selector=dict(s.node_selector),
            tolerations=[
                pb.Toleration(
                    key=t.key, operator=t.operator, value=t.value, effect=t.effect
                )
                for t in s.tolerations
            ],
            topology_spread_constraints=[
                pb.TopologySpreadConstraint(
                    max_skew=c.max_skew,
                    topology_key=c.topology_key,
                    when_unsatisfiable=c.when_unsatisfiable,
                    label_selector=_selector_to(c.label_selector),
                )
                for c in s.topology_spread_constraints
            ],
            priority=s.priority,
            priority_class_name=s.priority_class_name,
            preemption_policy=s.preemption_policy,
            scheduler_name=s.scheduler_name,
            overhead=_requests_to(s.overhead),
            pod_group=s.pod_group,
            volumes=list(s.volumes),
        ),
        nominated_node_name=p.nominated_node_name,
    )
    aff = affinity_to(s.affinity)
    if aff is not None:
        msg.spec.affinity.CopyFrom(aff)
    return msg


def node_to(n: api.Node) -> pb.Node:
    return pb.Node(
        metadata=meta_to(n.metadata),
        spec=pb.NodeSpec(
            taints=[
                pb.Taint(key=t.key, value=t.value, effect=t.effect)
                for t in n.spec.taints
            ],
            unschedulable=n.spec.unschedulable,
        ),
        status=pb.NodeStatus(
            allocatable=_requests_to(n.status.allocatable),
            images=[
                pb.ContainerImage(names=list(i.names), size_bytes=i.size_bytes)
                for i in n.status.images
            ],
        ),
    )
