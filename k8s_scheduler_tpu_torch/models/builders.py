"""Fluent pod/node builders for tests and synthetic-cluster generation
(the port's own copy of `k8s_scheduler_tpu/models/builders.py`).

Mirrors the upstream testing wrappers (`MakePod().Name(x).Req(...).Obj()`
style builders in kube-scheduler's `testing` package — expected reference
location [UNVERIFIED], mount empty; SURVEY.md §4 "wrapper builders").
"""

from __future__ import annotations

from typing import Any, Mapping

from . import api
from .api import (
    Affinity,
    Container,
    ContainerImage,
    ContainerPort,
    LabelSelector,
    Node,
    NodeAffinity,
    NodeSelectorRequirement,
    NodeSelectorTerm,
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


class MakePod:
    def __init__(self, name: str = "pod", namespace: str = "default"):
        self._pod = Pod(metadata=ObjectMeta(name=name, namespace=namespace), spec=PodSpec())

    def uid(self, uid: str) -> "MakePod":
        self._pod.metadata.uid = uid
        return self

    def labels(self, labels: Mapping[str, str]) -> "MakePod":
        self._pod.metadata.labels.update(labels)
        return self

    def req(self, requests: Mapping[str, Any], image: str = "") -> "MakePod":
        """Add a container with the given resource requests."""
        n = len(self._pod.spec.containers)
        self._pod.spec.containers += (
            Container.make(f"c{n}", image, requests),
        )
        return self

    def image(self, image: str, requests: Mapping[str, Any] | None = None) -> "MakePod":
        return self.req(requests or {}, image=image)

    def host_port(self, port: int, protocol: str = "TCP") -> "MakePod":
        if not self._pod.spec.containers:
            self.req({})
        cs = list(self._pod.spec.containers)
        cs[-1].ports += (ContainerPort(container_port=port, host_port=port, protocol=protocol),)
        self._pod.spec.containers = tuple(cs)
        return self

    def priority(self, p: int) -> "MakePod":
        self._pod.spec.priority = p
        return self

    def preemption_policy(self, policy: str) -> "MakePod":
        self._pod.spec.preemption_policy = policy
        return self

    def created(self, ts: float) -> "MakePod":
        self._pod.metadata.creation_timestamp = ts
        return self

    def node(self, node_name: str) -> "MakePod":
        self._pod.spec.node_name = node_name
        return self

    def node_selector(self, sel: Mapping[str, str]) -> "MakePod":
        self._pod.spec.node_selector.update(sel)
        return self

    def _affinity(self) -> Affinity:
        if self._pod.spec.affinity is None:
            self._pod.spec.affinity = Affinity()
        return self._pod.spec.affinity

    def node_affinity_required(self, *terms: NodeSelectorTerm) -> "MakePod":
        aff = self._affinity()
        na = aff.node_affinity or NodeAffinity()
        aff.node_affinity = NodeAffinity(na.required + terms, na.preferred)
        return self

    def node_affinity_in(self, key: str, values: list[str]) -> "MakePod":
        return self.node_affinity_required(
            NodeSelectorTerm((NodeSelectorRequirement(key, api.OP_IN, tuple(values)),))
        )

    def node_affinity_preferred(self, weight: int, key: str, values: list[str],
                                op: str = api.OP_IN) -> "MakePod":
        aff = self._affinity()
        na = aff.node_affinity or NodeAffinity()
        term = NodeSelectorTerm((NodeSelectorRequirement(key, op, tuple(values)),))
        aff.node_affinity = NodeAffinity(
            na.required, na.preferred + (PreferredSchedulingTerm(weight, term),)
        )
        return self

    def pod_affinity(self, topology_key: str, match_labels: Mapping[str, str],
                     anti: bool = False, weight: int = 0) -> "MakePod":
        """weight=0 → required term; weight>0 → preferred term."""
        aff = self._affinity()
        term = PodAffinityTerm(
            LabelSelector(match_labels=dict(match_labels)), topology_key
        )
        if anti:
            pa = aff.pod_anti_affinity or PodAntiAffinity()
            if weight:
                pa = PodAntiAffinity(pa.required, pa.preferred + (WeightedPodAffinityTerm(weight, term),))
            else:
                pa = PodAntiAffinity(pa.required + (term,), pa.preferred)
            aff.pod_anti_affinity = pa
        else:
            pb = aff.pod_affinity or PodAffinity()
            if weight:
                pb = PodAffinity(pb.required, pb.preferred + (WeightedPodAffinityTerm(weight, term),))
            else:
                pb = PodAffinity(pb.required + (term,), pb.preferred)
            aff.pod_affinity = pb
        return self

    def toleration(self, key: str, value: str = "", effect: str = "",
                   op: str = "Equal") -> "MakePod":
        self._pod.spec.tolerations += (Toleration(key, op, value, effect),)
        return self

    def spread(self, max_skew: int, topology_key: str,
               match_labels: Mapping[str, str],
               when_unsatisfiable: str = api.DO_NOT_SCHEDULE) -> "MakePod":
        self._pod.spec.topology_spread_constraints += (
            TopologySpreadConstraint(
                max_skew, topology_key, when_unsatisfiable,
                LabelSelector(match_labels=dict(match_labels)),
            ),
        )
        return self

    def volume(self, claim_name: str) -> "MakePod":
        self._pod.spec.volumes = self._pod.spec.volumes + (claim_name,)
        return self

    def group(self, name: str) -> "MakePod":
        self._pod.spec.pod_group = name
        return self

    def scheduler(self, name: str) -> "MakePod":
        self._pod.spec.scheduler_name = name
        return self

    def nominated(self, node_name: str) -> "MakePod":
        self._pod.nominated_node_name = node_name
        return self

    def obj(self) -> Pod:
        return self._pod


class MakeNode:
    def __init__(self, name: str = "node"):
        self._node = Node(metadata=ObjectMeta(name=name))

    def labels(self, labels: Mapping[str, str]) -> "MakeNode":
        self._node.metadata.labels.update(labels)
        return self

    def capacity(self, allocatable: Mapping[str, Any]) -> "MakeNode":
        alloc = dict(self._node.status.allocatable)
        alloc.update(api._req_to_internal(allocatable))
        alloc.setdefault(api.PODS, 110.0)  # upstream default max-pods
        self._node.status.allocatable = alloc
        return self

    def taint(self, key: str, value: str = "", effect: str = api.NO_SCHEDULE) -> "MakeNode":
        self._node.spec.taints += (Taint(key, value, effect),)
        return self

    def unschedulable(self, v: bool = True) -> "MakeNode":
        self._node.spec.unschedulable = v
        return self

    def image(self, name: str, size_bytes: int) -> "MakeNode":
        self._node.status.images += (ContainerImage((name,), size_bytes),)
        return self

    def obj(self) -> Node:
        return self._node
