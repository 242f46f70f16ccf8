"""Typed object model for the scheduler's API surface — the port's own
copy of `k8s_scheduler_tpu/models/api.py`, cut to the objects the
rounds-engine, preemption and volume slices encode (no dict-constructor
types yet).

This is the subset of the Kubernetes Pod/Node API that the scheduler family
consumes (the reference's inputs arrive as client-go informer objects; here
they arrive as these dataclasses).

Expected upstream shapes (reference mount empty — [UNVERIFIED], SURVEY.md
§2 C2/C4): `k8s.io/api/core/v1` types consumed by `framework/types.go`.

Conventions:
- cpu is stored in millicores, memory/storage in bytes (upstream Quantity
  semantics, normalized at parse time — see utils/quantity.py).
- `None` everywhere means "field absent", matching k8s optionality.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping

from ..utils.quantity import parse_quantity

# Resource names get a fixed axis order in the encoded tensors; cpu/memory
# first because every workload has them (upstream: v1.ResourceCPU etc.).
CPU = "cpu"
MEMORY = "memory"
PODS = "pods"
EPHEMERAL_STORAGE = "ephemeral-storage"
DEFAULT_RESOURCES = (CPU, MEMORY, PODS, EPHEMERAL_STORAGE)

# Taint effects (v1.TaintEffect)
NO_SCHEDULE = "NoSchedule"
PREFER_NO_SCHEDULE = "PreferNoSchedule"
NO_EXECUTE = "NoExecute"

# Selector operators (v1.NodeSelectorOperator / metav1.LabelSelectorOperator)
OP_IN = "In"
OP_NOT_IN = "NotIn"
OP_EXISTS = "Exists"
OP_DOES_NOT_EXIST = "DoesNotExist"
OP_GT = "Gt"
OP_LT = "Lt"

# TopologySpreadConstraint.whenUnsatisfiable
DO_NOT_SCHEDULE = "DoNotSchedule"
SCHEDULE_ANYWAY = "ScheduleAnyway"


def _req_to_internal(requests: Mapping[str, Any]) -> dict[str, float]:
    out: dict[str, float] = {}
    for name, q in requests.items():
        out[name] = parse_quantity(q, as_millis=(name == CPU))
    return out


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    creation_timestamp: float = 0.0

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"{self.namespace}/{self.name}"


@dataclass
class NodeSelectorRequirement:
    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: tuple[str, ...] = ()


@dataclass
class NodeSelectorTerm:
    # ANDed requirements; a NodeSelector is an OR over terms.
    match_expressions: tuple[NodeSelectorRequirement, ...] = ()
    match_fields: tuple[NodeSelectorRequirement, ...] = ()  # metadata.name only


@dataclass
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm


@dataclass
class NodeAffinity:
    # requiredDuringSchedulingIgnoredDuringExecution
    required: tuple[NodeSelectorTerm, ...] = ()
    # preferredDuringSchedulingIgnoredDuringExecution
    preferred: tuple[PreferredSchedulingTerm, ...] = ()


@dataclass
class LabelSelector:
    match_labels: dict[str, str] = field(default_factory=dict)
    match_expressions: tuple[NodeSelectorRequirement, ...] = ()

    def empty(self) -> bool:
        return not self.match_labels and not self.match_expressions


@dataclass
class PodAffinityTerm:
    label_selector: LabelSelector
    topology_key: str
    namespaces: tuple[str, ...] = ()  # empty = pod's own namespace


@dataclass
class WeightedPodAffinityTerm:
    weight: int
    term: PodAffinityTerm


@dataclass
class PodAffinity:
    required: tuple[PodAffinityTerm, ...] = ()
    preferred: tuple[WeightedPodAffinityTerm, ...] = ()


@dataclass
class PodAntiAffinity:
    required: tuple[PodAffinityTerm, ...] = ()
    preferred: tuple[WeightedPodAffinityTerm, ...] = ()


@dataclass
class Affinity:
    node_affinity: NodeAffinity | None = None
    pod_affinity: PodAffinity | None = None
    pod_anti_affinity: PodAntiAffinity | None = None


@dataclass
class Toleration:
    key: str = ""  # empty key + Exists tolerates everything
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # empty matches all effects
    toleration_seconds: int | None = None


@dataclass
class Taint:
    key: str
    value: str = ""
    effect: str = NO_SCHEDULE


@dataclass
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str
    when_unsatisfiable: str  # DoNotSchedule | ScheduleAnyway
    label_selector: LabelSelector = field(default_factory=LabelSelector)


@dataclass
class ContainerPort:
    container_port: int
    host_port: int = 0  # 0 = no host port claim
    protocol: str = "TCP"
    host_ip: str = ""


@dataclass
class Container:
    name: str = "main"
    image: str = ""
    requests: dict[str, float] = field(default_factory=dict)  # internal units
    ports: tuple[ContainerPort, ...] = ()

    @staticmethod
    def make(name: str, image: str, requests: Mapping[str, Any],
             ports: tuple[ContainerPort, ...] = ()) -> "Container":
        return Container(name, image, _req_to_internal(requests), ports)


@dataclass
class PodSpec:
    containers: tuple[Container, ...] = ()
    node_name: str = ""  # pre-bound / NodeName plugin target
    node_selector: dict[str, str] = field(default_factory=dict)
    affinity: Affinity | None = None
    tolerations: tuple[Toleration, ...] = ()
    topology_spread_constraints: tuple[TopologySpreadConstraint, ...] = ()
    priority: int = 0
    priority_class_name: str = ""
    # "PreemptLowerPriority" (default) or "Never"
    preemption_policy: str = "PreemptLowerPriority"
    scheduler_name: str = "default-scheduler"
    overhead: dict[str, float] = field(default_factory=dict)
    # Gang scheduling (out-of-tree Coscheduling plugin's PodGroup label):
    pod_group: str = ""
    # PVC names this pod mounts (spec.volumes[].persistentVolumeClaim.
    # claimName) — consumed by the VolumeBinding filter
    volumes: tuple[str, ...] = ()


@dataclass
class Pod:
    metadata: ObjectMeta
    spec: PodSpec
    # status.nominatedNodeName — set by preemption, honored next cycle
    nominated_node_name: str = ""

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    @property
    def uid(self) -> str:
        return self.metadata.uid

    def resource_requests(self) -> dict[str, float]:
        """Effective pod request = sum over containers (+ overhead), plus the
        implicit one-"pods"-slot request (upstream computePodResourceRequest;
        init containers take a max, not modeled yet)."""
        total: dict[str, float] = {}
        for c in self.spec.containers:
            for r, v in c.requests.items():
                total[r] = total.get(r, 0.0) + v
        for r, v in self.spec.overhead.items():
            total[r] = total.get(r, 0.0) + v
        total[PODS] = total.get(PODS, 0.0) + 1.0
        return total

    def host_ports(self) -> list[tuple[int, str, str]]:
        out = []
        for c in self.spec.containers:
            for p in c.ports:
                if p.host_port:
                    out.append((p.host_port, p.protocol, p.host_ip))
        return out

    def images(self) -> list[str]:
        return [c.image for c in self.spec.containers if c.image]


@dataclass
class ContainerImage:
    names: tuple[str, ...]
    size_bytes: int = 0


@dataclass
class NodeStatus:
    allocatable: dict[str, float] = field(default_factory=dict)  # internal units
    images: tuple[ContainerImage, ...] = ()


@dataclass
class NodeSpec:
    taints: tuple[Taint, ...] = ()
    unschedulable: bool = False


@dataclass
class Node:
    metadata: ObjectMeta
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class PodGroup:
    """Gang-scheduling group (scheduler-plugins Coscheduling PodGroup CRD
    analogue): schedule min_member members all-or-nothing."""

    name: str
    min_member: int


@dataclass
class PodDisruptionBudget:
    """PDB, as preemption consumes it: how many voluntary disruptions the
    selected pods can absorb right now (status.disruptionsAllowed)."""

    name: str
    namespace: str = "default"
    selector: "LabelSelector" = field(default_factory=lambda: LabelSelector())
    disruptions_allowed: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


# ---------------------------------------------------------------------------
# Volumes (VolumeBinding filter inputs)
# ---------------------------------------------------------------------------

VOLUME_BINDING_IMMEDIATE = "Immediate"
VOLUME_BINDING_WAIT = "WaitForFirstConsumer"


@dataclass
class StorageClass:
    name: str
    volume_binding_mode: str = VOLUME_BINDING_IMMEDIATE
    # dynamic provisioning available (provisioner != no-provisioner)
    provisioner: bool = True
    # allowedTopologies, compiled like node-affinity terms (OR of terms)
    allowed_topologies: tuple[NodeSelectorTerm, ...] = ()


@dataclass
class PersistentVolume:
    name: str
    capacity: float = 0.0  # storage bytes
    storage_class: str = ""
    # spec.nodeAffinity.required: OR of terms restricting usable nodes
    node_affinity: tuple[NodeSelectorTerm, ...] = ()
    # claimRef: bound to this PVC ("namespace/name"); "" = available
    claim_ref: str = ""


@dataclass
class PersistentVolumeClaim:
    name: str
    namespace: str = "default"
    storage_class: str = ""
    request: float = 0.0  # requested storage bytes
    volume_name: str = ""  # bound PV ("" = unbound)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"
