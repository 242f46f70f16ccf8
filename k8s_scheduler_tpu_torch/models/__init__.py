from .api import (  # noqa: F401
    Affinity,
    Container,
    ContainerImage,
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
    PodGroup,
    PodSpec,
    PreferredSchedulingTerm,
    Taint,
    Toleration,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
)
from .builders import MakeNode, MakePod  # noqa: F401
from .encoding import ClusterSnapshot, SnapshotEncoder, snapshot_from_numpy  # noqa: F401
