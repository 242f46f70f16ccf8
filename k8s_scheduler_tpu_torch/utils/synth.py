"""Synthetic cluster generation (the port's own copy of
`k8s_scheduler_tpu/utils/synth.py`: the same seed draws the same objects,
which the differential tests rely on) — the fixture generator for unit, property,
and perf tests alike (SURVEY.md §4: nodes are just API objects, "multi-node"
needs no machines; this mirrors upstream scheduler_perf's YAML workload
templates as parameterized generators)."""

from __future__ import annotations

import numpy as np

from ..models.api import LabelSelector, Node, Pod, PodDisruptionBudget, PodGroup
from ..models.builders import MakeNode, MakePod

ZONES = [f"zone-{c}" for c in "abcdef"]
REGIONS = ["region-1", "region-2"]


def make_cluster(
    num_nodes: int,
    seed: int = 0,
    with_labels: bool = True,
    taint_fraction: float = 0.0,
    cpu_choices: tuple[int, ...] = (8, 16, 32, 64),
    memory_choices: tuple[int, ...] = (16, 32, 64, 128),
) -> list[Node]:
    """`cpu_choices`/`memory_choices` set the per-node capacity draw —
    scarcity knobs for preemption-heavy benchmark configs."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(num_nodes):
        b = MakeNode(f"node-{i}").capacity(
            {
                "cpu": f"{int(rng.choice(cpu_choices))}",
                "memory": f"{int(rng.choice(memory_choices))}Gi",
                "pods": 110,
            }
        )
        if with_labels:
            b.labels(
                {
                    "topology.kubernetes.io/zone": ZONES[i % len(ZONES)],
                    "topology.kubernetes.io/region": REGIONS[i % len(REGIONS)],
                    "node-type": ["general", "compute", "memory"][i % 3],
                }
            )
        if taint_fraction and rng.random() < taint_fraction:
            b.taint("dedicated", "special")
        nodes.append(b.obj())
    return nodes


def make_pods(
    num_pods: int,
    seed: int = 1,
    name_prefix: str = "pod",
    affinity_fraction: float = 0.0,
    anti_affinity_fraction: float = 0.0,
    selector_fraction: float = 0.0,
    toleration_fraction: float = 0.0,
    spread_fraction: float = 0.0,
    priorities: tuple[int, ...] = (0,),
    num_apps: int = 20,
) -> list[Pod]:
    """`num_apps` controls how many distinct `app` labels (and therefore
    distinct affinity selectors) the workload carries — the S axis of the
    affinity state; real clusters run one selector per deployment, so
    realistic scale tests want num_apps in the hundreds."""
    rng = np.random.default_rng(seed)
    pods = []
    for i in range(num_pods):
        app = f"app-{int(rng.integers(0, num_apps))}"
        b = (
            MakePod(f"{name_prefix}-{i}")
            .req(
                {
                    "cpu": f"{int(rng.integers(1, 16)) * 250}m",
                    "memory": f"{int(rng.integers(1, 16)) * 256}Mi",
                }
            )
            .labels({"app": app})
            .priority(int(rng.choice(priorities)))
            .created(float(i))
        )
        if selector_fraction and rng.random() < selector_fraction:
            b.node_selector({"node-type": ["general", "compute", "memory"][i % 3]})
        if toleration_fraction and rng.random() < toleration_fraction:
            b.toleration("dedicated", "special", "NoSchedule")
        if affinity_fraction and rng.random() < affinity_fraction:
            b.pod_affinity("topology.kubernetes.io/zone", {"app": app})
        if anti_affinity_fraction and rng.random() < anti_affinity_fraction:
            b.pod_affinity("kubernetes.io/hostname", {"app": app}, anti=True)
        if spread_fraction and rng.random() < spread_fraction:
            b.spread(2, "topology.kubernetes.io/zone", {"app": app})
        pods.append(b.obj())
    return pods


def make_gang_pods(
    num_groups: int, replicas: int = 8, seed: int = 2
) -> tuple[list[Pod], list[PodGroup]]:
    rng = np.random.default_rng(seed)
    pods, groups = [], []
    for g in range(num_groups):
        name = f"job-{g}"
        groups.append(PodGroup(name, replicas))
        for r in range(replicas):
            pods.append(
                MakePod(f"{name}-{r}")
                .req({"cpu": f"{int(rng.integers(2, 8)) * 500}m",
                      "memory": "1Gi"})
                .group(name)
                .created(float(g * replicas + r))
                .obj()
            )
    return pods, groups


# BASELINE config #4's pending mix (`bench_suite.py` PENDING_PARAMS[4])
CONFIG4_PENDING = dict(
    affinity_fraction=0.3, anti_affinity_fraction=0.2, spread_fraction=0.2,
    selector_fraction=0.3, toleration_fraction=0.1,
    priorities=(0, 0, 10, 100), num_apps=500,
)


def config4_workload(
    pending_seeds,
    num_nodes: int = 5000,
    num_existing: int = 12000,
    num_pending: int = 10000,
    num_apps: int = 500,
) -> tuple[list[Node], list[tuple[Pod, str]], dict[int, list[Pod]]]:
    """BASELINE config #4's workload (`bench_suite.py`
    make_config_workload(4)): small nodes, a running workload with
    inter-pod affinity and topology spread bound round-robin, and the
    config's pending mix (required affinity and anti-affinity, spread,
    node selectors, tolerations, four priority levels). The defaults are
    the config's full size; smaller sizes keep its shapes for tests.
    Returns (nodes, existing, {seed: pending})."""
    nodes = make_cluster(num_nodes, taint_fraction=0.1, cpu_choices=(4, 8, 16))
    running = make_pods(num_existing, seed=991, name_prefix="run",
                        affinity_fraction=0.1, spread_fraction=0.1,
                        num_apps=num_apps)
    existing = [(p, f"node-{i % num_nodes}") for i, p in enumerate(running)]
    pending = {
        s: make_pods(num_pending, seed=s, **dict(CONFIG4_PENDING, num_apps=num_apps))
        for s in pending_seeds
    }
    return nodes, existing, pending


def config4_cluster_config2_pending(
    pending_seeds,
    num_nodes: int = 5000,
    num_existing: int = 12000,
    num_pending: int = 10000,
) -> tuple[list[Node], list[tuple[Pod, str]], dict[int, list[Pod]]]:
    """The port's slice-1 workload: BASELINE config #4's cluster
    (`bench_suite.py` make_config_workload(4): small nodes, a running
    workload bound round-robin) without its affinity/spread pods, and
    config #2's constraint mix (node selectors, tolerations) on the
    pending side. Returns (nodes, existing, {seed: pending})."""
    nodes = make_cluster(num_nodes, taint_fraction=0.1, cpu_choices=(4, 8, 16))
    existing = [
        (p, f"node-{i % num_nodes}")
        for i, p in enumerate(make_pods(num_existing, seed=991, name_prefix="run"))
    ]
    pending = {
        s: make_pods(num_pending, seed=s, selector_fraction=0.5,
                     toleration_fraction=0.4)
        for s in pending_seeds
    }
    return nodes, existing, pending


def config4_pdbs(num_apps: int = 500, seed: int = 0,
                 max_allowed: int = 2) -> list[PodDisruptionBudget]:
    """One PodDisruptionBudget per `app` label of config #4's workload
    (`app-0` .. `app-{num_apps-1}`), disruptionsAllowed drawn uniformly
    from 0..max_allowed: the PDB variant of the preemption checks (GP =
    num_apps budget groups over the running pods)."""
    rng = np.random.default_rng(seed)
    return [
        PodDisruptionBudget(
            f"pdb-app-{a}", selector=LabelSelector(match_labels={"app": f"app-{a}"}),
            disruptions_allowed=int(rng.integers(0, max_allowed + 1)))
        for a in range(num_apps)
    ]
