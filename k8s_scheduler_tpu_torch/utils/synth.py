"""Synthetic cluster generation (the port's own copy of
`k8s_scheduler_tpu/utils/synth.py`: the same seed draws the same objects,
which the differential tests rely on) — the fixture generator for unit, property,
and perf tests alike (SURVEY.md §4: nodes are just API objects, "multi-node"
needs no machines; this mirrors upstream scheduler_perf's YAML workload
templates as parameterized generators)."""

from __future__ import annotations

import dataclasses

import numpy as np

from ..models.api import (
    VOLUME_BINDING_WAIT,
    LabelSelector,
    Node,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    PodDisruptionBudget,
    PodGroup,
    StorageClass,
)
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


GiB = 2**30
LOCAL_CLASS = "local-storage"
ZONAL_CLASS = "zonal-ssd"
ZONE_KEY = "topology.kubernetes.io/zone"
HOST_KEY = "kubernetes.io/hostname"


def _with_volumes(p: Pod, claims: tuple[str, ...]) -> Pod:
    """A copy of `p` that mounts `claims` (the input pod is untouched)."""
    return dataclasses.replace(
        p, spec=dataclasses.replace(p.spec, volumes=p.spec.volumes + claims))


def config4_volumes(
    nodes: list[Node],
    existing: list[tuple[Pod, str]],
    pending: list[Pod],
    seed: int = 0,
) -> tuple[list[tuple[Pod, str]], list[Pod], list[PersistentVolumeClaim],
           list[PersistentVolume], list[StorageClass]]:
    """Local and zonal persistent volumes drawn onto config #4's workload
    (`config4_workload`), after two public deployments:

    - the Kubernetes docs' local-volume StorageClass
      (kubernetes.io/docs/concepts/storage/storage-classes/#local:
      no-provisioner, WaitForFirstConsumer), as sig-storage-local-static-
      provisioner deploys it: class `local-storage`, two PVs per node
      pinned by `kubernetes.io/hostname`, capacity drawn from {100, 200,
      400} GiB; a running pod i on node k = i % n in block b = i // n holds
      a bound PVC on its node's first free local PV iff (k + b) % 4 == 0
      (a quarter of the running pods, at most one per node at config #4's
      size);
    - the pre-bound, zone-pinned PV/PVC pairs of upstream
      test/integration/scheduler_perf (its PV cases such as
      SchedulingCSIPVs): class `zonal-ssd` (provisioner, WaitForFirstConsumer,
      allowedTopologies = the first two zones), one 100 GiB PV per pair
      pinned to a zone drawn uniformly.

    A seeded permutation of the pending pods picks 20% that mount one
    unbound `local-storage` PVC (request from {50, 150, 300} GiB), 5% that
    mount two (data from {50, 150, 300} GiB and a 50 GiB wal: multi-volume),
    10% that mount one pre-bound zonal PVC, and 5% that mount one unbound
    `zonal-ssd` PVC (dynamic provisioning). Returns (existing, pending,
    pvcs, pvs, storage_classes): the pod lists with copies of the pods that
    mount volumes; nothing passed in is modified."""
    rng = np.random.default_rng(seed)
    n = len(nodes)
    classes = [
        StorageClass(LOCAL_CLASS, VOLUME_BINDING_WAIT, provisioner=False),
        StorageClass(ZONAL_CLASS, VOLUME_BINDING_WAIT, provisioner=True,
                     allowed_topologies=(NodeSelectorTerm((
                         NodeSelectorRequirement(ZONE_KEY, "In",
                                                 tuple(ZONES[:2])),)),)),
    ]
    caps = rng.choice([100, 200, 400], size=2 * n)
    pvs = [
        PersistentVolume(
            f"local-{nd.name}-{j}", capacity=float(caps[2 * i + j] * GiB),
            storage_class=LOCAL_CLASS,
            node_affinity=(NodeSelectorTerm((
                NodeSelectorRequirement(HOST_KEY, "In", (nd.name,)),)),))
        for i, nd in enumerate(nodes) for j in range(2)
    ]
    pv_index = {nd.name: 2 * i for i, nd in enumerate(nodes)}
    pvcs: list[PersistentVolumeClaim] = []
    used: dict[str, int] = {}
    existing_out = []
    for i, (p, node_name) in enumerate(existing):
        k = pv_index.get(node_name)
        if k is not None and (i % n + i // n) % 4 == 0 and used.get(node_name, 0) < 2:
            pv = pvs[k + used.get(node_name, 0)]
            used[node_name] = used.get(node_name, 0) + 1
            claim = f"{p.name}-data"
            pvcs.append(PersistentVolumeClaim(
                claim, p.namespace, LOCAL_CLASS, pv.capacity, volume_name=pv.name))
            pv.claim_ref = f"{p.namespace}/{claim}"
            p = _with_volumes(p, (claim,))
        existing_out.append((p, node_name))

    m = len(pending)
    order = rng.permutation(m)
    cuts = np.cumsum([int(m * f) for f in (0.20, 0.05, 0.10, 0.05)])
    kind = np.full(m, -1)
    for c, (lo, hi) in enumerate(zip(np.r_[0, cuts[:-1]], cuts)):
        kind[order[lo:hi]] = c
    sizes = rng.choice([50, 150, 300], size=m)
    zones = rng.integers(0, len(ZONES), size=m)
    pending_out = []
    for i, p in enumerate(pending):
        c = int(kind[i])
        if c < 0:
            pending_out.append(p)
            continue
        ns = p.namespace
        if c in (0, 1):  # unbound local: data (and wal)
            claims = [(f"{p.name}-data", float(sizes[i] * GiB))]
            if c == 1:
                claims.append((f"{p.name}-wal", float(50 * GiB)))
            for name, req in claims:
                pvcs.append(PersistentVolumeClaim(name, ns, LOCAL_CLASS, req))
        elif c == 2:  # pre-bound zonal pair
            name = f"{p.name}-zonal"
            pv = PersistentVolume(
                f"zonal-{p.name}", capacity=float(100 * GiB),
                storage_class=ZONAL_CLASS,
                node_affinity=(NodeSelectorTerm((NodeSelectorRequirement(
                    ZONE_KEY, "In", (ZONES[int(zones[i])],)),)),),
                claim_ref=f"{ns}/{name}")
            pvs.append(pv)
            pvcs.append(PersistentVolumeClaim(name, ns, ZONAL_CLASS,
                                              float(100 * GiB), volume_name=pv.name))
            claims = [(name, 0.0)]
        else:  # unbound zonal: dynamic provisioning
            name = f"{p.name}-scratch"
            pvcs.append(PersistentVolumeClaim(name, ns, ZONAL_CLASS,
                                              float(sizes[i] * GiB)))
            claims = [(name, 0.0)]
        pending_out.append(_with_volumes(p, tuple(nm for nm, _ in claims)))
    return existing_out, pending_out, pvcs, pvs, classes
