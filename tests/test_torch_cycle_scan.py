"""The port's scan-engine latency cycle against the reference's.

`build_cycle_fn(commit_mode="scan", device="cpu")` must give assignment,
node_requested, unschedulable and gang_dropped bit-equal to the
reference's `build_cycle_fn(commit_mode="scan", outputs="latency")` on the
same snapshot (the reference encoder's arrays carried across). Fixtures:
every case of tests/test_minimal_slice.py (its seeded differential
included), tests/test_gang.py, tests/test_interpod.py and
tests/test_plugins.py, rebuilt here with the reference's builders;
config #1-#5-shaped synthetic workloads at a few dozen nodes; the
affinity fixtures of test_torch_interpod (duplicate term slots, bootstrap,
self-anti-affinity, spread skew); host-port contention; node sampling on
more than 100 nodes; profiles that move the score sum. Where the
reference agrees with the sequential oracle (`oracle.schedule`, the
`run_both` check of those test files), the port must too. A snapshot with
volumes schedules through VolumeBinding's per-pod hooks, bit-equal too
(tests/test_torch_cycle_scan_volumes.py holds every volume fixture)."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import k8s_scheduler_tpu.config as ref_config
import k8s_scheduler_tpu.core.cycle as ref_cycle
import k8s_scheduler_tpu.framework.runtime as ref_runtime
import k8s_scheduler_tpu.models as ref_models
import k8s_scheduler_tpu.utils.synth as ref_synth
import k8s_scheduler_tpu_torch.config as port_config
from k8s_scheduler_tpu import oracle
from k8s_scheduler_tpu.models import MakeNode, MakePod, api
from k8s_scheduler_tpu.models.api import (NodeSelectorRequirement, NodeSelectorTerm,
                                          PodGroup)
from k8s_scheduler_tpu_torch.core.cycle import build_cycle_fn
from k8s_scheduler_tpu_torch.framework.runtime import Framework
from k8s_scheduler_tpu_torch.ops import kernel_build
from test_torch_commit import RESOURCE_PROFILES, _profile
from test_torch_cycle import ref_objects
from test_torch_interpod import AFFINITY_FIXTURES, affinity_fixture, carry
from torch_one_thread import one_torch_thread  # noqa: F401

FIELDS = ("assignment", "node_requested", "unschedulable", "gang_dropped")
HOST = "kubernetes.io/hostname"


# --- tests/test_minimal_slice.py -----------------------------------------

def _least_loaded():
    nodes = [MakeNode("n0").capacity({"cpu": "4", "memory": "8Gi"}).obj(),
             MakeNode("n1").capacity({"cpu": "4", "memory": "8Gi"}).obj()]
    existing = [(MakePod("e0").req({"cpu": "2", "memory": "4Gi"}).obj(), "n0")]
    return nodes, [MakePod("p0").req({"cpu": "1", "memory": "1Gi"}).obj()], existing, []


def _capacity_exhaustion():
    nodes = [MakeNode("n0").capacity({"cpu": "2", "memory": "4Gi"}).obj(),
             MakeNode("n1").capacity({"cpu": "8", "memory": "16Gi"}).obj()]
    pods = [MakePod(f"p{i}").req({"cpu": "900m", "memory": "1Gi"}).obj() for i in range(6)]
    return nodes, pods, [], []


def _full():
    nodes = [MakeNode("n0").capacity({"cpu": "1", "memory": "1Gi"}).obj()]
    return nodes, [MakePod(f"p{i}").req({"cpu": "800m"}).obj() for i in range(3)], [], []


def _priority():
    nodes = [MakeNode("n0").capacity({"cpu": "1"}).obj()]
    pods = [MakePod("low").req({"cpu": "800m"}).priority(0).obj(),
            MakePod("high").req({"cpu": "800m"}).priority(100).obj()]
    return nodes, pods, [], []


def _node_name():
    nodes = [MakeNode("n0").capacity({"cpu": "4"}).obj(),
             MakeNode("n1").capacity({"cpu": "4"}).obj()]
    pods = [MakePod("p0").req({"cpu": "1"}).node("n1").obj(),
            MakePod("p1").req({"cpu": "1"}).node("missing").obj()]
    return nodes, pods, [], []


def _cordoned():
    nodes = [MakeNode("n0").capacity({"cpu": "4"}).unschedulable().obj(),
             MakeNode("n1").capacity({"cpu": "4"}).obj()]
    return nodes, [MakePod("p0").req({"cpu": "1"}).obj()], [], []


def _randomized(seed):
    rng = np.random.default_rng(seed)
    n_nodes, n_pods = int(rng.integers(3, 12)), int(rng.integers(5, 40))
    nodes = [MakeNode(f"n{i}").capacity(
        {"cpu": f"{rng.integers(2, 16)}", "memory": f"{rng.integers(4, 32)}Gi"}).obj()
        for i in range(n_nodes)]
    pods = [MakePod(f"p{i}").req({"cpu": f"{rng.integers(100, 3000)}m",
                                  "memory": f"{rng.integers(256, 4096)}Mi"})
            .priority(int(rng.integers(0, 5))).created(float(rng.integers(0, 100))).obj()
            for i in range(n_pods)]
    existing = [(MakePod(f"e{i}").req({"cpu": f"{rng.integers(100, 2000)}m"}).obj(),
                 f"n{rng.integers(0, n_nodes)}") for i in range(int(rng.integers(0, 10)))]
    return nodes, pods, existing, []


MINIMAL = {"least_loaded": _least_loaded, "capacity_exhaustion": _capacity_exhaustion,
           "unschedulable_when_full": _full, "priority_order": _priority,
           "node_name_pin": _node_name, "cordoned_node": _cordoned,
           **{f"randomized_{s}": functools.partial(_randomized, s) for s in range(5)}}


# --- tests/test_gang.py ---------------------------------------------------

def _gang(n_nodes, cpu, members, min_member, group="job", req="2"):
    nodes = [MakeNode(f"n{i}").capacity({"cpu": cpu}).obj() for i in range(n_nodes)]
    pods = [MakePod(f"g-{i}").req({"cpu": req}).group(group).created(i).obj()
            for i in range(members)]
    return nodes, pods, [], [PodGroup("job", min_member)] if min_member else []


def _two_gangs():
    nodes = [MakeNode("n0").capacity({"cpu": "4"}).obj()]
    a = [MakePod(f"a-{i}").req({"cpu": "2"}).group("a").priority(5).created(i).obj()
         for i in range(2)]
    b = [MakePod(f"b-{i}").req({"cpu": "2"}).group("b").priority(1).created(10 + i).obj()
         for i in range(2)]
    return nodes, a + b, [], [PodGroup("a", 2), PodGroup("b", 2)]


def _synth_gangs():
    pods, groups = ref_synth.make_gang_pods(4, replicas=4)
    nodes = [MakeNode(f"n{i}").capacity({"cpu": "8", "memory": "16Gi"}).obj()
             for i in range(6)]
    return nodes, pods, [], groups


def _running_members():
    nodes = [MakeNode("n0").capacity({"cpu": "8"}).obj()]
    existing = [(MakePod(f"g-{i}").req({"cpu": "2"}).group("job").created(i).obj(), "n0")
                for i in range(2)]
    pods = [MakePod("g-2").req({"cpu": "2"}).group("job").created(2).obj()]
    return nodes, pods, existing, [PodGroup("job", 3)]


def _gang_preempt():
    nodes = [MakeNode("n0").capacity({"cpu": "2"}).obj(),
             MakeNode("n1").capacity({"cpu": "2"}).obj()]
    existing = [(MakePod("low").req({"cpu": "2"}).priority(0).obj(), "n1")]
    pods = [MakePod(f"g-{i}").req({"cpu": "2"}).group("job").priority(10).created(i).obj()
            for i in range(2)]
    return nodes, pods, existing, [PodGroup("job", 2)]


GANG = {"gang_fits": lambda: _gang(4, "4", 4, 4),
        "gang_unwound": lambda: _gang(1, "4", 3, 3),
        "gang_partial_min_member": lambda: _gang(1, "4", 3, 2),
        "gang_undeclared": lambda: _gang(1, "2", 2, 0, group="mystery"),
        "two_gangs": _two_gangs, "synth_gangs": _synth_gangs,
        "gang_running_members": _running_members, "gang_dropped_preempt": _gang_preempt}


# --- tests/test_interpod.py -----------------------------------------------

def _zones(per_zone=2, zones=("za", "zb"), cpu="8"):
    return [MakeNode(f"{z}-n{i}").capacity({"cpu": cpu, "memory": "16Gi"})
            .labels({"zone": z}).obj() for z in zones for i in range(per_zone)]


def _p(name, app=None, cpu="1"):
    b = MakePod(name).req({"cpu": cpu})
    return b.labels({"app": app}) if app else b


def _interpod(name):
    nodes, existing = _zones(), []
    if name == "affinity_follows_existing":
        existing = [(_p("db", "db").obj(), "zb-n0")]
        pods = [_p("web").pod_affinity("zone", {"app": "db"}).obj()]
    elif name == "affinity_no_match":
        pods = [_p("web").pod_affinity("zone", {"app": "db"}).obj()]
    elif name == "affinity_bootstrap":
        pods = [_p("web", "web").pod_affinity("zone", {"app": "web"}).obj()]
    elif name == "affinity_chain":
        pods = [_p("leader", "grp").priority(10).created(0).obj(),
                _p("follower").created(1).pod_affinity("zone", {"app": "grp"}).obj()]
    elif name == "anti_by_hostname":
        pods = [_p(f"r{i}", "api").created(i).pod_affinity(HOST, {"app": "api"}, anti=True)
                .obj() for i in range(5)]
    elif name == "symmetric_anti_existing":
        existing = [(_p("loner", "loner").pod_affinity("zone", {"app": "web"}, anti=True)
                     .obj(), "za-n0")]
        pods = [_p("web", "web").obj()]
    elif name == "symmetric_anti_batch":
        pods = [_p("loner", "loner").priority(10)
                .pod_affinity("zone", {"app": "web"}, anti=True).obj(), _p("web", "web").obj()]
    elif name == "preferred_together":
        existing = [(_p("cache", "cache").obj(), "zb-n1")]
        pods = [_p("web").pod_affinity("zone", {"app": "cache"}, weight=80).obj()]
    elif name == "preferred_apart":
        existing = [(_p("noisy", "noisy").obj(), "za-n0")]
        pods = [_p("quiet").pod_affinity("zone", {"app": "noisy"}, anti=True, weight=80).obj()]
    elif name == "spread_do_not_schedule":
        pods = [_p(f"w{i}", "spread").created(i).spread(1, "zone", {"app": "spread"}).obj()
                for i in range(4)]
    elif name == "spread_schedule_anyway":
        existing = [(_p(f"e{i}", "s").obj(), "za-n0") for i in range(3)]
        pods = [_p("w", "s").spread(1, "zone", {"app": "s"},
                                    when_unsatisfiable=api.SCHEDULE_ANYWAY).obj()]
    elif name == "namespace_scoping":
        existing = [(MakePod("db-other", namespace="other").labels({"app": "db"})
                     .req({"cpu": "1"}).obj(), "za-n0")]
        pods = [_p("web").pod_affinity("zone", {"app": "db"}).obj()]
    else:
        raise ValueError(name)
    return nodes, pods, existing, []


def _interpod_randomized(seed):
    rng = np.random.default_rng(200 + seed)
    zones = ["za", "zb", "zc"]
    n_nodes = int(rng.integers(4, 10))
    nodes = [MakeNode(f"n{i}").capacity(
        {"cpu": f"{rng.integers(4, 16)}", "memory": f"{rng.integers(8, 32)}Gi"})
        .labels({"zone": zones[i % 3]}).obj() for i in range(n_nodes)]
    apps = [f"app-{j}" for j in range(4)]
    existing = [(MakePod(f"e{i}").labels({"app": apps[int(rng.integers(0, 4))]})
                 .req({"cpu": "500m"}).obj(), f"n{int(rng.integers(0, n_nodes))}")
                for i in range(int(rng.integers(0, 8)))]
    pods = []
    for i in range(int(rng.integers(4, 16))):
        app = apps[int(rng.integers(0, 4))]
        b = (MakePod(f"p{i}").labels({"app": app})
             .req({"cpu": f"{rng.integers(200, 2000)}m"})
             .priority(int(rng.integers(0, 3))).created(float(i)))
        r = rng.random()
        target = apps[int(rng.integers(0, 4))]
        if r < 0.25:
            b.pod_affinity("zone", {"app": target})
        elif r < 0.5:
            b.pod_affinity(HOST, {"app": target}, anti=True)
        elif r < 0.65:
            b.pod_affinity("zone", {"app": target}, weight=int(rng.integers(10, 90)))
        elif r < 0.8:
            b.spread(int(rng.integers(1, 3)), "zone", {"app": app})
        pods.append(b.obj())
    return nodes, pods, existing, []


INTERPOD_NAMES = ["affinity_follows_existing", "affinity_no_match", "affinity_bootstrap",
                  "affinity_chain", "anti_by_hostname", "symmetric_anti_existing",
                  "symmetric_anti_batch", "preferred_together", "preferred_apart",
                  "spread_do_not_schedule", "spread_schedule_anyway", "namespace_scoping"]
INTERPOD = {**{n: functools.partial(_interpod, n) for n in INTERPOD_NAMES},
            **{f"interpod_randomized_{s}": functools.partial(_interpod_randomized, s)
               for s in range(6)}}


# --- tests/test_plugins.py ------------------------------------------------

def _req(key, op, *vals):
    return NodeSelectorTerm((NodeSelectorRequirement(key, op, tuple(vals)),))


def _plugins(name):
    existing = []
    if name == "node_selector":
        nodes = [MakeNode("gen").capacity({"cpu": "4"}).labels({"type": "general"}).obj(),
                 MakeNode("cmp").capacity({"cpu": "4"}).labels({"type": "compute"}).obj()]
        pods = [MakePod(f"p{i}").req({"cpu": "1"}).node_selector({"type": t}).obj()
                for i, t in enumerate(("compute", "general", "gpu"))]
    elif name == "node_affinity_in_notin":
        nodes = [MakeNode("a").capacity({"cpu": "4"}).labels({"zone": "east"}).obj(),
                 MakeNode("b").capacity({"cpu": "4"}).labels({"zone": "west"}).obj(),
                 MakeNode("c").capacity({"cpu": "4"}).obj()]
        pods = [MakePod("in-east").req({"cpu": "1"}).node_affinity_in("zone", ["east"]).obj(),
                MakePod("not-east").req({"cpu": "1"}).node_affinity_required(
                    _req("zone", api.OP_NOT_IN, "east")).obj(),
                MakePod("exists").req({"cpu": "1"}).node_affinity_required(
                    _req("zone", api.OP_EXISTS)).obj(),
                MakePod("not-exists").req({"cpu": "1"}).node_affinity_required(
                    _req("zone", api.OP_DOES_NOT_EXIST)).obj()]
    elif name == "node_affinity_gt_lt":
        nodes = [MakeNode(n).capacity({"cpu": "4"}).labels({"size": s}).obj()
                 for n, s in (("small", "10"), ("big", "100"), ("odd", "huge"))]
        pods = [MakePod("gt50").req({"cpu": "1"}).node_affinity_required(
                    _req("size", api.OP_GT, "50")).obj(),
                MakePod("lt50").req({"cpu": "1"}).node_affinity_required(
                    _req("size", api.OP_LT, "50")).obj()]
    elif name == "node_affinity_or":
        nodes = [MakeNode("a").capacity({"cpu": "4"}).labels({"zone": "east"}).obj(),
                 MakeNode("b").capacity({"cpu": "4"}).labels({"tier": "gold"}).obj(),
                 MakeNode("c").capacity({"cpu": "4"}).obj()]
        pods = [MakePod("p").req({"cpu": "1"}).node_affinity_required(
                    _req("zone", api.OP_IN, "east"), _req("tier", api.OP_IN, "gold")).obj()
                for _ in range(3)]
    elif name == "node_affinity_preferred":
        nodes = [MakeNode("plain").capacity({"cpu": "8"}).obj(),
                 MakeNode("ssd").capacity({"cpu": "8"}).labels({"disk": "ssd"}).obj()]
        pods = [MakePod("p").req({"cpu": "1"}).node_affinity_preferred(100, "disk", ["ssd"])
                .obj()]
    elif name == "taints":
        nodes = [MakeNode("tainted").capacity({"cpu": "8"}).taint("gpu", "yes").obj(),
                 MakeNode("open").capacity({"cpu": "2"}).obj()]
        pods = [MakePod("tolerant").req({"cpu": "1"})
                .toleration("gpu", "yes", api.NO_SCHEDULE).obj()] + [
                MakePod(f"plain-{i}").req({"cpu": "1"}).obj() for i in range(1, 4)]
    elif name == "toleration_exists":
        nodes = [MakeNode("t1").capacity({"cpu": "4"}).taint("a", "1").obj(),
                 MakeNode("t2").capacity({"cpu": "4"}).taint("b", "2", api.NO_EXECUTE).obj()]
        pods = [MakePod("ex").req({"cpu": "1"}).toleration("a", op="Exists").obj(),
                MakePod("wild").req({"cpu": "1"}).toleration("", op="Exists").obj(),
                MakePod("none").req({"cpu": "1"}).obj()]
    elif name == "prefer_no_schedule":
        nodes = [MakeNode("soft").capacity({"cpu": "8"})
                 .taint("maint", "true", api.PREFER_NO_SCHEDULE).obj(),
                 MakeNode("clean").capacity({"cpu": "8"}).obj()]
        pods = [MakePod("p").req({"cpu": "1"}).obj()]
    elif name == "host_ports_existing":
        nodes = [MakeNode(f"n{i}").capacity({"cpu": "8"}).obj() for i in range(2)]
        existing = [(MakePod("web").req({"cpu": "1"}).host_port(80).obj(), "n0")]
        pods = [MakePod("also-web").req({"cpu": "1"}).host_port(80).obj()]
    elif name == "image_locality":
        img = "registry/model-server:v1"
        nodes = [MakeNode("cold").capacity({"cpu": "8"}).obj(),
                 MakeNode("warm").capacity({"cpu": "8"}).image(img, 800 * 2**20).obj()]
        pods = [MakePod("p").req({"cpu": "1"}).image(img).obj()]
    elif name == "host_ports_batch":
        nodes = [MakeNode(f"n{i}").capacity({"cpu": "8"}).obj() for i in range(2)]
        pods = [MakePod(f"web-{c}").req({"cpu": "1"}).host_port(80).created(i).obj()
                for i, c in enumerate("abc")]
    else:
        raise ValueError(name)
    return nodes, pods, existing, []


def _plugins_randomized(seed):
    rng = np.random.default_rng(100 + seed)
    n_nodes = int(rng.integers(3, 10))
    zones = ["za", "zb", "zc"]
    nodes = []
    for i in range(n_nodes):
        b = MakeNode(f"n{i}").capacity(
            {"cpu": f"{rng.integers(2, 16)}", "memory": f"{rng.integers(4, 32)}Gi"}
        ).labels({"zone": zones[i % 3], "idx": str(i)})
        if rng.random() < 0.3:
            b.taint("dedicated", "x")
        if rng.random() < 0.2:
            b.unschedulable()
        nodes.append(b.obj())
    pods = []
    for i in range(int(rng.integers(5, 25))):
        b = MakePod(f"p{i}").req({"cpu": f"{rng.integers(100, 3000)}m",
                                  "memory": f"{rng.integers(256, 2048)}Mi"}
                                 ).priority(int(rng.integers(0, 3))).created(float(i))
        r = rng.random()
        if r < 0.3:
            b.node_affinity_in("zone", [zones[int(rng.integers(0, 3))]])
        elif r < 0.5:
            b.node_selector({"zone": zones[int(rng.integers(0, 3))]})
        if rng.random() < 0.4:
            b.toleration("dedicated", "x", api.NO_SCHEDULE)
        if rng.random() < 0.3:
            b.node_affinity_preferred(int(rng.integers(1, 100)), "zone",
                                      [zones[int(rng.integers(0, 3))]])
        pods.append(b.obj())
    return nodes, pods, [], []


PLUGIN_NAMES = ["node_selector", "node_affinity_in_notin", "node_affinity_gt_lt",
                "node_affinity_or", "node_affinity_preferred", "taints",
                "toleration_exists", "prefer_no_schedule", "host_ports_existing",
                "image_locality", "host_ports_batch"]
PLUGINS = {**{n: functools.partial(_plugins, n) for n in PLUGIN_NAMES},
           **{f"plugins_randomized_{s}": functools.partial(_plugins_randomized, s)
              for s in range(8)}}

def _cfg4_tenth():
    """BASELINE config #4's workload (`bench_suite.make_config_workload(4)`)
    cut to a tenth of its scale: 500 nodes, 1200 running and 1000 pending
    pods over 50 apps, the pending mix of seed 202. A thousand dependent
    steps, with the spread and affinity counts growing over the scan."""
    nodes = ref_synth.make_cluster(500, taint_fraction=0.1, cpu_choices=(4, 8, 16))
    running = ref_synth.make_pods(1200, seed=991, name_prefix="run", affinity_fraction=0.1,
                                  spread_fraction=0.1, num_apps=50)
    pods = ref_synth.make_pods(1000, seed=202, affinity_fraction=0.3,
                               anti_affinity_fraction=0.2, spread_fraction=0.2,
                               selector_fraction=0.3, toleration_fraction=0.1,
                               priorities=(0, 0, 10, 100), num_apps=50)
    return nodes, pods, [(p, f"node-{i % 500}") for i, p in enumerate(running)], []


# synthetic configs #1-#5 and the port's other cycle fixtures
SYNTH = {**{f"{n}": functools.partial(ref_objects, n)
            for n in ("cfg1", "cfg2", "cfg5", "mixed", "nominated", "hostport", "sampled",
                      "c1")},
         "cfg4_tenth": _cfg4_tenth,
         **{f"affinity_{n}": functools.partial(affinity_fixture, n, ref_models, ref_synth)
            for n in AFFINITY_FIXTURES}}

FIXTURES = {**MINIMAL, **GANG, **INTERPOD, **PLUGINS, **SYNTH}
# oracle rules of the reference's own test files
_ORACLE_WEIGHTS = set(MINIMAL)
_GANGS = set(GANG)


@functools.cache
def _ref_cycle(kw: tuple):
    return ref_cycle.build_cycle_fn(commit_mode="scan", outputs="latency", **dict(kw))


def run_both(name, kw=None, profile="default"):
    """(objects, reference decision, port decision, port snapshot), computed
    once per (name, kw, profile) in this file: the bit-equality and oracle
    tests read the same runs. Read-only."""
    return _run_both(name, tuple(sorted((kw or {}).items())), profile)


@functools.cache
def _run_both(name, kw_items, profile):
    return _run_both_fresh(name, dict(kw_items), profile)


def _run_both_fresh(name, kw=None, profile="default"):
    kw = dict(kw or {})
    nodes, pods, existing, groups = FIXTURES[name]()
    ref_snap = ref_models.SnapshotEncoder().encode(nodes, pods, existing, groups)
    ref_kw, port_kw = dict(kw), dict(kw)
    if profile != "default":
        ref_kw["framework"] = ref_runtime.Framework.from_config(_profile(ref_config, profile))
        port_kw["framework"] = Framework.from_config(_profile(port_config, profile))
        want = ref_cycle.build_cycle_fn(commit_mode="scan", outputs="latency", **ref_kw)(
            ref_snap)
    else:
        want = _ref_cycle(tuple(sorted(kw.items())))(ref_snap)
    port_snap = carry(ref_snap)
    got = build_cycle_fn(commit_mode="scan", outputs="latency", device="cpu", **port_kw)(port_snap)
    return (nodes, pods, existing, groups), want, got, port_snap


def assert_same(got, want):
    for field in FIELDS:
        w = np.asarray(getattr(want, field))
        g = getattr(got, field).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)


def _oracle(name, objs):
    nodes, pods, existing, groups = objs
    if name in _GANGS:
        want, _ = oracle.schedule_with_gangs(nodes, pods, existing, groups)
    elif name in _ORACLE_WEIGHTS:
        want = oracle.schedule(nodes, pods, existing, weights=oracle.OracleWeights())
    else:
        want = oracle.schedule(nodes, pods, existing)
    return [d.node_index for d in want]


ORACLE_CASES = list(MINIMAL) + list(GANG) + list(INTERPOD) + list(PLUGINS)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_scan_cycle_bit_equal_to_reference(name):
    objs, want, got, _ = run_both(name)
    assert_same(got, want)
    a = got.assignment.numpy()[: len(objs[1])]
    assert (got.placed_round.numpy() == np.where(got.assignment.numpy() >= 0, 0, -1)).all()
    if name == "gang_unwound":
        assert got.gang_dropped.any() and (a == -1).all()
    if name in ("hostport", "host_ports_batch"):
        placed = a[a >= 0]
        assert len(placed) == len(set(placed.tolist())) > 0  # one pod per node
    if name == "affinity_self_anti":
        placed = a[a >= 0]
        assert len(placed) == 4 == len(set(placed.tolist()))


@pytest.mark.parametrize("name", ORACLE_CASES)
def test_scan_cycle_agrees_with_the_oracle_where_the_reference_does(name):
    """The reference test files' `run_both`: the sequential oracle's
    decisions, or (their randomized cases) its trajectory validation."""
    objs, want, got, _ = run_both(name)
    nodes, pods, existing, _ = objs
    ref_a = np.asarray(want.assignment)[: len(pods)].tolist()
    port_a = got.assignment.numpy()[: len(pods)].tolist()
    expect = _oracle(name, objs)
    if ref_a == expect:
        assert port_a == expect
    elif name not in _GANGS:
        # f32 near-ties: the reference's own tests validate the trajectory
        weights = oracle.OracleWeights() if name in _ORACLE_WEIGHTS else None
        kw = {"weights": weights} if weights else {}
        ref_errors = oracle.validate_assignment(nodes, pods, ref_a, existing, **kw)
        if not ref_errors:
            assert oracle.validate_assignment(nodes, pods, port_a, existing, **kw) == []


KW_CASES = {
    "sampled_pct30": ("sampled", {"percentage_of_nodes_to_score": 30}),
    "gang_disabled": ("gang_unwound", {"gang_scheduling": False}),
    "cfg5_gang_disabled": ("cfg5", {"gang_scheduling": False}),
}


@pytest.mark.parametrize("case", list(KW_CASES))
def test_scan_cycle_options_bit_equal_to_reference(case):
    name, kw = KW_CASES[case]
    objs, want, got, snap = run_both(name, kw)
    assert_same(got, want)
    if case == "sampled_pct30":
        assert int(snap.num_nodes) > 100 and (got.assignment >= 0).any()
    if case == "gang_disabled":
        assert not got.gang_dropped.any() and int((got.assignment >= 0).sum()) == 2


PROFILE_CASES = [(f, p) for f in ("affinity_duplicates", "affinity_cfg4", "cfg2")
                 for p in ("weighted", "no_balanced", "balanced_static", "most_cpu")] + [
    (f, p) for f in ("c1", "affinity_cfg4") for p in RESOURCE_PROFILES]


@pytest.mark.parametrize("name,profile", PROFILE_CASES)
def test_scan_cycle_under_other_profiles(name, profile):
    _, want, got, _ = run_both(name, profile=profile)
    assert_same(got, want)


def test_scan_cycle_launches_no_kernel_on_cpu():
    kernel_build.reset_launch_counts()
    _, want, got, _ = _run_both_fresh("affinity_cfg4")
    assert_same(got, want)
    assert all(v == 0 for v in kernel_build.launch_counts.values())


@pytest.mark.parametrize("bound", [True, False])
def test_scan_cycle_refuses_volumes(bound):
    """A snapshot with volumes schedules through VolumeBinding's per-pod
    hooks, bit-equal to the reference's scan (a bound claim on a PV without
    affinity places, an unbound Immediate claim does not); without the
    plugin in the profile the scan runs too (and ignores volumes, as the
    reference does)."""
    from k8s_scheduler_tpu.models.api import (PersistentVolume, PersistentVolumeClaim,
                                              StorageClass)

    pvc = PersistentVolumeClaim("data", storage_class="fast", request=1.0,
                                volume_name="pv0" if bound else "")
    pv = PersistentVolume("pv0", capacity=2.0, storage_class="fast",
                          claim_ref="default/data" if bound else "")
    ref_snap = ref_models.SnapshotEncoder().encode(
        ref_synth.make_cluster(8), [MakePod("p").req({"cpu": "1"}).volume("data").obj()],
        pvcs=[pvc], pvs=[pv], storage_classes=[StorageClass("fast")])
    snap = carry(ref_snap)
    assert snap.has_volumes
    got_vb = build_cycle_fn(commit_mode="scan", outputs="latency", device="cpu")(snap)
    assert_same(got_vb, ref_cycle.build_cycle_fn(commit_mode="scan", outputs="latency")(ref_snap))
    assert (int(got_vb.assignment[0]) >= 0) == bound
    cfg = [port_config, ref_config]
    no_vb = [c.SchedulerConfiguration(profiles=[c.Profile(plugins=c.Plugins(
        filter=c.PluginSet(disabled=["VolumeBinding"])))]) for c in cfg]
    got = build_cycle_fn(Framework.from_config(no_vb[0]), commit_mode="scan",
                         outputs="latency", device="cpu")(snap)
    want = ref_cycle.build_cycle_fn(ref_runtime.Framework.from_config(no_vb[1]),
                                    commit_mode="scan", outputs="latency")(ref_snap)
    assert_same(got, want)
    assert int(got.assignment[0]) >= 0


def test_scan_entry_point_on_cpu():
    """The library boundary with the port's own builders: an anti-affine
    pair split across hosts and a pod that must join it, placed one at a
    time."""
    from k8s_scheduler_tpu_torch.models import MakeNode as PNode
    from k8s_scheduler_tpu_torch.models import MakePod as PPod
    from k8s_scheduler_tpu_torch.models import SnapshotEncoder

    nodes = [PNode(f"n{i}").capacity({"cpu": "4"})
             .labels({HOST: f"n{i}", "topology.kubernetes.io/zone": "z0" if i < 2 else "z1"})
             .obj() for i in range(4)]
    pods = [PPod("db-0").req({"cpu": "1"}).labels({"app": "db"})
            .pod_affinity(HOST, {"app": "db"}, anti=True).obj(),
            PPod("db-1").req({"cpu": "1"}).labels({"app": "db"})
            .pod_affinity(HOST, {"app": "db"}, anti=True).created(1.0).obj(),
            PPod("web").req({"cpu": "1"}).labels({"app": "web"})
            .pod_affinity("topology.kubernetes.io/zone", {"app": "db"}).created(2.0).obj()]
    snap = SnapshotEncoder(device="cpu").encode(nodes, pods)
    d = build_cycle_fn(commit_mode="scan", outputs="latency", device="cpu")(snap)
    a = d.assignment[:3].tolist()
    assert min(a) >= 0 and a[0] != a[1]
    assert (a[2] < 2) == (a[0] < 2) or (a[2] < 2) == (a[1] < 2)
    assert torch.equal(d.placed_round[:3], torch.zeros(3, dtype=torch.int32))
