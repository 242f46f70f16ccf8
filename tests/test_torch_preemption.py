"""The port's DefaultPreemption against the reference's.

On the same snapshot (the reference encoder's arrays carried across) and
the same cycle decision (the rounds-engine latency cycle, bit-equal in both
packages, checked here again), the port's `build_preemption_fn(device=
"cpu")` must give `nominated`, `victims` and `num_preemptors` bit-equal to
the reference's `build_preemption_fn`. Fixtures: every case of
tests/test_preemption.py and tests/test_preemption_whatif.py (PDB budgets
and last-resort violations, victim-set minimality, tie-breaks, static
gates, anti-affinity, host ports, winner-held ports, spread, required
affinity, symmetric owners), rebuilt with each package's own builders; a
config #4-shaped synthetic workload with and without PDBs; non-dyadic
memory requests on a node of 20 victims (the prefix-sum order);
priorities near 2^31 (the i32 wrap of the victim priority sum); more
than 64 pods on a node; and a budget / scan_budget override. The port's own encoder must give the same
PDB fields as the reference's on the PDB fixtures."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import k8s_scheduler_tpu.config as ref_config
import k8s_scheduler_tpu.core.cycle as ref_cycle
import k8s_scheduler_tpu.framework.runtime as ref_runtime
import k8s_scheduler_tpu.models as ref_models
import k8s_scheduler_tpu.models.api as ref_api
import k8s_scheduler_tpu.utils.synth as ref_synth
import k8s_scheduler_tpu_torch.config as port_config
import k8s_scheduler_tpu_torch.models as port_models
import k8s_scheduler_tpu_torch.models.api as port_api
import k8s_scheduler_tpu_torch.utils.synth as port_synth
from k8s_scheduler_tpu_torch.core.cycle import build_cycle_fn, build_preemption_fn
from k8s_scheduler_tpu_torch.framework.runtime import Framework
from k8s_scheduler_tpu_torch.ops import kernel_build, preemption
from test_torch_encoding import assert_same_snapshot
from test_torch_interpod import carry
from torch_one_thread import one_torch_thread  # noqa: F401

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


class Pkg:
    """One package's builders, API types, synth and config."""

    def __init__(self, models, api, synth, config):
        self.MakeNode, self.MakePod = models.MakeNode, models.MakePod
        self.SnapshotEncoder = models.SnapshotEncoder
        self.LabelSelector, self.PDB = api.LabelSelector, api.PodDisruptionBudget
        self.synth, self.config = synth, config


REF = Pkg(ref_models, ref_api, ref_synth, ref_config)
PORT = Pkg(port_models, port_api, port_synth, port_config)


def _pdb(m, name, app, allowed):
    return m.PDB(name, selector=m.LabelSelector(match_labels={"app": app}),
                 disruptions_allowed=allowed)


# ---- tests/test_preemption.py --------------------------------------------

def _basic(m):
    nodes = [m.MakeNode("n0").capacity({"cpu": "2"}).obj()]
    existing = [(m.MakePod("victim-lo").req({"cpu": "1"}).priority(1).obj(), "n0"),
                (m.MakePod("bystander").req({"cpu": "900m"}).priority(5).obj(), "n0")]
    return nodes, [m.MakePod("urgent").req({"cpu": "1"}).priority(10).obj()], existing, []


def _higher_priority(m):
    nodes = [m.MakeNode("n0").capacity({"cpu": "2"}).obj()]
    existing = [(m.MakePod("e0").req({"cpu": "1800m"}).priority(100).obj(), "n0")]
    return nodes, [m.MakePod("p0").req({"cpu": "1"}).priority(10).obj()], existing, []


def _policy_never(m):
    nodes = [m.MakeNode("n0").capacity({"cpu": "2"}).obj()]
    existing = [(m.MakePod("e0").req({"cpu": "1800m"}).priority(1).obj(), "n0")]
    pods = [m.MakePod("p0").req({"cpu": "1"}).priority(10).preemption_policy("Never").obj()]
    return nodes, pods, existing, []


def _minimal_victims(m):
    nodes = [m.MakeNode("n0").capacity({"cpu": "3"}).obj()]
    existing = [(m.MakePod("v0").req({"cpu": "1"}).priority(1).obj(), "n0"),
                (m.MakePod("v1").req({"cpu": "1"}).priority(2).obj(), "n0"),
                (m.MakePod("v2").req({"cpu": "900m"}).priority(8).obj(), "n0")]
    return nodes, [m.MakePod("p0").req({"cpu": "1"}).priority(10).obj()], existing, []


def _cheapest_victims(m):
    nodes = [m.MakeNode(f"n{i}").capacity({"cpu": "1"}).obj() for i in range(2)]
    existing = [(m.MakePod("a").req({"cpu": "1"}).priority(5).obj(), "n0"),
                (m.MakePod("b").req({"cpu": "1"}).priority(1).obj(), "n1")]
    return nodes, [m.MakePod("p0").req({"cpu": "1"}).priority(10).obj()], existing, []


def _two_preemptors(m):
    nodes = [m.MakeNode("n0").capacity({"cpu": "2"}).obj()]
    existing = [(m.MakePod("v0").req({"cpu": "1"}).priority(1).obj(), "n0"),
                (m.MakePod("v1").req({"cpu": "1"}).priority(2).obj(), "n0")]
    pods = [m.MakePod("p0").req({"cpu": "1"}).priority(10).created(1).obj(),
            m.MakePod("p1").req({"cpu": "1"}).priority(9).created(2).obj()]
    return nodes, pods, existing, []


def _out_of_victims(m):
    nodes = [m.MakeNode("n0").capacity({"cpu": "2"}).obj()]
    existing = [(m.MakePod("v0").req({"cpu": "2"}).priority(1).obj(), "n0")]
    pods = [m.MakePod("p0").req({"cpu": "2"}).priority(10).created(1).obj(),
            m.MakePod("p1").req({"cpu": "2"}).priority(9).created(2).obj()]
    return nodes, pods, existing, []


def _static_gate(m):
    nodes = [m.MakeNode("n0").capacity({"cpu": "1"}).obj(),
             m.MakeNode("n1").capacity({"cpu": "4"}).taint("k", "v").obj()]
    existing = [(m.MakePod("a").req({"cpu": "1"}).priority(1).obj(), "n0"),
                (m.MakePod("b").req({"cpu": "4"}).priority(1).obj(), "n1")]
    return nodes, [m.MakePod("p0").req({"cpu": "1"}).priority(10).obj()], existing, []


def _nominated_node(m):
    nodes = [m.MakeNode("n0").capacity({"cpu": "2"}).obj()]
    pods = [m.MakePod("p0").req({"cpu": "2"}).priority(10).nominated("n0").obj()]
    return nodes, pods, [], []


def _schedulable(m):
    nodes = [m.MakeNode("n0").capacity({"cpu": "1"}).obj(),
             m.MakeNode("n1").capacity({"cpu": "4"}).obj()]
    existing = [(m.MakePod("e0").req({"cpu": "1"}).priority(0).obj(), "n0")]
    return nodes, [m.MakePod("p0").req({"cpu": "1"}).priority(10).obj()], existing, []


def _pdb_last_resort(m, allowed):
    nodes = [m.MakeNode("n0").capacity({"cpu": "2"}).obj()]
    existing = [(m.MakePod("protected").req({"cpu": "1"}).priority(1)
                 .labels({"app": "db"}).obj(), "n0"),
                (m.MakePod("free").req({"cpu": "900m"}).priority(2).obj(), "n0")]
    pods = [m.MakePod("urgent").req({"cpu": "1800m"}).priority(10).obj()]
    return nodes, pods, existing, [_pdb(m, "db-pdb", "db", allowed)]


def _pdb_zero_violation(m):
    nodes = [m.MakeNode(f"n{i}").capacity({"cpu": "1"}).obj() for i in range(2)]
    existing = [(m.MakePod("prot").req({"cpu": "1"}).priority(1)
                 .labels({"app": "db"}).obj(), "n0"),
                (m.MakePod("free").req({"cpu": "1"}).priority(2).obj(), "n1")]
    pods = [m.MakePod("hi").req({"cpu": "1"}).priority(10).obj()]
    return nodes, pods, existing, [_pdb(m, "db-pdb", "db", 0)]


def _pdb_consumed(m):
    nodes = [m.MakeNode(f"n{i}").capacity({"cpu": "1"}).obj() for i in range(2)]
    existing = [(m.MakePod(f"m{i}").req({"cpu": "1"}).priority(1)
                 .labels({"app": "db"}).created(float(i)).obj(), f"n{i}")
                for i in range(2)]
    pods = [m.MakePod(f"hi{i}").req({"cpu": "1"}).priority(10).created(float(10 + i)).obj()
            for i in range(2)]
    return nodes, pods, existing, [_pdb(m, "db-pdb", "db", 1)]


def _start_time(m):
    nodes = [m.MakeNode(f"n{i}").capacity({"cpu": "1"}).obj() for i in range(2)]
    existing = [(m.MakePod("old").req({"cpu": "1"}).priority(1).created(100.0).obj(), "n0"),
                (m.MakePod("young").req({"cpu": "1"}).priority(1).created(200.0).obj(), "n1")]
    return nodes, [m.MakePod("hi").req({"cpu": "1"}).priority(10).obj()], existing, []


def _randomized(m, trial):
    """tests/test_preemption.py's randomized differential, trial `trial`."""
    rng = np.random.default_rng(7)
    for t in range(trial + 1):
        n_nodes = int(rng.integers(2, 6))
        nodes = [m.MakeNode(f"n{i}").capacity(
            {"cpu": f"{int(rng.integers(1, 5))}", "memory": "8Gi"}).obj()
            for i in range(n_nodes)]
        existing = []
        for i in range(int(rng.integers(0, 8))):
            b = m.MakePod(f"e{i}").req(
                {"cpu": f"{int(rng.integers(200, 1500))}m"}).priority(int(rng.integers(0, 6)))
            if rng.random() < 0.5:
                b = b.labels({"app": f"a{int(rng.integers(0, 2))}"})
            existing.append((b.obj(), f"n{int(rng.integers(0, n_nodes))}"))
        pods = [m.MakePod(f"p{i}").req({"cpu": f"{int(rng.integers(500, 3000))}m"})
                .priority(int(rng.integers(0, 12))).created(float(i)).obj()
                for i in range(int(rng.integers(1, 8)))]
        pdbs = [_pdb(m, f"pdb-a{g}", f"a{g}", int(rng.integers(0, 2))) for g in range(2)]
    return nodes, pods, existing, pdbs


def _pdb_multi_member(m):
    nodes = [m.MakeNode(f"n{i}").capacity({"cpu": "1"}).obj() for i in range(2)]
    existing = [
        (m.MakePod("a0").req({"cpu": "500m"}).priority(1).labels({"app": "a"})
         .created(50.0).obj(), "n0"),
        (m.MakePod("a1").req({"cpu": "500m"}).priority(1).labels({"app": "a"})
         .created(60.0).obj(), "n0"),
        (m.MakePod("b0").req({"cpu": "1"}).priority(1).labels({"app": "b"})
         .created(70.0).obj(), "n1"),
    ]
    pods = [m.MakePod("hi").req({"cpu": "1"}).priority(10).obj()]
    return nodes, pods, existing, [_pdb(m, "pdb-a", "a", 1), _pdb(m, "pdb-b", "b", 0)]


# ---- tests/test_preemption_whatif.py -------------------------------------

def _anti_toward_victim(m):
    nodes = [m.MakeNode("node-0").capacity({"cpu": "8"}).obj()]
    victim = m.MakePod("victim").req({"cpu": "1"}).labels({"app": "x"}).priority(0).obj()
    pend = (m.MakePod("pend").req({"cpu": "1"}).priority(10)
            .pod_affinity(HOST, {"app": "x"}, anti=True).obj())
    return nodes, [pend], [(victim, "node-0")], []


def _victim_port(m):
    nodes = [m.MakeNode("node-0").capacity({"cpu": "8"}).obj()]
    victim = m.MakePod("victim").req({"cpu": "1"}).host_port(8080).priority(0).obj()
    pend = m.MakePod("pend").req({"cpu": "1"}).host_port(8080).priority(10).obj()
    return nodes, [pend], [(victim, "node-0")], []


def _winner_port(m):
    nodes = [m.MakeNode("node-0").capacity({"cpu": "2"}).obj()]
    winner = (m.MakePod("winner").req({"cpu": "1"}).host_port(8080).priority(100)
              .created(0.0).obj())
    pend = m.MakePod("pend").req({"cpu": "1"}).host_port(8080).priority(10).created(1.0).obj()
    low = m.MakePod("low").req({"cpu": "1"}).priority(0).obj()
    return nodes, [winner, pend], [(low, "node-0")], []


def _spread_pressure(m):
    nodes = [m.MakeNode("node-0").capacity({"cpu": "8"}).labels({ZONE: "zone-a"}).obj(),
             m.MakeNode("node-1").capacity({"cpu": "2"}).labels({ZONE: "zone-b"}).obj()]
    a1 = m.MakePod("a1").req({"cpu": "1"}).labels({"app": "s"}).obj()
    a2 = m.MakePod("a2").req({"cpu": "1"}).labels({"app": "s"}).obj()
    vb = m.MakePod("b-low").req({"cpu": "2"}).priority(0).obj()
    pend = (m.MakePod("pend").req({"cpu": "1"}).labels({"app": "s"}).priority(10)
            .spread(1, ZONE, {"app": "s"}).obj())
    return nodes, [pend], [(a1, "node-0"), (a2, "node-0"), (vb, "node-1")], []


def _affinity_anchor(m):
    nodes = [m.MakeNode("node-0").capacity({"cpu": "3"}).obj()]
    anchor = m.MakePod("anchor").req({"cpu": "2"}).labels({"app": "y"}).priority(0).obj()
    pend = (m.MakePod("pend").req({"cpu": "2"}).priority(10)
            .pod_affinity(HOST, {"app": "y"}).obj())
    return nodes, [pend], [(anchor, "node-0")], []


def _affinity_nonanchor(m):
    nodes = [m.MakeNode("node-0").capacity({"cpu": "4"}).obj()]
    anchor = (m.MakePod("anchor").req({"cpu": "1"}).labels({"app": "y"}).priority(50)
              .created(0.0).obj())
    filler = m.MakePod("filler").req({"cpu": "2"}).priority(0).created(1.0).obj()
    pend = (m.MakePod("pend").req({"cpu": "2"}).priority(10)
            .pod_affinity(HOST, {"app": "y"}).obj())
    return nodes, [pend], [(anchor, "node-0"), (filler, "node-0")], []


def _symmetric_owner(m):
    nodes = [m.MakeNode("node-0").capacity({"cpu": "8"}).obj()]
    owner = (m.MakePod("owner").req({"cpu": "1"}).priority(0)
             .pod_affinity(HOST, {"app": "z"}, anti=True).obj())
    pend = m.MakePod("pend").req({"cpu": "1"}).labels({"app": "z"}).priority(10).obj()
    return nodes, [pend], [(owner, "node-0")], []


# ---- workloads and edge cases ---------------------------------------------

def _cfg4(m, with_pdbs, num_nodes=200):
    """BASELINE config #4's workload at 200 nodes x 480 running x 400
    pending (`PENDING_PARAMS[4]`'s mix, 60 apps; `utils/synth.
    config4_workload`'s draws), optionally with one PDB per app
    (`utils/synth.config4_pdbs`); `num_nodes` below 200 tightens it."""
    nodes = m.synth.make_cluster(num_nodes, taint_fraction=0.1, cpu_choices=(4, 8, 16))
    running = m.synth.make_pods(480, seed=991, name_prefix="run", affinity_fraction=0.1,
                                spread_fraction=0.1, num_apps=60)
    existing = [(p, f"node-{i % num_nodes}") for i, p in enumerate(running)]
    pending = m.synth.make_pods(400, seed=4, **dict(port_synth.CONFIG4_PENDING, num_apps=60))
    pdbs = []
    if with_pdbs:
        pdbs = [_pdb(m, b.name, b.selector.match_labels["app"], b.disruptions_allowed)
                for b in port_synth.config4_pdbs(60, seed=9)]
    return nodes, pending, existing, pdbs


def _nondyadic(m):
    """Memory requests in raw bytes that f32 rounds, 20 victims on a node
    (MPN 24: the prefix sums cross XLA's 16-entry scan chunk), and a
    preemptor that needs 17 of them."""
    rng = np.random.default_rng(11)
    nodes = [m.MakeNode(f"n{i}").capacity({"cpu": "7", "memory": "64Gi"}).obj()
             for i in range(3)]
    existing = []
    for i in range(20):
        for n in range(3):
            mem = str(int(rng.integers(10**8, 10**9)))
            existing.append((m.MakePod(f"v{n}-{i}").req({"cpu": f"{300 + 7 * n}m", "memory": mem})
                             .priority(i + n).created(float(i)).obj(), f"n{n}"))
    pods = [m.MakePod(f"p{j}").req({"cpu": f"{5000 + 100 * j}m", "memory": "3333333333"})
            .priority(50).created(float(j)).obj() for j in range(3)]
    return nodes, pods, existing, []


def _i32_wrap(m):
    """Victim priorities near 2^30: node a's two victims sum to 2^31 (i32
    wraps to -2^31), node b's to 2^30 + 1. Equal highest victim priority,
    so the node falls to the (wrapped) sum key."""
    big = 2**30
    nodes = [m.MakeNode(f"n{i}").capacity({"cpu": "2"}).obj() for i in range(2)]
    existing = [(m.MakePod("a0").req({"cpu": "1"}).priority(big).obj(), "n0"),
                (m.MakePod("a1").req({"cpu": "1"}).priority(big).obj(), "n0"),
                (m.MakePod("b0").req({"cpu": "1"}).priority(1).obj(), "n1"),
                (m.MakePod("b1").req({"cpu": "1"}).priority(big).obj(), "n1")]
    pods = [m.MakePod("top").req({"cpu": "2"}).priority(2**31 - 1).obj()]
    return nodes, pods, existing, []


def _crowded_node(m):
    """More than 64 pods per node (MPN 104; 110 is the kubelet default):
    anti-affinity to app=x on the preemptor forces node 0's whole run of 70
    victims out, so the verdict that decides is past the first 64 prefixes.
    Node 1's 100 matching pods reach a higher victim priority."""
    nodes = [m.MakeNode(f"n{i}").capacity({"cpu": "4"}).obj() for i in range(2)]
    existing = [(m.MakePod(f"y{i}").req({"cpu": "10m"}).labels({"app": "y"}).priority(i)
                 .obj(), "n0") for i in range(4)]
    existing += [(m.MakePod(f"x{i}").req({"cpu": "10m"}).labels({"app": "x"})
                  .priority(10 + i).obj(), "n0") for i in range(66)]
    existing += [(m.MakePod(f"z{i}").req({"cpu": "10m"}).labels({"app": "x"}).priority(i)
                  .obj(), "n1") for i in range(100)]
    pend = (m.MakePod("pend").req({"cpu": "10m"}).priority(200)
            .pod_affinity(HOST, {"app": "x"}, anti=True).obj())
    return nodes, [pend], existing, []


def _claim_loop(m, wrap):
    """A 40-rank claim loop over 16 full nodes (4 one-cpu victims each).
    Node 0's victims are the cheapest, so consecutive ranks take it
    (k_claimed grows); nodes 1-15 tie on every key field, so the lowest
    index wins; app=a (every odd node's second victim) has a budget of 2,
    spent part way through, after which the odd nodes' second victims
    violate it; every third preemptor asks for hostPort 8080, so a node
    nominated for one of them is closed to the later ones. With `wrap` the
    victims of nodes 8-15 sit at priority 2^30 + j, so their priority sums
    wrap in i32. Both variants pad to one shape."""
    big = 2**30
    nodes = [m.MakeNode(f"n{i}").capacity({"cpu": "4"}).obj() for i in range(16)]
    existing = []
    for i in range(16):
        for j in range(4):
            prio = 1 + j if i == 0 else (big + j if wrap and i >= 8 else 10 + j)
            app = "a" if j == 1 and i % 2 == 1 else "b"
            existing.append((m.MakePod(f"v{i}-{j}").req({"cpu": "1"}).labels({"app": app})
                             .priority(prio).created(float(j)).obj(), f"n{i}"))
    pods = []
    for k in range(40):
        b = m.MakePod(f"p{k}").req({"cpu": "1"}).priority(2**31 - 1).created(float(k))
        if k % 3 == 0:
            b.host_port(8080)
        pods.append(b.obj())
    return nodes, pods, existing, [_pdb(m, "pdb-a", "a", 2)]


FIXTURES = {
    "basic": _basic, "higher_priority": _higher_priority, "policy_never": _policy_never,
    "minimal_victims": _minimal_victims, "cheapest_victims": _cheapest_victims,
    "two_preemptors": _two_preemptors, "out_of_victims": _out_of_victims,
    "static_gate": _static_gate, "nominated_node": _nominated_node,
    "schedulable": _schedulable,
    "pdb_last_resort_0": lambda m: _pdb_last_resort(m, 0),
    "pdb_last_resort_1": lambda m: _pdb_last_resort(m, 1),
    "pdb_zero_violation": _pdb_zero_violation, "pdb_consumed": _pdb_consumed,
    "start_time": _start_time, "pdb_multi_member": _pdb_multi_member,
    **{f"randomized_{t}": (lambda m, t=t: _randomized(m, t)) for t in range(8)},
    "anti_toward_victim": _anti_toward_victim, "victim_port": _victim_port,
    "winner_port": _winner_port, "spread_pressure": _spread_pressure,
    "affinity_anchor": _affinity_anchor, "affinity_nonanchor": _affinity_nonanchor,
    "symmetric_owner": _symmetric_owner,
    "cfg4": lambda m: _cfg4(m, False), "cfg4_pdbs": lambda m: _cfg4(m, True),
    "cfg4_tight_pdbs": lambda m: _cfg4(m, True, num_nodes=120),
    "nondyadic": _nondyadic, "i32_wrap": _i32_wrap, "crowded_node": _crowded_node,
    "claim_loop": lambda m: _claim_loop(m, False),
    "claim_loop_wrap": lambda m: _claim_loop(m, True),
}
# the whatif cases run on the reference's test encoder pads (16 pods, 8 nodes)
_WHATIF = {"anti_toward_victim", "victim_port", "winner_port", "spread_pressure",
           "affinity_anchor", "affinity_nonanchor", "symmetric_owner"}

# expected results the reference's own tests assert (nominated, victims)
EXPECT = {
    "basic": ([0], [0]), "higher_priority": ([-1], []), "policy_never": ([-1], []),
    "minimal_victims": (None, [0]), "cheapest_victims": ([1], [1]),
    "two_preemptors": ([0, 0], [0, 1]), "out_of_victims": ([0, -1], None),
    "static_gate": ([0], None), "schedulable": ([-1], []),
    "pdb_last_resort_0": ([0], [0, 1]), "pdb_zero_violation": ([1], [1]),
    "start_time": ([1], [1]), "pdb_multi_member": ([1], [2]),
    "anti_toward_victim": ([0], [0]), "victim_port": ([0], [0]),
    "winner_port": ([None, -1], []), "spread_pressure": ([1], [2]),
    "affinity_anchor": ([-1], []), "affinity_nonanchor": ([0], [1]),
    "symmetric_owner": ([0], [0]), "crowded_node": ([0], list(range(70))),
}


def _framework_config(pkg, args):
    if not args:
        return None
    return pkg.config.SchedulerConfiguration(
        profiles=[pkg.config.Profile(plugin_config={"DefaultPreemption": args})])


def run_both(name, args=None):
    """(port result, reference result, port snapshot, pods, existing),
    computed once per (name, args) in this file: several tests read the
    same fixture's runs. Read-only."""
    return _run_both(name, tuple(sorted((args or {}).items())))


@functools.cache
def _run_both(name, arg_items):
    args = dict(arg_items)
    nodes, pods, existing, pdbs = FIXTURES[name](REF)
    enc_kw = {"pad_pods": 16, "pad_nodes": 8} if name in _WHATIF else {}
    ref_snap = ref_models.SnapshotEncoder(**enc_kw).encode(nodes, pods, existing, pdbs=pdbs)
    ref_fw = ref_runtime.Framework.from_config(_framework_config(REF, args))
    want_dec = ref_cycle.build_cycle_fn(framework=ref_fw, commit_mode="rounds",
                                        outputs="latency")(ref_snap)
    want = ref_cycle.build_preemption_fn(ref_fw)(ref_snap, want_dec)
    port_snap = carry(ref_snap)
    fw = Framework.from_config(_framework_config(PORT, args))
    got_dec = build_cycle_fn(framework=fw, commit_mode="rounds", outputs="latency", device="cpu")(port_snap)
    for f in ("assignment", "node_requested", "gang_dropped"):
        np.testing.assert_array_equal(getattr(got_dec, f).numpy(),
                                      np.asarray(getattr(want_dec, f)), err_msg=f)
    got = build_preemption_fn(framework=fw, device="cpu")(port_snap, got_dec)
    return got, want, port_snap, pods, existing


def assert_same_result(got, want):
    for f in ("nominated", "victims", "num_preemptors"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, (f, g.dtype, w.dtype, g.shape)
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_preemption_bit_equal_to_reference(name):
    got, want, snap, pods, existing = run_both(name)
    assert_same_result(got, want)
    nom = got.nominated.numpy()[: len(pods)].tolist()
    vic = np.flatnonzero(got.victims.numpy()[: len(existing)]).tolist()
    if name in EXPECT:
        want_nom, want_vic = EXPECT[name]
        if want_nom is not None:
            assert [w if w is not None else n for w, n in zip(want_nom, nom)] == nom
        if want_vic is not None:
            assert vic == want_vic
    if name in ("cfg4", "cfg4_pdbs", "cfg4_tight_pdbs", "nondyadic", "i32_wrap"):
        assert int(got.num_preemptors) > 0  # the fixture exercises preemption
    if name == "i32_wrap":
        assert nom == [0]  # the wrapped sum (-2^31) wins over 2^30 + 1
    if name == "crowded_node":
        assert snap.node_pods.shape[1] > 64
    if name == "nondyadic":
        assert snap.node_pods.shape[1] > 16 and len(vic) >= 17
    if name == "cfg4_pdbs":
        assert int(snap.pdb_allowed.shape[0]) == 60 and (snap.exist_pdb >= 0).any()
    if name.startswith("claim_loop"):
        # ranks 0-2 take node 0 in turn; rank 3 (hostPort 8080, as rank 0)
        # finds it closed and takes node 1; rank 4 returns to node 0
        assert nom[:5] == [0, 0, 0, 1, 0] and int(got.num_preemptors) == 40


@functools.cache
def _full_tight_preemptors() -> int:
    return int(run_both("cfg4_tight_pdbs")[0].num_preemptors)


@pytest.mark.parametrize("args", [{"budget": 20}, {"scan_budget": 10},
                                  {"budget": 30, "scan_budget": 5}])
def test_budget_overrides_bit_equal_to_reference(args):
    got, want, *_ = run_both("cfg4_tight_pdbs", args)
    assert_same_result(got, want)
    assert 0 < int(got.num_preemptors) < _full_tight_preemptors()
    assert int(got.num_preemptors) <= min(args.values())


@pytest.mark.parametrize("name", ["cfg4_pdbs", "pdb_multi_member", "randomized_5",
                                  "nondyadic"])
def test_port_encoder_pdb_fields_match_reference(name):
    """The port's own encoder, fed the port's own objects and PDBs, gives
    the reference encoder's snapshot (every field, PDB tables included)."""
    r_nodes, r_pods, r_existing, r_pdbs = FIXTURES[name](REF)
    p_nodes, p_pods, p_existing, p_pdbs = FIXTURES[name](PORT)
    ref = ref_models.SnapshotEncoder().encode(r_nodes, r_pods, r_existing, pdbs=r_pdbs)
    port = port_models.SnapshotEncoder(device="cpu").encode(p_nodes, p_pods, p_existing,
                                                           pdbs=p_pdbs)
    assert_same_snapshot(ref, port)


def test_forced_plain_stages_give_the_same_result():
    """The run K7-K9 are held against on the card: every stage forced to
    its plain version, launching nothing."""
    got, want, snap, *_ = run_both("cfg4_pdbs")
    kernel_build.reset_launch_counts()
    plain = build_preemption_fn(device="cpu", prefilter_fn=preemption.prefilter_plain,
                                whatif_fn=preemption.nonresource_ok_plain,
                                claim_fn=preemption.claim_loop_plain)
    d = build_cycle_fn(commit_mode="rounds", outputs="latency", device="cpu")(snap)
    assert_same_result(plain(snap, d), want)
    assert all(v == 0 for v in kernel_build.launch_counts.values())


def test_preemption_entry_point_on_cpu():
    """The library boundary: builders -> encoder -> cycle -> preemption,
    one victim."""
    m = port_models
    nodes = [m.MakeNode("n0").capacity({"cpu": "2"}).obj()]
    existing = [(m.MakePod("low").req({"cpu": "1500m"}).priority(1).obj(), "n0")]
    pods = [m.MakePod("urgent").req({"cpu": "1"}).priority(10).obj()]
    snap = m.SnapshotEncoder(device="cpu").encode(nodes, pods, existing)
    d = build_cycle_fn(commit_mode="rounds", outputs="latency", device="cpu")(snap)
    r = build_preemption_fn(device="cpu")(snap, d)
    assert int(d.assignment[0]) == -1
    assert int(r.nominated[0]) == 0 and r.victims[:1].tolist() == [True]
    assert int(r.num_preemptors) == 1 and r.num_preemptors.dtype == torch.int32


def test_no_post_filter_plugin_returns_none():
    cfg = port_config.SchedulerConfiguration(profiles=[port_config.Profile(
        plugins=port_config.Plugins(post_filter=port_config.PluginSet(
            disabled=["DefaultPreemption"])))])
    assert build_preemption_fn(Framework.from_config(cfg), device="cpu") is None


@pytest.mark.parametrize("name", ["mixed", "cfg2", "cfg4"])
def test_preemption_gate_rows_match_reference(name):
    """The static candidate gate (every static filter but NodePorts, on the
    candidates' pod view) on seeded candidate ids, duplicates included."""
    import jax

    import k8s_scheduler_tpu.framework.interfaces as ref_if
    from k8s_scheduler_tpu_torch.core.cycle import _preemption_gate_rows
    from k8s_scheduler_tpu_torch.framework.interfaces import CycleContext
    from test_torch_encoding import reference_snapshot

    ref = reference_snapshot(name)
    ids = np.random.default_rng(1).integers(0, ref.P, 40).astype(np.int32)
    ref_fw = ref_runtime.Framework.from_config()
    want = jax.jit(lambda s, i: ref_cycle._preemption_gate_rows(
        ref_fw, ref_if.CycleContext(s))(i))(ref, ids)
    port = carry(ref)
    got = _preemption_gate_rows(Framework.from_config(), CycleContext(port))(
        torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < got.numel()


@pytest.mark.parametrize("name", ["nondyadic", "cfg4_pdbs", "i32_wrap"])
def test_victim_tables_match_reference(name):
    """ops/preemption.py:163-190 of the reference (victim priorities,
    starts, PDB ids, f32 prefix sums of the freed requests, i32 prefix sums
    of the priorities) on the same snapshot: bit-equal."""
    import jax
    import jax.numpy as jnp

    nodes, pods, existing, pdbs = FIXTURES[name](REF)
    ref = ref_models.SnapshotEncoder().encode(nodes, pods, existing, pdbs=pdbs)

    def reference(snap):
        E = snap.exist_valid.shape[0]
        valid = snap.node_pods >= 0
        safe = jnp.clip(snap.node_pods, 0, E - 1)
        prio = jnp.where(valid, snap.exist_priority[safe], jnp.int32(preemption.BIG_I32))
        req = jnp.where(valid[:, :, None], snap.exist_requested[safe], 0.0)
        freed = jnp.concatenate([jnp.zeros_like(req[:, :1]), jnp.cumsum(req, axis=1)],
                                axis=1)
        p0 = jnp.where(valid, prio, 0)
        psum = jnp.concatenate([jnp.zeros_like(p0[:, :1]), jnp.cumsum(p0, axis=1)], axis=1)
        return (prio, jnp.where(valid, snap.exist_start[safe], 0.0),
                jnp.where(valid[:, :, None], snap.exist_pdb[safe], -1), freed, psum)

    want = jax.jit(reference)(ref)
    vt = preemption.victim_tables(carry(ref))
    got = (vt.vict_prio, vt.vict_start, vt.vict_pdb, vt.prefix_freed, vt.prefix_prio)
    for g, w, f in zip(got, want, ("prio", "start", "pdb", "prefix_freed", "prefix_prio")):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, f
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)

