"""The port's inter-pod affinity and topology-spread functions against the
reference's (`k8s_scheduler_tpu/ops/interpod.py`).

Every function runs on the same encoded snapshot (the reference
encoder's arrays carried across by `snapshot_from_numpy`) and the same
state; the reference runs jitted on the CPU, the port's plain torch
versions on CPU tensors. Tolerance: none — masks, counts, tables and
scores must be bit-equal. Fixtures: config #3- and #4-shaped synthetic
workloads at a few dozen nodes, a denser #4 mix, a mixed workload with
existing affinity pods, self-anti-affinity, spread skew, an affinity
bootstrap group, and duplicate (selector, key) term slots with preferred
(anti-)affinity and ScheduleAnyway spread on both sides; the state fold
(`affinity_update_batched`) also on K4's seeded edge cases
(`utils/kernel_cases.affinity_update_raw_cases`), against the reference
called eagerly."""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k8s_scheduler_tpu.models as ref_models
import k8s_scheduler_tpu.ops.interpod as ref_ip
import k8s_scheduler_tpu.utils.synth as ref_synth
import k8s_scheduler_tpu_torch.models as port_models
import k8s_scheduler_tpu_torch.utils.synth as port_synth
from k8s_scheduler_tpu_torch.models.encoding import AUX_FIELDS, snapshot_from_numpy
from k8s_scheduler_tpu_torch.ops import interpod as ip
from k8s_scheduler_tpu_torch.utils import kernel_cases
from torch_one_thread import one_torch_thread  # noqa: F401

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
CFG3_PENDING = dict(affinity_fraction=0.3, anti_affinity_fraction=0.2,
                    spread_fraction=0.2, num_apps=500)


CFG4_PENDING = dict(affinity_fraction=0.3, anti_affinity_fraction=0.2,
                    spread_fraction=0.2, selector_fraction=0.3,
                    toleration_fraction=0.1, priorities=(0, 0, 10, 100))


def _cfg4(synth, num_apps, seed=5):
    """bench_suite's config #4 at 36 nodes, 90 running, 160 pending."""
    nodes = synth.make_cluster(36, taint_fraction=0.1, cpu_choices=(4, 8, 16))
    running = synth.make_pods(90, seed=991, name_prefix="run", affinity_fraction=0.1,
                              spread_fraction=0.1, num_apps=num_apps)
    pods = synth.make_pods(160, seed=seed, num_apps=num_apps, **CFG4_PENDING)
    return nodes, pods, [(p, f"node-{i % 36}") for i, p in enumerate(running)], []


def _self_anti(m):
    nodes = [m.MakeNode(f"n{i}").capacity({"cpu": "32"})
             .labels({HOST: f"n{i}"}).obj() for i in range(4)]
    pods = [m.MakePod(f"r{i}").req({"cpu": "1"}).labels({"app": "db"})
            .pod_affinity(HOST, {"app": "db"}, anti=True).created(float(i)).obj()
            for i in range(6)]
    return nodes, pods, [], []


def _spread_skew(m):
    nodes = [m.MakeNode(f"n{i}").capacity({"cpu": "32"})
             .labels({ZONE: f"z{i % 3}"}).obj() for i in range(6)]
    pods = [m.MakePod(f"w{i}").req({"cpu": "1"}).labels({"app": "web"})
            .spread(1, ZONE, {"app": "web"}).created(float(i)).obj()
            for i in range(10)]
    return nodes, pods, [], []


def _bootstrap(m):
    nodes = [m.MakeNode(f"n{i}").capacity({"cpu": "8"})
             .labels({ZONE: f"z{i % 2}"}).obj() for i in range(4)]
    pods = [m.MakePod(f"g{i}").req({"cpu": "1"}).labels({"app": "grp"})
            .pod_affinity(ZONE, {"app": "grp"}).created(float(i)).obj()
            for i in range(5)]
    return nodes, pods, [], []


def _duplicates(m):
    """Duplicate (selector, key) slots on every term kind, preferred
    affinity and anti-affinity (negative weights) on pending and existing
    pods, ScheduleAnyway spread, nodes missing the zone key."""
    nodes = []
    for i in range(10):
        labels = {HOST: f"n{i}"}
        if i % 5 != 4:  # two nodes have no zone
            labels[ZONE] = f"z{i % 3}"
        nodes.append(m.MakeNode(f"n{i}").capacity({"cpu": "6", "memory": "8Gi"})
                     .labels(labels).obj())
    apps = ["a", "b", "c"]
    existing = []
    for e in range(8):
        b = m.MakePod(f"e{e}").req({"cpu": "500m"}).labels({"app": apps[e % 3]})
        if e % 3 == 0:
            b.pod_affinity(ZONE, {"app": "b"}, weight=7)
            b.pod_affinity(ZONE, {"app": "b"}, weight=3)
        if e % 4 == 1:
            b.pod_affinity(HOST, {"app": "c"}, anti=True)
        if e % 4 == 2:
            b.pod_affinity(HOST, {"app": "a"}, anti=True, weight=5)
        existing.append((b.obj(), f"n{(3 * e) % 10}"))
    pods = []
    for j in range(36):
        app = apps[j % 3]
        b = (m.MakePod(f"p{j}").req({"cpu": f"{(j % 4 + 1) * 250}m"})
             .labels({"app": app}).priority(j % 2).created(float(j)))
        if j % 4 == 0:  # the same required term twice
            b.pod_affinity(ZONE, {"app": app})
            b.pod_affinity(ZONE, {"app": app})
        if j % 5 == 1:
            b.pod_affinity(ZONE, {"app": "b"}, weight=4)
            b.pod_affinity(ZONE, {"app": "b"}, weight=9)
            b.pod_affinity(HOST, {"app": "c"}, weight=2)
        if j % 6 == 2:
            b.pod_affinity(HOST, {"app": "a"}, anti=True)
            b.pod_affinity(HOST, {"app": "a"}, anti=True)
        if j % 7 == 3:
            b.pod_affinity(ZONE, {"app": "c"}, anti=True, weight=6)
        if j % 3 == 1:
            b.spread(1, ZONE, {"app": app})
        if j % 4 == 3:
            b.spread(2, ZONE, {"app": app}, when_unsatisfiable="ScheduleAnyway")
            b.spread(1, ZONE, {"app": app}, when_unsatisfiable="ScheduleAnyway")
        pods.append(b.obj())
    return nodes, pods, existing, []


def affinity_fixture(name: str, models, synth):
    """(nodes, pending, existing, groups) built with one package's own
    builders and synth generators."""

    class M:
        MakeNode = models.MakeNode
        MakePod = models.MakePod

    if name == "cfg3":
        return synth.make_cluster(36), synth.make_pods(160, seed=3, **CFG3_PENDING), [], []
    if name == "cfg4":
        return _cfg4(synth, 500)
    if name == "cfg4_dense":
        return _cfg4(synth, 12)
    if name == "mixed":
        return (synth.make_cluster(40, taint_fraction=0.2),
                synth.make_pods(250, seed=0, affinity_fraction=0.3,
                                anti_affinity_fraction=0.2, spread_fraction=0.2,
                                selector_fraction=0.3, toleration_fraction=0.2,
                                priorities=(0, 10, 100), num_apps=25), [], [])
    if name == "existing":
        running = synth.make_pods(60, seed=7, name_prefix="run", affinity_fraction=0.2,
                                  anti_affinity_fraction=0.2, num_apps=10)
        return (synth.make_cluster(30),
                synth.make_pods(120, seed=8, affinity_fraction=0.3,
                                anti_affinity_fraction=0.3, spread_fraction=0.3,
                                num_apps=10),
                [(p, f"node-{i % 30}") for i, p in enumerate(running)], [])
    if name == "self_anti":
        return _self_anti(M)
    if name == "spread_skew":
        return _spread_skew(M)
    if name == "bootstrap":
        return _bootstrap(M)
    if name == "duplicates":
        return _duplicates(M)
    raise ValueError(name)


AFFINITY_FIXTURES = ["cfg3", "cfg4", "cfg4_dense", "mixed", "existing",
                     "self_anti", "spread_skew", "bootstrap", "duplicates"]


def reference_affinity_snapshot(name):
    nodes, pods, existing, groups = affinity_fixture(name, ref_models, ref_synth)
    return ref_models.SnapshotEncoder().encode(nodes, pods, existing, groups)


def carry(ref):
    return snapshot_from_numpy(
        ref.array_fields(), {k: getattr(ref, k) for k in AUX_FIELDS}, device="cpu"
    )


def _eq(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _state_eq(got, want):
    for f in ("counts", "total", "anti_presence", "pref_sym"):
        _eq(getattr(got, f), getattr(want, f), f)


def _port_state(ref_state):
    return ip.AffinityState(*[torch.from_numpy(np.array(getattr(ref_state, f)))
                              for f in ("counts", "total", "anti_presence", "pref_sym")])


class Case:
    """One fixture, with a mid-cycle state: the initial state plus a seeded
    batch of accepted placements, folded by the reference."""

    def __init__(self, name):
        self.ref = reference_affinity_snapshot(name)
        self.port = carry(self.ref)
        rng = np.random.default_rng(sum(map(ord, name)))
        P = self.ref.P
        n_real = int(self.ref.num_nodes)
        self.accepted = (rng.random(P) < 0.4) & np.asarray(self.ref.pod_valid)
        self.node_of = rng.integers(0, n_real, P).astype(np.int32)
        self.feasible = rng.random((P, self.ref.N)) < 0.7
        self.m_pending_ref = jax.jit(ref_ip.matched_pending)(self.ref)
        self.m_exist_ref = jax.jit(ref_ip.matched_existing)(self.ref)
        self.state0_ref = jax.jit(ref_ip.initial_state)(self.ref, self.m_exist_ref)
        self.state_ref = jax.jit(ref_ip.affinity_update_batched)(
            self.ref, self.state0_ref, self.m_pending_ref, self.accepted, self.node_of)
        self.m_pending = torch.from_numpy(np.array(self.m_pending_ref))
        self.state = _port_state(self.state_ref)
        self.cbn_ref = jax.jit(ref_ip.counts_by_node)(self.ref, self.state_ref)
        self.cbn = torch.from_numpy(np.array(self.cbn_ref))


_CASES: dict[str, Case] = {}


def case(name) -> Case:
    if name not in _CASES:
        _CASES[name] = Case(name)
    return _CASES[name]


@pytest.mark.parametrize("name", AFFINITY_FIXTURES)
def test_fixture_exercises_affinity_or_spread(name):
    c = case(name)
    assert c.ref.has_inter_pod_affinity or c.ref.has_topology_spread
    if name == "duplicates":
        aff = np.asarray(c.ref.pod_aff_terms)
        assert (aff[:, 0] == aff[:, 1]).all(axis=1)[aff[:, 0, 0] >= 0].any()
        assert (np.asarray(c.ref.pod_pref_aff_w) < 0).any()
        assert (np.asarray(c.ref.exist_pref_aff_w) != 0).any()


@pytest.mark.parametrize("name", AFFINITY_FIXTURES)
def test_matched_tables_and_initial_state(name):
    c = case(name)
    _eq(ip.matched_pending(c.port), c.m_pending_ref, "matched_pending")
    m_exist = ip.matched_existing(c.port)
    _eq(m_exist, c.m_exist_ref, "matched_existing")
    _state_eq(ip.initial_state(c.port, m_exist), c.state0_ref)


# K4's seeded edge cases (utils/kernel_cases.affinity_update_raw_cases),
# which chip_smoke.py holds the kernel against the plain version on
_K4_CASES = kernel_cases.affinity_update_raw_cases()


@pytest.mark.parametrize("name", AFFINITY_FIXTURES + [f"k4: {t}" for t in _K4_CASES])
def test_affinity_update_batched(name):
    if name.startswith("k4: "):
        raw = _K4_CASES[name[4:]]
        ref_snap = types.SimpleNamespace(
            N=raw["node_domains"].shape[0],
            **{k: jnp.asarray(raw[k]) for k in ("node_domains", "pod_anti_terms",
                                                "pod_pref_aff", "pod_pref_aff_w")},
            has_inter_pod_affinity=raw["has_inter_pod_affinity"])
        want = ref_ip.affinity_update_batched(
            ref_snap, ref_ip.AffinityState(*[jnp.asarray(raw[k]) for k in (
                "counts", "total", "anti_presence", "pref_sym")]),
            jnp.asarray(raw["m_pending"]), jnp.asarray(raw["accepted"]),
            jnp.asarray(raw["node_of"]))
        got = ip.affinity_update_batched(*kernel_cases.affinity_update_args(raw, "cpu"))
        _state_eq(got, want)
        assert float(got.pref_sym.abs().max()) < 2**24
        return
    c = case(name)
    got = ip.affinity_update_batched(
        c.port, _port_state(c.state0_ref), c.m_pending,
        torch.from_numpy(c.accepted), torch.from_numpy(c.node_of))
    _state_eq(got, c.state_ref)


@pytest.mark.parametrize("name", AFFINITY_FIXTURES)
def test_counts_by_node_and_spread_minc(name):
    c = case(name)
    _eq(ip.counts_by_node(c.port, c.state), c.cbn_ref, "counts_by_node")
    want = jax.jit(ref_ip.spread_minc)(c.ref, c.state_ref)
    _eq(ip.spread_minc(c.port, c.state), want, "spread_minc")


@pytest.mark.parametrize("name", AFFINITY_FIXTURES)
def test_affinity_mask_and_score_batched(name):
    c = case(name)
    want = jax.jit(ref_ip.affinity_mask_batched)(
        c.ref, c.state_ref, c.m_pending_ref, c.cbn_ref)
    _eq(ip.affinity_mask_batched(c.port, c.state, c.m_pending, c.cbn), want,
        "affinity_mask_batched")
    want = jax.jit(ref_ip.affinity_score_batched)(
        c.ref, c.state_ref, c.m_pending_ref, c.cbn_ref, c.feasible)
    got = ip.affinity_score_batched(c.port, c.state, c.m_pending, c.cbn,
                                    torch.from_numpy(c.feasible))
    _eq(got, want, "affinity_score_batched")


@pytest.mark.parametrize("name", AFFINITY_FIXTURES)
def test_spread_mask_and_score_batched(name):
    c = case(name)
    minc_ref = jax.jit(ref_ip.spread_minc)(c.ref, c.state_ref)
    want = jax.jit(ref_ip.spread_mask_batched)(c.ref, c.state_ref, c.cbn_ref, minc_ref)
    got = ip.spread_mask_batched(c.port, c.state, c.cbn,
                                 torch.from_numpy(np.array(minc_ref)))
    _eq(got, want, "spread_mask_batched")
    want = jax.jit(ref_ip.spread_score_batched)(c.ref, c.state_ref, c.cbn_ref, c.feasible)
    got = ip.spread_score_batched(c.port, c.state, c.cbn, torch.from_numpy(c.feasible))
    _eq(got, want, "spread_score_batched")


def test_config4_workload_draws_the_reference_objects():
    """`config4_workload` is bench_suite's config #4 (minus its pending
    count, which the caller sizes): same nodes, running pods and pending
    pods from the same seeds."""
    import bench_suite

    nodes, existing, pending = port_synth.config4_workload(
        (5,), num_nodes=36, num_existing=90, num_pending=160, num_apps=12)
    r_nodes, r_pending, r_existing, _ = _cfg4(ref_synth, 12)
    ref = ref_models.SnapshotEncoder().encode(r_nodes, r_pending, r_existing)
    port = port_models.SnapshotEncoder(device="cpu").encode(nodes, pending[5], existing)
    from test_torch_encoding import assert_same_snapshot

    assert_same_snapshot(ref, port)
    assert dict(CFG4_PENDING, num_apps=500) == bench_suite.PENDING_PARAMS[4]
    assert port_synth.CONFIG4_PENDING == bench_suite.PENDING_PARAMS[4]
    assert port.has_inter_pod_affinity and port.has_topology_spread


@pytest.mark.parametrize("name", AFFINITY_FIXTURES)
def test_port_encoder_matches_reference_on_affinity_fixtures(name):
    """The port's own encoder gives the same affinity, spread, selector,
    domain and existing-pod term fields (all fields, in fact) as the
    reference encoder on every fixture here."""
    from test_torch_encoding import assert_same_snapshot

    nodes, pods, existing, groups = affinity_fixture(name, port_models, port_synth)
    port = port_models.SnapshotEncoder(device="cpu").encode(nodes, pods, existing, groups)
    assert_same_snapshot(reference_affinity_snapshot(name), port)


@pytest.mark.parametrize("name", AFFINITY_FIXTURES)
def test_spread_min2_and_anti_owner_counts(name):
    """Preemption's what-if tables: min1/argmin/min2 over eligible domains
    of the mid-cycle counts, and anti-term owner counts of running plus
    placed pods (a seeded assignment)."""
    c = case(name)
    want = jax.jit(ref_ip.spread_min2)(c.ref, c.state_ref.counts)
    got = ip.spread_min2(c.port, c.state.counts)
    for g, w, f in zip(got, want, ("min1", "argmin", "min2")):
        _eq(g, w, f)
    assignment = np.where(c.accepted, c.node_of, -1).astype(np.int32)
    want = jax.jit(ref_ip.anti_owner_counts)(c.ref, assignment)
    _eq(ip.anti_owner_counts(c.port, torch.from_numpy(assignment)), want,
        "anti_owner_counts")
