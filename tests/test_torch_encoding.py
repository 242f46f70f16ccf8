"""The torch port's encoder against the reference encoder.

Both packages build the same synthetic objects from the same seeds with
their own builders; every array field (dtype, shape, values) and every
static flag of the port's snapshot must equal the reference snapshot's —
on config #3- and #4-shaped workloads too, whose inter-pod affinity,
spread, selector, domain and existing-pod term fields the affinity path
reads, and with PodDisruptionBudgets of every selector form (the PDB
fields preemption reads)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import k8s_scheduler_tpu.models as ref_models
import k8s_scheduler_tpu.models.api as ref_api
import k8s_scheduler_tpu.utils.synth as ref_synth
import k8s_scheduler_tpu_torch.models as port_models
import k8s_scheduler_tpu_torch.utils.synth as port_synth
from k8s_scheduler_tpu_torch.models.encoding import (
    ARRAY_FIELDS,
    AUX_FIELDS,
    snapshot_from_numpy,
)


def _mixed(m):
    """hostPorts (existing and pending), nominated and pinned pods,
    preferred node affinity, PreferNoSchedule taints, images."""
    nodes = []
    for i in range(12):
        b = m.MakeNode(f"n{i}").capacity({"cpu": "8", "memory": "16Gi"}).labels(
            {"zone": f"z{i % 3}", "disk": ["ssd", "hdd"][i % 2]}
        )
        if i % 4 == 0:
            b.taint("soft", "x", "PreferNoSchedule")
        if i % 5 == 1:
            b.taint("soft2", "y", "PreferNoSchedule")
        if i % 3 == 0:
            b.image("img-a", 500 * 2**20)
        if i % 2 == 0:
            b.image("img-b", 2 * 2**30)
        nodes.append(b.obj())
    pods = []
    for j in range(40):
        b = (
            m.MakePod(f"p{j}")
            .req({"cpu": f"{(j % 7 + 1) * 250}m", "memory": f"{(j % 5 + 1) * 256}Mi"},
                 image=["img-a", "img-b", ""][j % 3])
            .priority(j % 3)
            .created(float(j))
        )
        if j % 4 == 0:
            b.host_port(8080)
        if j % 6 == 1:
            b.host_port(9090, "UDP")
        if j % 5 == 0:
            b.node_affinity_preferred(7, "disk", ["ssd"])
        if j % 7 == 2:
            b.node_affinity_preferred(3, "zone", ["z1"])
            b.node_affinity_preferred(5, "zone", ["z2"])
        if j % 9 == 3:
            b.toleration("soft", "x", "PreferNoSchedule")
        if j % 11 == 4:
            b.nominated(f"n{j % 12}")
        if j % 13 == 5:
            b.node(f"n{(j * 5) % 12}")
        if j % 8 == 6:
            b.node_affinity_in("zone", ["z0", "z2"])
        pods.append(b.obj())
    existing = [
        (m.MakePod(f"e{k}").req({"cpu": "1"}).host_port(8080).obj(), f"n{k}")
        for k in range(3)
    ]
    return nodes, pods, existing, []


def _nominated(m):
    nodes = [m.MakeNode(f"n{i}").capacity({"cpu": "4", "memory": "8Gi"}).obj()
             for i in range(6)]
    pods = [
        m.MakePod(f"p{j}").req({"cpu": "1500m"}).created(float(j))
        .nominated(f"n{j % 3}").obj()
        for j in range(10)
    ] + [m.MakePod("ghost").req({"cpu": "1"}).nominated("gone").obj()]
    return nodes, pods, [], []


def fixture(name: str, models, synth):
    class M:
        MakeNode = models.MakeNode
        MakePod = models.MakePod

    if name == "cfg1":
        return synth.make_cluster(10, with_labels=False), synth.make_pods(60, seed=4), [], []
    if name == "cfg2":
        existing = [(p, f"node-{i % 100}") for i, p in enumerate(
            synth.make_pods(200, seed=991, name_prefix="run"))]
        return (synth.make_cluster(100, taint_fraction=0.3),
                synth.make_pods(400, seed=3, selector_fraction=0.5,
                                toleration_fraction=0.4),
                existing, [])
    if name == "cfg5":
        pods, groups = synth.make_gang_pods(30, replicas=4, seed=2)
        return synth.make_cluster(12, cpu_choices=(8,)), pods, [], groups
    if name == "mixed":
        return _mixed(M)
    if name == "nominated":
        return _nominated(M)
    if name == "cfg3":  # bench_suite's config #3 mix at 48 nodes
        return (synth.make_cluster(48),
                synth.make_pods(200, seed=3, affinity_fraction=0.3,
                                anti_affinity_fraction=0.2, spread_fraction=0.2,
                                num_apps=500), [], [])
    if name == "cfg4":  # config #4: running affinity/spread pods, full mix
        nodes = synth.make_cluster(48, taint_fraction=0.1, cpu_choices=(4, 8, 16))
        running = synth.make_pods(120, seed=991, name_prefix="run",
                                  affinity_fraction=0.1, spread_fraction=0.1,
                                  num_apps=40)
        pods = synth.make_pods(200, seed=4, affinity_fraction=0.3,
                               anti_affinity_fraction=0.2, spread_fraction=0.2,
                               selector_fraction=0.3, toleration_fraction=0.1,
                               priorities=(0, 0, 10, 100), num_apps=40)
        return nodes, pods, [(p, f"node-{i % 48}") for i, p in enumerate(running)], []
    if name == "c1":  # ROADMAP C1's seeded input: non-dyadic usage fractions
        running = synth.make_pods(400, seed=991, name_prefix="run")
        return (synth.make_cluster(300, cpu_choices=(4, 8, 16)),
                synth.make_pods(1500, seed=1, selector_fraction=0.3),
                [(p, f"node-{i % 300}") for i, p in enumerate(running)], [])
    raise ValueError(name)


FIXTURES = ["cfg1", "cfg2", "cfg5", "mixed", "nominated", "cfg3", "cfg4"]


def reference_snapshot(name):
    nodes, pods, existing, groups = fixture(name, ref_models, ref_synth)
    return ref_models.SnapshotEncoder().encode(nodes, pods, existing, groups)


def port_snapshot(name):
    nodes, pods, existing, groups = fixture(name, port_models, port_synth)
    return port_models.SnapshotEncoder(device="cpu").encode(
        nodes, pods, existing, groups
    )


def assert_same_snapshot(ref, port):
    ref_arrays = ref.array_fields()
    assert set(ref_arrays) == set(ARRAY_FIELDS)
    for name, want in ref_arrays.items():
        got = getattr(port, name)
        assert isinstance(got, torch.Tensor), name
        got = got.numpy()
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        assert got.shape == want.shape, (name, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in AUX_FIELDS:
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("name", FIXTURES)
def test_encoder_matches_reference(name):
    ref = reference_snapshot(name)
    assert_same_snapshot(ref, port_snapshot(name))
    if name in ("cfg3", "cfg4"):
        for f in ("pod_aff_terms", "pod_anti_terms", "pod_tsc", "sel_exprs"):
            assert (np.asarray(getattr(ref, f)) >= 0).any(), f
        assert ref.has_inter_pod_affinity and ref.has_topology_spread
    if name == "cfg4":
        assert (np.asarray(ref.exist_label_keys) >= 0).any()
        assert (np.asarray(ref.domain_node_count) > 0).sum() > 6


def test_encoder_matches_reference_across_encodes():
    """Sticky pads, interning and the stable-side cache carry across
    encodes exactly as in the reference (one encoder, three pending sets)."""
    r_enc = ref_models.SnapshotEncoder()
    p_enc = port_models.SnapshotEncoder(device="cpu")
    r_nodes = ref_synth.make_cluster(30, taint_fraction=0.3)
    p_nodes = port_synth.make_cluster(30, taint_fraction=0.3)
    for seed in (1, 2, 3):
        kw = dict(seed=seed, selector_fraction=0.5, toleration_fraction=0.4)
        r = r_enc.encode(r_nodes, ref_synth.make_pods(50 * seed, **kw))
        p = p_enc.encode(p_nodes, port_synth.make_pods(50 * seed, **kw))
        assert_same_snapshot(r, p)


def test_snapshot_from_numpy_carries_reference_fields():
    ref = reference_snapshot("mixed")
    snap = snapshot_from_numpy(
        ref.array_fields(), {k: getattr(ref, k) for k in AUX_FIELDS}, device="cpu"
    )
    assert_same_snapshot(ref, snap)
    assert snap.device.type == "cpu" and snap.P == ref.P and snap.N == ref.N


def _pdb_cluster(m, api):
    """PodDisruptionBudgets of every selector form over running pods in two
    namespaces: matchLabels, each matchExpressions operator, an empty
    selector (every pod of its namespace), another namespace's budget, and
    three budgets over one pod (the MB = 2 cap keeps the first two)."""
    LS, Req = api.LabelSelector, api.NodeSelectorRequirement
    nodes = [m.MakeNode(f"n{i}").capacity({"cpu": "8"}).obj() for i in range(4)]
    existing = []
    for i in range(14):
        b = m.MakePod(f"e{i}").req({"cpu": f"{(i % 3 + 1) * 300}m"}).priority(i % 4)
        b.labels({"app": f"a{i % 3}", **({"tier": "web"} if i % 2 else {})})
        pod = b.obj()
        if i % 5 == 4:
            pod.metadata.namespace = "other"
        existing.append((pod, f"n{i % 4}"))
    P = api.PodDisruptionBudget
    pdbs = [
        P("by-app", selector=LS(match_labels={"app": "a0"}), disruptions_allowed=1),
        P("in", selector=LS(match_expressions=(Req("app", "In", ("a1", "a2")),)),
          disruptions_allowed=2),
        P("not-in", selector=LS(match_expressions=(Req("app", "NotIn", ("a1",)),)),
          disruptions_allowed=0),
        P("exists", selector=LS(match_expressions=(Req("tier", "Exists"),))),
        P("absent", selector=LS(match_expressions=(Req("tier", "DoesNotExist"),)),
          disruptions_allowed=3),
        P("everyone", selector=LS(), disruptions_allowed=1),
        P("other-ns", namespace="other", selector=LS(match_labels={"app": "a1"}),
          disruptions_allowed=1),
    ]
    pods = [m.MakePod("p").req({"cpu": "1"}).priority(5).obj()]
    return nodes, pods, existing, pdbs


@pytest.mark.parametrize("name", ["selectors", "cfg4"])
def test_encoder_pdb_fields_match_reference(name):
    """PDBs as an encoder input: `pdb_allowed` and `exist_pdb` (and every
    other field) equal the reference encoder's, for every selector form and
    for config #4's one-budget-per-app variant (`synth.config4_pdbs`)."""
    import k8s_scheduler_tpu.models.api as ref_api
    import k8s_scheduler_tpu_torch.models.api as port_api

    def build(m, api, synth):
        if name == "selectors":
            return _pdb_cluster(m, api)
        nodes, pods, existing, _ = fixture("cfg4", m, synth)
        pdbs = [api.PodDisruptionBudget(
            b.name, selector=api.LabelSelector(match_labels=dict(b.selector.match_labels)),
            disruptions_allowed=b.disruptions_allowed)
            for b in port_synth.config4_pdbs(40, seed=3)]
        return nodes, pods, existing, pdbs

    r_nodes, r_pods, r_existing, r_pdbs = build(ref_models, ref_api, ref_synth)
    p_nodes, p_pods, p_existing, p_pdbs = build(port_models, port_api, port_synth)
    ref = ref_models.SnapshotEncoder().encode(r_nodes, r_pods, r_existing, pdbs=r_pdbs)
    port = port_models.SnapshotEncoder(device="cpu").encode(p_nodes, p_pods, p_existing,
                                                           pdbs=p_pdbs)
    assert_same_snapshot(ref, port)
    exist_pdb = port.exist_pdb.numpy()
    assert port.pdb_allowed.shape[0] == len(p_pdbs)
    assert (exist_pdb[:, 0] >= 0).sum() > 5
    if name == "selectors":
        assert (exist_pdb[:, 1] >= 0).any()  # a pod under several budgets


def test_encoder_raises_on_volumes():
    """The encoder no longer refuses a pod that mounts a PVC: a claim it
    was not given encodes as unschedulable (mode 2), as in the reference."""
    nodes = [port_models.MakeNode("n").capacity({"cpu": "1"}).obj()]
    pods = [port_models.MakePod("p").req({"cpu": "1"}).volume("data").obj()]
    snap = port_models.SnapshotEncoder(device="cpu").encode(nodes, pods)
    assert snap.has_volumes and snap.pod_vol_mode[0].tolist() == [2, -1]
    ref = ref_models.SnapshotEncoder().encode(
        [ref_models.MakeNode("n").capacity({"cpu": "1"}).obj()],
        [ref_models.MakePod("p").req({"cpu": "1"}).volume("data").obj()])
    assert_same_snapshot(ref, snap)


VOLUME_FIELDS = ("pod_vol_mode", "pod_vol_req", "pod_vol_class", "pod_vol_size",
                 "pv_req_id", "pv_class", "pv_capacity", "pv_avail", "rq_exprs",
                 "ex_key", "ex_op", "ex_vals", "ex_num")


def _volume_objects(name, m, synth, seed=5):
    """(nodes, pods, existing, pvcs, pvs, classes) for `m`'s object model:
    config #4's workload at 120 nodes with `config4_volumes`' draw (seed
    `seed`), or a tests/test_torch_volumes.py fixture."""
    import test_torch_volumes as tv

    if name == "cfg4_volumes":
        nodes, existing, pending = port_synth.config4_workload((4,), 120, 300, 240,
                                                               num_apps=30)
        out = port_synth.config4_volumes(nodes, existing, pending[4], seed=seed)
        existing, pods, pvcs, pvs, classes = out
        objs = (nodes, pods, existing, pvcs, pvs, classes)
        return objs if m is port_models else tv.to_api(objs, ref_api)
    mm = tv.PORT if m is port_models else tv.REF
    nodes, pods, existing, _groups, vol = tv.objects(name, mm)
    return nodes, pods, existing, vol["pvcs"], vol["pvs"], vol["storage_classes"]


@pytest.mark.parametrize("name", ["cfg4_volumes", "three_slot_chain", "unschedulable",
                                  "conjunction", "dynamic_topologies", "eight_slot_dominance"])
def test_encoder_volume_fields_match_reference(name):
    """Volumes as an encoder input: every volume field (the pod rows, the
    PV table, and the requirement and expression tables the PV affinity
    and class topologies intern into, in the reference's order) equals the
    reference encoder's, field by field."""
    rn, rp, re_, rc, rv, rs = _volume_objects(name, ref_models, ref_synth)
    pn, pp, pe, pc, pv, ps = _volume_objects(name, port_models, port_synth)
    ref = ref_models.SnapshotEncoder().encode(rn, rp, re_, pvcs=rc, pvs=rv,
                                              storage_classes=rs)
    port = port_models.SnapshotEncoder(device="cpu").encode(
        pn, pp, pe, pvcs=pc, pvs=pv, storage_classes=ps)
    for f in VOLUME_FIELDS:
        np.testing.assert_array_equal(getattr(port, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
        assert getattr(port, f).numpy().dtype == np.asarray(getattr(ref, f)).dtype, f
    assert (port.has_volumes, port.has_multi_volume) == (ref.has_volumes,
                                                         ref.has_multi_volume)
    assert_same_snapshot(ref, port)


def test_encoder_volume_fields_match_reference_across_encodes():
    """One encoder per package, three encodes whose volume sets change
    (another draw, then the first again): the per-pod cache's volume epoch,
    the sticky MVol pad and flags, and the stable side's PV table follow
    the reference."""
    r_enc = ref_models.SnapshotEncoder()
    p_enc = port_models.SnapshotEncoder(device="cpu")
    for seed in (5, 6, 5):
        rn, rp, re_, rc, rv, rs = _volume_objects("cfg4_volumes", ref_models, ref_synth, seed)
        pn, pp, pe, pc, pv, ps = _volume_objects("cfg4_volumes", port_models, port_synth,
                                                 seed)
        ref = r_enc.encode(rn, rp, re_, pvcs=rc, pvs=rv, storage_classes=rs)
        port = p_enc.encode(pn, pp, pe, pvcs=pc, pvs=pv, storage_classes=ps)
        assert_same_snapshot(ref, port)
