"""The port's VolumeBinding functions against the reference's.

Every fixture of tests/test_volumes.py and tests/test_pv_arbitration.py,
rebuilt for both packages' object models (bound-PV zone pinning, static
candidates, dynamic-provisioning topology, the unschedulable claims,
multi-volume conjunction, the joint Hall fixtures with the 3-slot chain
and both 8-slot cases, same-cycle contention, gangs), and config #4's
workload with `utils/synth.config4_volumes` at 200 nodes x 480 running x
400 pending. On each: the encoders' volume fields equal field by field,
and every ops/volumes.py function of the port equals the reference's on
the same snapshot and seeded claim bitmaps, nodes and claimants; bool and
int outputs bit-equal. The kernels' wrappers take the plain versions on
the CPU. `_sdr_safe_choice` is also held on crossing candidate sets the
encoder cannot produce."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k8s_scheduler_tpu.models as ref_models
import k8s_scheduler_tpu.models.api as ref_api
import k8s_scheduler_tpu.ops.volumes as ref_vol
import k8s_scheduler_tpu_torch.models as port_models
import k8s_scheduler_tpu_torch.models.api as port_api
import k8s_scheduler_tpu_torch.ops.volumes as port_vol
from k8s_scheduler_tpu.framework.interfaces import CycleContext as RefContext
from k8s_scheduler_tpu_torch.framework.interfaces import CycleContext
from k8s_scheduler_tpu_torch.models.encoding import AUX_FIELDS, snapshot_from_numpy
from k8s_scheduler_tpu_torch.ops import kernel_build, labels
from k8s_scheduler_tpu_torch.ops import pv_choice, pv_fold, volume_mask
from k8s_scheduler_tpu_torch.utils import synth as port_synth
from test_torch_encoding import assert_same_snapshot
from torch_one_thread import one_torch_thread  # noqa: F401

GiB = 2**30
ZONE = "topology.kubernetes.io/zone"


class M:
    """One package's object model: builders and api types."""

    def __init__(self, models, api):
        self.MakeNode, self.MakePod, self.api = models.MakeNode, models.MakePod, api


REF, PORT = M(ref_models, ref_api), M(port_models, port_api)


def _zone_term(m, *zones):
    return m.api.NodeSelectorTerm((m.api.NodeSelectorRequirement(ZONE, "In", zones),))


def _zoned_nodes(m, n_per_zone=2, zones=("z0", "z1", "z2")):
    return [m.MakeNode(f"{z}-n{i}").capacity({"cpu": "8"}).labels({ZONE: z}).obj()
            for z in zones for i in range(n_per_zone)]


def _local(m, provisioner=False):
    return m.api.StorageClass("local", m.api.VOLUME_BINDING_WAIT, provisioner=provisioner)


def _bound_zone(m, zone="z1"):
    a = m.api
    pvs = [a.PersistentVolume(f"pv-{zone}", capacity=10 * GiB, storage_class="ssd",
                              node_affinity=(_zone_term(m, zone),), claim_ref="default/data")]
    pvcs = [a.PersistentVolumeClaim("data", storage_class="ssd", request=5 * GiB,
                                    volume_name=f"pv-{zone}")]
    pods = [m.MakePod("db").req({"cpu": "1"}).volume("data").obj()]
    return _zoned_nodes(m), pods, pvcs, pvs, [], [], []


def _static_candidates(m):
    a = m.api
    pvs = [a.PersistentVolume("pv-a", capacity=10 * GiB, storage_class="local",
                              node_affinity=(_zone_term(m, "z0"),)),
           a.PersistentVolume("pv-small", capacity=1 * GiB, storage_class="local",
                              node_affinity=(_zone_term(m, "z2"),))]
    pvcs = [a.PersistentVolumeClaim("scratch", storage_class="local", request=5 * GiB)]
    pods = [m.MakePod("w").req({"cpu": "1"}).volume("scratch").obj()]
    return _zoned_nodes(m), pods, pvcs, pvs, [_local(m)], [], []


def _dynamic_topologies(m):
    a = m.api
    classes = [a.StorageClass("ebs", a.VOLUME_BINDING_WAIT, provisioner=True,
                              allowed_topologies=(_zone_term(m, "z2"),))]
    pvcs = [a.PersistentVolumeClaim("dyn", storage_class="ebs", request=5 * GiB)]
    pods = [m.MakePod("w").req({"cpu": "1"}).volume("dyn").obj()]
    return _zoned_nodes(m), pods, pvcs, [], classes, [], []


def _unschedulable(m):
    a = m.api
    pvcs = [a.PersistentVolumeClaim("imm-claim", storage_class="imm", request=1 * GiB)]
    pods = [m.MakePod("no-pvc").req({"cpu": "1"}).volume("ghost").obj(),
            m.MakePod("imm").req({"cpu": "1"}).volume("imm-claim").obj(),
            m.MakePod("plain").req({"cpu": "1"}).obj()]
    return _zoned_nodes(m), pods, pvcs, [], [a.StorageClass("imm")], [], []


def _claimed_pv(m):
    a = m.api
    pvs = [a.PersistentVolume("pv-a", capacity=10 * GiB, storage_class="local",
                              claim_ref="other/taken")]
    pvcs = [a.PersistentVolumeClaim("scratch", storage_class="local", request=5 * GiB)]
    pods = [m.MakePod("w").req({"cpu": "1"}).volume("scratch").obj()]
    return _zoned_nodes(m), pods, pvcs, pvs, [_local(m)], [], []


def _conjunction(m):
    a = m.api
    pvs = [a.PersistentVolume("pv-z0z1", capacity=10 * GiB, storage_class="ssd",
                              node_affinity=(_zone_term(m, "z0", "z1"),), claim_ref="default/a"),
           a.PersistentVolume("pv-z1z2", capacity=10 * GiB, storage_class="ssd",
                              node_affinity=(_zone_term(m, "z1", "z2"),), claim_ref="default/b")]
    pvcs = [a.PersistentVolumeClaim("a", storage_class="ssd", request=GiB, volume_name="pv-z0z1"),
            a.PersistentVolumeClaim("b", storage_class="ssd", request=GiB, volume_name="pv-z1z2")]
    pods = [m.MakePod("both").req({"cpu": "1"}).volume("a").volume("b").obj()]
    return _zoned_nodes(m), pods, pvcs, pvs, [], [], []


def _joint(m, n_pvs, sizes=(5, 5), pv_caps=None, provisioner=False):
    """One pod with len(sizes) PVCs of class 'local' on one node."""
    a = m.api
    caps = pv_caps or [10] * n_pvs
    pvs = [a.PersistentVolume(f"pv-{v}", capacity=caps[v] * GiB, storage_class="local")
           for v in range(n_pvs)]
    pvcs = [a.PersistentVolumeClaim(f"c{j}", storage_class="local", request=sizes[j] * GiB)
            for j in range(len(sizes))]
    mk = m.MakePod("w").req({"cpu": "1"})
    for j in range(len(sizes)):
        mk = mk.volume(f"c{j}")
    nodes = [m.MakeNode("n0").capacity({"cpu": "8"}).obj()]
    return nodes, [mk.obj()], pvcs, pvs, [_local(m, provisioner)], [], []


def _contending(m):
    """Two 2-PVC pods over 3 PVs on one node."""
    a = m.api
    pvs = [a.PersistentVolume(f"pv-{v}", capacity=10 * GiB, storage_class="local")
           for v in range(3)]
    pvcs = [a.PersistentVolumeClaim(f"c{j}", storage_class="local", request=5 * GiB)
            for j in range(4)]
    pods = [m.MakePod("a").req({"cpu": "1"}).volume("c0").volume("c1").created(0.0).obj(),
            m.MakePod("b").req({"cpu": "1"}).volume("c2").volume("c3").created(1.0).obj()]
    nodes = [m.MakeNode("n0").capacity({"cpu": "8"}).obj()]
    return nodes, pods, pvcs, pvs, [_local(m)], [], []


def _arbitration(m, n_pvs, n_claimants, provisioner=False):
    """tests/test_pv_arbitration.py's fixture: claimants of one class on
    three nodes, n_pvs equivalent PVs."""
    a = m.api
    nodes = [m.MakeNode(f"n{i}").capacity({"cpu": "8"}).obj() for i in range(3)]
    pvs = [a.PersistentVolume(f"pv-{v}", capacity=10 * GiB, storage_class="local")
           for v in range(n_pvs)]
    pvcs = [a.PersistentVolumeClaim(f"claim-{p}", storage_class="local", request=5 * GiB)
            for p in range(n_claimants)]
    pods = [m.MakePod(f"pod-{p}").req({"cpu": "1"}).volume(f"claim-{p}").created(float(p)).obj()
            for p in range(n_claimants)]
    return nodes, pods, pvcs, pvs, [_local(m, provisioner)], [], []


def _gang(m, solo):
    """tests/test_pv_arbitration.py's gang fixtures: a 2-member gang whose
    placed member claims a PV and unwinds (with a solo claimant that keeps
    its PV when `solo`)."""
    a = m.api
    n_nodes, n_pvs = (2, 3) if solo else (1, 1)
    nodes = [m.MakeNode(f"n{i}").capacity({"cpu": "1"}).obj() for i in range(n_nodes)]
    pvs = [a.PersistentVolume(f"pv-{v}", capacity=10 * GiB, storage_class="local")
           for v in range(n_pvs)]
    names = (["claim-solo"] if solo else []) + ["claim-g0", "claim-g1"]
    pvcs = [a.PersistentVolumeClaim(c, storage_class="local", request=5 * GiB) for c in names]
    pods = []
    if solo:
        pods.append(m.MakePod("solo").req({"cpu": "1"}).volume("claim-solo").created(0.0).obj())
    for p in range(2):
        pods.append(m.MakePod(f"g-{p}").req({"cpu": "1"}).volume(f"claim-g{p}")
                    .group("job").created(float(1 + p)).obj())
    return nodes, pods, pvcs, pvs, [_local(m)], [a.PodGroup("job", 2)], []


def to_api(obj, api):
    """A port api object (or a container of them) rebuilt with `api`'s
    classes of the same names."""
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_api(x, api) for x in obj)
    if isinstance(obj, dict):
        return {k: to_api(v, api) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        cls = getattr(api, type(obj).__name__)
        return cls(**{f.name: to_api(getattr(obj, f.name), api)
                      for f in dataclasses.fields(obj) if f.init})
    return obj


def _cfg4_volumes(m, num_nodes=200, num_existing=480, num_pending=400, seed=5):
    """config #4's workload at test size with `config4_volumes`' draw,
    rebuilt for the reference's object model when `m` is REF."""
    nodes, existing, pending = port_synth.config4_workload(
        (4,), num_nodes, num_existing, num_pending, num_apps=60)
    existing, pods, pvcs, pvs, classes = port_synth.config4_volumes(
        nodes, existing, pending[4], seed=seed)
    out = (nodes, pods, pvcs, pvs, classes, [], existing)
    return out if m is PORT else to_api(out, m.api)


FIXTURES = {
    "bound_zone": _bound_zone,
    "static_candidates": _static_candidates,
    "dynamic_topologies": _dynamic_topologies,
    "unschedulable": _unschedulable,
    "claimed_pv": _claimed_pv,
    "conjunction": _conjunction,
    "end_to_end_zone": lambda m: _bound_zone(m, "z2"),
    "two_pvcs_one_pv": lambda m: _joint(m, 1),
    "two_pvcs_two_pvs": lambda m: _joint(m, 2),
    "two_pvcs_one_pv_provisioner": lambda m: _joint(m, 1, provisioner=True),
    "constrained_slot": lambda m: _joint(m, 2, (1, 8), [10, 2]),
    "contending": _contending,
    "three_slot_chain": lambda m: _joint(m, 3, (1, 5, 8), [10, 6, 2]),
    "eight_slot_tight": lambda m: _joint(m, 8, (8, 8, 8, 1, 1, 1, 1, 1),
                                         [10, 10, 2, 2, 2, 2, 2, 2]),
    "eight_slot_dominance": lambda m: _joint(m, 8, (1, 8, 8, 8, 1, 1, 1, 1),
                                             [10, 10, 10, 2, 2, 2, 2, 2]),
    "single_pv_3": lambda m: _arbitration(m, 1, 3),
    "two_pvs_3": lambda m: _arbitration(m, 2, 3),
    "three_pvs_3": lambda m: _arbitration(m, 3, 3),
    "two_pvs_4": lambda m: _arbitration(m, 2, 4),
    "static_and_dynamic": lambda m: _arbitration(m, 1, 2, provisioner=True),
    "gang_unwind": lambda m: _gang(m, False),
    "gang_survivor": lambda m: _gang(m, True),
    "cfg4_volumes": _cfg4_volumes,
}


def objects(name, m):
    nodes, pods, pvcs, pvs, classes, groups, existing = FIXTURES[name](m)
    return nodes, pods, existing, groups, dict(pvcs=pvcs, pvs=pvs, storage_classes=classes)


def reference_snapshot(name):
    nodes, pods, existing, groups, vol = objects(name, REF)
    return ref_models.SnapshotEncoder().encode(nodes, pods, existing, groups, **vol)


def carry(ref):
    return snapshot_from_numpy(ref.array_fields(),
                               {k: getattr(ref, k) for k in AUX_FIELDS}, device="cpu")


@pytest.mark.parametrize("name", list(FIXTURES))
def test_encoder_volume_fields_match_reference(name):
    ref = reference_snapshot(name)
    nodes, pods, existing, groups, vol = objects(name, PORT)
    port = port_models.SnapshotEncoder(device="cpu").encode(nodes, pods, existing,
                                                            groups, **vol)
    assert_same_snapshot(ref, port)
    assert port.has_volumes
    modes = port.pod_vol_mode.numpy()
    if name == "cfg4_volumes":
        assert port.has_multi_volume and port.pod_vol_mode.shape[1] == 2
        for mode in (0, 1):
            assert (modes == mode).sum() > 10
        assert ((modes >= 0).sum(axis=1) == 2).sum() > 10
        assert port.pv_avail.sum() > 100 and (~port.pv_avail[:len(vol["pvs"])]).sum() > 50


def test_config4_volumes_draw():
    """The cell's mix at test size, and nothing passed in is modified."""
    nodes, existing, pending = port_synth.config4_workload((4,), 200, 480, 400, num_apps=60)
    before = [p.spec.volumes for p in pending[4]] + [p.spec.volumes for p, _ in existing]
    ex2, pods, pvcs, pvs, classes = port_synth.config4_volumes(nodes, existing, pending[4], 5)
    assert before == [p.spec.volumes for p in pending[4]] + [p.spec.volumes for p, _ in existing]
    assert not any(before)
    n_vol = [len(p.spec.volumes) for p in pods]
    assert sum(v > 0 for v in n_vol) == 160 and n_vol.count(2) == 20
    local = [v for v in pvs if v.storage_class == port_synth.LOCAL_CLASS]
    assert len(local) == 400 and sum(bool(v.claim_ref) for v in local) == 120
    zonal = [v for v in pvs if v.storage_class == port_synth.ZONAL_CLASS]
    assert len(zonal) == 40 and all(v.claim_ref for v in zonal)
    held = [p for p, _ in ex2 if p.spec.volumes]
    assert len(held) == 120
    assert {c.name for c in classes} == {"local-storage", "zonal-ssd"}


# ---- the functions, on seeded inputs ----------------------------------------


class Case:
    def __init__(self, name, seed=0):
        self.ref = reference_snapshot(name)
        self.port = carry(self.ref)
        self.em = RefContext(self.ref).expr_node_mask
        self.req = labels.requirement_mask(self.port.rq_exprs,
                                           CycleContext(self.port).expr_node_mask)
        rng = np.random.default_rng(seed)
        P, V = self.port.P, self.port.pv_avail.shape[0]
        n_real = max(int(self.port.num_nodes), 1)
        self.claimed = rng.random(V) < 0.3
        self.node_of = rng.integers(0, n_real, P).astype(np.int32)
        self.active = (rng.random(P) < 0.8) & np.asarray(self.ref.pod_valid)
        self.rank = np.asarray(self.ref.pod_order).astype(np.int32)


def _eq(got, want, what):
    w = np.asarray(want)
    g = got.numpy()
    assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype, w.dtype, g.shape, w.shape)
    np.testing.assert_array_equal(g, w, err_msg=what)


FN_FIXTURES = list(FIXTURES)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", FN_FIXTURES)
def test_volume_masks_match_reference(name, seed):
    c = Case(name, seed)
    t = torch.from_numpy
    _eq(port_vol.pv_node_table(c.port, c.req), ref_vol.pv_node_table(c.ref, c.em), "pv_node_table")
    for j in range(c.port.pod_vol_mode.shape[1]):
        _eq(port_vol.pod_pv_cand(c.port, j), ref_vol.pod_pv_cand(c.ref, j), f"pod_pv_cand {j}")
    want = ref_vol.volume_mask(c.ref, c.em)
    _eq(port_vol.volume_mask(c.port, c.req), want, "volume_mask")
    claimed = c.claimed if seed else np.zeros_like(c.claimed)
    _eq(port_vol.volume_mask(c.port, c.req, t(claimed)),
        ref_vol.volume_mask(c.ref, c.em, jnp.asarray(claimed)), "volume_mask claimed")
    want_u = ref_vol.volume_mask_unbound(c.ref, c.em, jnp.asarray(claimed))
    _eq(port_vol.volume_mask_unbound(c.port, c.req, t(claimed)), want_u, "volume_mask_unbound")
    # K10's wrapper takes the plain version on the CPU
    tables = port_vol.volume_tables(c.port, c.req)
    _eq(volume_mask.volume_mask(c.port, tables, None, False), want, "K10 static")
    _eq(volume_mask.volume_mask(c.port, tables, t(claimed), True), want_u, "K10 unbound")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", FN_FIXTURES)
def test_pv_choice_and_fold_match_reference(name, seed):
    c = Case(name, seed)
    t = torch.from_numpy
    claimed = c.claimed if seed else np.zeros_like(c.claimed)
    jc, jn, ja = jnp.asarray(claimed), jnp.asarray(c.node_of), jnp.asarray(c.active)
    tc, tn, ta = t(claimed), t(c.node_of), t(c.active)
    _eq(port_vol._dyn_at_node(c.port, c.req, tn), ref_vol._dyn_at_node(c.ref, c.em, jn),
        "_dyn_at_node")
    MVol = c.port.pod_vol_mode.shape[1]
    pending = c.active[:, None] & (np.asarray(c.ref.pod_vol_mode) == 1)
    for j in range(MVol):
        _eq(port_vol.chosen_pv(c.port, c.req, tc, tn, ta, j),
            ref_vol.chosen_pv(c.ref, c.em, jc, jn, ja, j), f"chosen_pv {j}")
        _eq(port_vol.chosen_pv_sdr(c.port, c.req, tc, tn, t(pending), j),
            ref_vol.chosen_pv_sdr(c.ref, c.em, jc, jn, jnp.asarray(pending), j),
            f"chosen_pv_sdr {j}")
    want = ref_vol.chosen_pv_slots(c.ref, c.em, jc, jn, ja)
    _eq(port_vol.chosen_pv_slots(c.port, c.req, tc, tn, ta), want, "chosen_pv_slots")
    tables = port_vol.volume_tables(c.port, c.req)
    _eq(pv_choice.pv_choice(c.port, tables, tc, tn, ta), want, "K11")
    jr = jnp.asarray(c.rank)
    want_f = ref_vol.fold_pv_claims(c.ref, c.em, jc, ja, jn, jr)
    _eq(port_vol.fold_pv_claims(c.port, c.req, tc, ta, tn, t(c.rank)), want_f, "fold_pv_claims")
    _eq(pv_fold.pv_fold(c.port, tables, tc, ta, tn, t(c.rank)), want_f, "K12")


def test_volume_tables_list_the_available_pvs_per_node():
    c = Case("cfg4_volumes")
    tables = port_vol.volume_tables(c.port, c.req)
    dense = port_vol.pv_node_table(c.port, c.req)  # [V, N]
    off, lst = tables.node_off.tolist(), tables.node_pv.tolist()
    glob = set(tables.global_pv.tolist())
    for n in range(c.port.N):
        got = set(lst[off[n]:off[n + 1]]) | glob
        assert got == set(torch.nonzero(dense[:, n]).flatten().tolist()), n
        assert lst[off[n]:off[n + 1]] == sorted(lst[off[n]:off[n + 1]])
    assert len(lst) > 0 and not glob


def test_wrappers_launch_nothing_on_cpu():
    c = Case("three_slot_chain")
    tables = port_vol.volume_tables(c.port, c.req)
    kernel_build.reset_launch_counts()
    P = c.port.P
    claimed = torch.zeros(c.port.pv_avail.shape[0], dtype=torch.bool)
    node_of = torch.zeros(P, dtype=torch.int32)
    active = c.port.pod_valid.clone()
    volume_mask.volume_mask(c.port, tables, None, False)
    ch = pv_choice.pv_choice(c.port, tables, claimed, node_of, active)
    folded = pv_fold.pv_fold(c.port, tables, claimed, active, node_of,
                             c.port.pod_order.to(torch.int32))
    assert sorted(v for v in ch[0].tolist() if v >= 0) == [0, 1, 2]
    assert int(folded.sum()) == 3
    assert all(v == 0 for v in kernel_build.launch_counts.values())


def _row(V, *idx):
    r = np.zeros((1, V), bool)
    r[0, list(idx)] = True
    return r


def test_sdr_safe_choice_crossing_sets():
    """Crossing candidate sets (A{0,3}, B{0,1}, C{0,1}): SDR starts A at
    pv3; a dynamic-capable slot with no safe candidate rides dynamic, a
    needy one falls back to its lowest candidate — as the reference."""
    cases = [
        ([_row(4, 0, 3), _row(4, 0, 1), _row(4, 0, 1)], np.ones((1, 3), bool), False, 3),
        ([_row(4, 0), _row(4, 0)], np.array([[False, True]]), True, -1),
        ([_row(4, 0), _row(4, 0)], np.array([[False, True]]), False, 0),
    ]
    for cands, needy, dyn, expect in cases:
        MVol = len(cands)
        want = ref_vol._sdr_safe_choice(jnp.asarray(cands[0]), [jnp.asarray(x) for x in cands],
                                        jnp.asarray(needy), jnp.asarray([dyn]), MVol, 0)
        got = port_vol._sdr_safe_choice(torch.from_numpy(cands[0]),
                                        [torch.from_numpy(x) for x in cands],
                                        torch.from_numpy(needy), torch.tensor([dyn]), MVol, 0)
        _eq(got, want, "_sdr_safe_choice")
        assert int(got[0]) == expect


@pytest.mark.parametrize("MVol", range(1, 10))
def test_subset_enumerations_match_reference(MVol):
    assert port_vol._hall_subsets(MVol) == ref_vol._hall_subsets(MVol)
    for j in range(MVol):
        assert port_vol._sdr_other_subsets(MVol, j) == ref_vol._sdr_other_subsets(MVol, j)
