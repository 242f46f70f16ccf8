"""The port's rounds-engine latency cycle and DefaultPreemption on
snapshots with volumes, against the reference's.

`build_cycle_fn(commit_mode="rounds", outputs="latency", device="cpu")`
must give assignment, node_requested, unschedulable and gang_dropped
bit-equal to the reference's on every fixture of test_torch_volumes (the
fixtures of tests/test_volumes.py and tests/test_pv_arbitration.py, and
config #4's workload with `config4_volumes` at 200 nodes x 480 running x
400 pending), and the reference's validity oracle, given the PVCs, PVs
and classes, must hold the port's placements. The cycle on the plain
versions of K10-K12 gives the same decisions and launches nothing, and
`build_preemption_fn` is bit-equal to the reference's on volume fixtures
(VolumeBinding's static mask gates the candidates)."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import k8s_scheduler_tpu.core.cycle as ref_cycle
from k8s_scheduler_tpu import oracle
from k8s_scheduler_tpu_torch.core.cycle import build_cycle_fn, build_preemption_fn
from k8s_scheduler_tpu_torch.models import MakeNode, MakePod, SnapshotEncoder
from k8s_scheduler_tpu_torch.models.api import (VOLUME_BINDING_WAIT, PersistentVolume,
                                                PersistentVolumeClaim, StorageClass)
from k8s_scheduler_tpu_torch.ops import kernel_build, volumes
from test_torch_volumes import FIXTURES, REF, carry, objects, reference_snapshot, to_api
from torch_one_thread import one_torch_thread  # noqa: F401

FIELDS = ("assignment", "node_requested", "unschedulable", "gang_dropped")
PLAIN = dict(volume_mask_fn=volumes.volume_mask_plain,
             pv_choice_fn=volumes.pv_choice_plain, pv_fold_fn=volumes.pv_fold_plain)
GiB = 2**30


def _assert_same(got, want, fields=FIELDS):
    for field in fields:
        w = np.asarray(getattr(want, field))
        g = getattr(got, field).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)


@functools.lru_cache(maxsize=None)
def _run(case):
    """(reference decision, port decision, port snapshot) of a case, run
    once per case (the 8-slot fixtures take half a minute to compile)."""
    name, kw = CASES[case]
    ref_snap = reference_snapshot(name)
    want = ref_cycle.build_cycle_fn(commit_mode="rounds", outputs="latency", **kw)(ref_snap)
    port_snap = carry(ref_snap)
    got = build_cycle_fn(commit_mode="rounds", outputs="latency", device="cpu",
                         **kw)(port_snap)
    return want, got, port_snap


CASES = {f: (f, {}) for f in FIXTURES}
CASES["contending_one_pass"] = ("contending", {"rounds_kw": {"passes_round0": 1, "passes": 1}})
CASES["two_pvs_4_one_round"] = ("two_pvs_4", {"max_rounds": 1})


@pytest.mark.parametrize("case", list(CASES))
def test_volume_cycle_bit_equal_to_reference(case):
    name, kw = CASES[case]
    want, got, _ = _run(case)
    _assert_same(got, want)
    nodes, pods, existing, groups, vol = objects(name, REF)
    a = got.assignment.numpy()[: len(pods)]
    unwound = bool(got.gang_dropped.any())
    violations = oracle.validate_rounds_assignment(
        nodes, pods, a, existing, round_cap_hit="max_rounds" in kw,
        allow_feasible_unplaced=np.flatnonzero(a < 0) if unwound else (), **vol)
    # config #4's running workload alone overloads some nodes; only a node
    # that received pods this cycle must end within its allocatable
    got_pods = {nodes[n].name for n in a[a >= 0].tolist()}
    violations = [v for v in violations if "over capacity" not in v
                  or v.split(":")[0].removeprefix("node ") in got_pods]
    if len(nodes) >= 100:
        # node sampling (adaptive, 100 nodes per pod here) may leave a pod
        # unplaced that a node outside its window could take; the oracle
        # does not model the window
        violations = [v for v in violations if "feasible" not in v]
    assert violations == [], violations[:5]
    if name in ("single_pv_3", "gang_unwind"):
        assert (a >= 0).sum() == (1 if name == "single_pv_3" else 0)
    if name == "three_pvs_3":
        assert (a >= 0).all()
    if name == "cfg4_volumes":
        assert (a >= 0).sum() > 300


@pytest.mark.parametrize("name", ["contending", "two_pvs_4", "eight_slot_dominance",
                                  "cfg4_volumes"])
def test_forced_plain_volume_kernels_give_the_same_cycle(name):
    """The run K10-K12 are held against on the card: their plain versions
    forced, launching nothing."""
    want, _, port_snap = _run(name)
    kernel_build.reset_launch_counts()
    _assert_same(build_cycle_fn(commit_mode="rounds", outputs="latency", device="cpu", **PLAIN)(port_snap),
                 want)
    assert all(v == 0 for v in kernel_build.launch_counts.values())


def _volume_gate(m):
    """Three one-node zones full of low-priority pods; an urgent pod whose
    bound PV is pinned to z1 may only preempt on z1's node, and a second
    urgent pod whose only static PV is claimed falls back to nothing."""
    a = m.api
    zone = "topology.kubernetes.io/zone"
    nodes = [m.MakeNode(f"n-{z}").capacity({"cpu": "2"}).labels({zone: z}).obj()
             for z in ("z0", "z1", "z2")]
    existing = [(m.MakePod(f"low-{z}-{i}").req({"cpu": "1"}).priority(1).created(float(i)).obj(),
                 f"n-{z}") for z in ("z0", "z1", "z2") for i in range(2)]
    term = a.NodeSelectorTerm((a.NodeSelectorRequirement(zone, "In", ("z1",)),))
    pvs = [a.PersistentVolume("pv-z1", capacity=10 * GiB, storage_class="ssd",
                              node_affinity=(term,), claim_ref="default/data"),
           a.PersistentVolume("pv-local", capacity=10 * GiB, storage_class="local",
                              claim_ref="default/other")]
    pvcs = [a.PersistentVolumeClaim("data", storage_class="ssd", request=GiB,
                                    volume_name="pv-z1"),
            a.PersistentVolumeClaim("scratch", storage_class="local", request=GiB)]
    classes = [a.StorageClass("local", a.VOLUME_BINDING_WAIT, provisioner=False)]
    pods = [m.MakePod("urgent").req({"cpu": "1"}).priority(10).volume("data").obj(),
            m.MakePod("stuck").req({"cpu": "1"}).priority(10).volume("scratch")
            .created(1.0).obj(),
            m.MakePod("free").req({"cpu": "1"}).priority(10).created(2.0).obj()]
    return nodes, pods, existing, [], dict(pvcs=pvcs, pvs=pvs, storage_classes=classes)


def _preemption_objects(name, m):
    if name == "volume_gate":
        return _volume_gate(m)
    return objects(name, m)


@pytest.mark.parametrize("name", ["volume_gate", "cfg4_volumes", "bound_zone"])
def test_volume_preemption_bit_equal_to_reference(name):
    import k8s_scheduler_tpu.models as ref_models

    if name in CASES:  # the cycle test's run of the same snapshot
        want_d, d, port_snap = _run(name)
        ref_snap = reference_snapshot(name)
    else:
        nodes, pods, existing, groups, vol = _preemption_objects(name, REF)
        ref_snap = ref_models.SnapshotEncoder().encode(nodes, pods, existing, groups, **vol)
        want_d = ref_cycle.build_cycle_fn(commit_mode="rounds", outputs="latency")(ref_snap)
        port_snap = carry(ref_snap)
        d = build_cycle_fn(commit_mode="rounds", outputs="latency", device="cpu")(port_snap)
    want = ref_cycle.build_preemption_fn()(ref_snap, want_d)
    _assert_same(d, want_d)
    got = build_preemption_fn(device="cpu")(port_snap, d)
    _assert_same(got, want, ("nominated", "victims", "num_preemptors"))
    kernel_build.reset_launch_counts()
    plain = build_preemption_fn(device="cpu", volume_mask_fn=volumes.volume_mask_plain)
    _assert_same(plain(port_snap, d), want, ("nominated", "victims", "num_preemptors"))
    if name == "volume_gate":
        nom = got.nominated.numpy()[:3].tolist()
        assert nom[0] == 1 and nom[1] == -1 and nom[2] >= 0, nom


def test_volume_entry_point_on_cpu():
    """The library boundary: builders -> encoder (with PVCs, PVs and a
    class) -> cycle. Two claimants of one local PV: the first by rank
    places on the PV's node, the second stays unplaced."""
    nodes = [MakeNode(f"n{i}").capacity({"cpu": "4"}).obj() for i in range(3)]
    from k8s_scheduler_tpu_torch.models.api import NodeSelectorRequirement, NodeSelectorTerm

    pvs = [PersistentVolume("pv-0", capacity=10 * GiB, storage_class="local",
                            node_affinity=(NodeSelectorTerm((NodeSelectorRequirement(
                                "kubernetes.io/hostname", "In", ("n2",)),)),))]
    pvcs = [PersistentVolumeClaim(f"c{i}", storage_class="local", request=GiB)
            for i in range(2)]
    pods = [MakePod(f"p{i}").req({"cpu": "1"}).volume(f"c{i}").created(float(i)).obj()
            for i in range(2)]
    snap = SnapshotEncoder(device="cpu").encode(
        nodes, pods, pvcs=pvcs, pvs=pvs,
        storage_classes=[StorageClass("local", VOLUME_BINDING_WAIT, provisioner=False)])
    assert snap.has_volumes and snap.pv_avail[0]
    d = build_cycle_fn(commit_mode="rounds", outputs="latency", device="cpu")(snap)
    assert d.assignment[:2].tolist() == [2, -1]
    assert d.unschedulable[:2].tolist() == [False, True]


def test_rounds_commit_refuses_volumes_without_pv_guard():
    """Without `pv_choice_fn` two claimants of one static PV could both be
    accepted in a round: a snapshot with volumes is refused."""
    from k8s_scheduler_tpu_torch.ops.rounds import rounds_commit

    snap = carry(reference_snapshot("contending"))
    assert snap.has_volumes
    with pytest.raises(ValueError, match="pv_choice_fn"):
        rounds_commit(snap=snap, sbase=torch.zeros(snap.P, snap.N),
                      m_pending=torch.zeros((0, snap.P), dtype=torch.bool),
                      dyn_batched_view_fn=None, update_batched_view_fn=None, extra={})


def test_to_api_rebuilds_reference_objects():
    nodes, pods, existing, _, vol = objects("cfg4_volumes", REF)
    import k8s_scheduler_tpu.models.api as ref_api

    assert type(pods[0]).__module__ == ref_api.__name__
    assert type(vol["pvs"][0].node_affinity[0]).__module__ == ref_api.__name__
    assert to_api(vol["pvcs"], ref_api) == vol["pvcs"]
    assert torch.is_tensor(carry(reference_snapshot("bound_zone")).pv_avail)
