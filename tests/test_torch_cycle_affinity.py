"""The port's rounds-engine latency cycle on inter-pod affinity and
topology-spread snapshots, against the reference's.

`build_cycle_fn(commit_mode="rounds", outputs="latency", device="cpu")`
must give assignment, node_requested, unschedulable and gang_dropped
bit-equal to the reference's on every fixture of test_torch_interpod
(config #3- and #4-shaped synthetic workloads, a denser #4 mix, a mixed
workload with existing affinity pods, self-anti-affinity one per node,
spread skew, affinity bootstrap and colocation, duplicate term slots), and
the reference's validity oracle must hold the port's placements. The
cycle on the plain versions of K3-K6 forced explicitly gives the same
decisions (volumes: test_torch_cycle_volumes)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import k8s_scheduler_tpu.core.cycle as ref_cycle
import k8s_scheduler_tpu.models as ref_models
import k8s_scheduler_tpu.utils.synth as ref_synth
from k8s_scheduler_tpu import oracle
from k8s_scheduler_tpu_torch.core.cycle import build_cycle_fn
from k8s_scheduler_tpu_torch.models import MakeNode, MakePod, SnapshotEncoder
from k8s_scheduler_tpu_torch.ops import (affinity_update, capacity, guard_sweep,
                                         interpod_terms, kernel_build)
from test_torch_interpod import AFFINITY_FIXTURES, affinity_fixture, carry
from torch_one_thread import one_torch_thread  # noqa: F401

FIELDS = ("assignment", "node_requested", "unschedulable", "gang_dropped")

PLAIN = dict(
    interpod_terms_fn=interpod_terms.interpod_terms_plain,
    interpod_norm_fn=interpod_terms.interpod_norm_plain,
    affinity_update_fn=affinity_update.affinity_update_plain,
    capacity_fn=capacity.capacity_plain,
    guard_sweep_fn=guard_sweep.guard_sweep_plain,
)


def _run(name, kw=None):
    kw = kw or {}
    nodes, pods, existing, groups = affinity_fixture(name, ref_models, ref_synth)
    ref_snap = ref_models.SnapshotEncoder().encode(nodes, pods, existing, groups)
    want = ref_cycle.build_cycle_fn(commit_mode="rounds", outputs="latency", **kw)(ref_snap)
    port_snap = carry(ref_snap)
    got = build_cycle_fn(commit_mode="rounds", outputs="latency", device="cpu",
                         **kw)(port_snap)
    return (nodes, pods, existing), want, got, port_snap


def _assert_same(got, want):
    for field in FIELDS:
        w = np.asarray(getattr(want, field))
        g = getattr(got, field).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)


CASES = {f: (f, {}) for f in AFFINITY_FIXTURES}
CASES["mixed_one_pass"] = ("mixed", {"rounds_kw": {"passes_round0": 1, "passes": 1}})
CASES["cfg4_dense_compact4"] = ("cfg4_dense", {"rounds_kw": {"compact": 4}})


@pytest.mark.parametrize("case", list(CASES))
def test_affinity_cycle_bit_equal_to_reference(case):
    name, kw = CASES[case]
    (nodes, pods, existing), want, got, _ = _run(name, kw)
    _assert_same(got, want)
    a = got.assignment.numpy()[: len(pods)]
    assert (a >= 0).any()
    violations = oracle.validate_rounds_assignment(nodes, pods, a, existing)
    # config #4's running workload alone overloads some nodes; only a node
    # that received pods this cycle must end within its allocatable
    got_pods = {nodes[n].name for n in a[a >= 0].tolist()}
    violations = [v for v in violations if "over capacity" not in v
                  or v.split(":")[0].removeprefix("node ") in got_pods]
    assert violations == [], violations[:5]
    if name == "self_anti":
        placed = a[a >= 0]
        assert len(placed) == 4 == len(set(placed.tolist()))
    if name == "bootstrap":
        assert (a >= 0).all() and len({n % 2 for n in a.tolist()}) == 1


@pytest.mark.parametrize("name", ["existing", "duplicates", "cfg4_dense"])
def test_forced_plain_versions_give_the_same_cycle(name):
    """The run the kernels are held against on the card: every K3-K6
    function forced to its plain version, launching nothing."""
    _, want, got, port_snap = _run(name)
    kernel_build.reset_launch_counts()
    plain = build_cycle_fn(commit_mode="rounds", outputs="latency", device="cpu", **PLAIN)(port_snap)
    _assert_same(plain, want)
    assert all(v == 0 for v in kernel_build.launch_counts.values())
    placed = got.assignment >= 0
    assert torch.equal(got.placed_round >= 0, placed)
    assert int(got.placed_round.max()) >= 0


def test_affinity_entry_point_on_cpu():
    """The library boundary: builders -> encoder -> cycle, one anti-affine
    pair that must split across hosts and a pod that must join it."""
    nodes = [MakeNode(f"n{i}").capacity({"cpu": "4"})
             .labels({"kubernetes.io/hostname": f"n{i}",
                      "topology.kubernetes.io/zone": "z0" if i < 2 else "z1"}).obj()
             for i in range(4)]
    pods = [
        MakePod("db-0").req({"cpu": "1"}).labels({"app": "db"})
        .pod_affinity("kubernetes.io/hostname", {"app": "db"}, anti=True).obj(),
        MakePod("db-1").req({"cpu": "1"}).labels({"app": "db"})
        .pod_affinity("kubernetes.io/hostname", {"app": "db"}, anti=True).created(1.0).obj(),
        MakePod("web").req({"cpu": "1"}).labels({"app": "web"})
        .pod_affinity("topology.kubernetes.io/zone", {"app": "db"}).created(2.0).obj(),
    ]
    snap = SnapshotEncoder(device="cpu").encode(nodes, pods)
    a = build_cycle_fn(commit_mode="rounds", outputs="latency", device="cpu")(snap).assignment[:3].tolist()
    assert min(a) >= 0 and a[0] != a[1]
    assert (a[2] < 2) == (a[0] < 2) or (a[2] < 2) == (a[1] < 2)
