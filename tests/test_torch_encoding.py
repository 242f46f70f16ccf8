"""The torch port's encoder against the reference encoder.

Both packages build the same synthetic objects from the same seeds with
their own builders; every array field (dtype, shape, values) and every
static flag of the port's snapshot must equal the reference snapshot's."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import k8s_scheduler_tpu.models as ref_models
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
    raise ValueError(name)


FIXTURES = ["cfg1", "cfg2", "cfg5", "mixed", "nominated"]


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
    assert_same_snapshot(reference_snapshot(name), port_snapshot(name))


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


def test_encoder_raises_on_volumes():
    nodes = [port_models.MakeNode("n").capacity({"cpu": "1"}).obj()]
    pods = [port_models.MakePod("p").req({"cpu": "1"}).volume("data").obj()]
    with pytest.raises(NotImplementedError, match="A4"):
        port_models.SnapshotEncoder(device="cpu").encode(nodes, pods)
