"""The port's incremental packed encode against a full encode and against
the reference encoder (`tests/test_packed_encoder.py`'s sequences).

Three encoders take the same sequence of objects (the port's made by the
port's `MakePod` and `synth`, the reference's by its own, from the same
seeds):
the port's `encode_packed`, which takes the delta path where it can; a
second port encoder with `incremental=False`, which full-encodes every
frame; and the reference's `encode_packed`. On every frame:

- the two port frames' host buffers and specs are bit for bit equal;
- every unpacked field (floats by their bits), every aux field and
  `pref_raw_bound` equal the reference frame's;
- on a delta frame, `dirty` holds every slot whose pod row differs
  between consecutive full encodes (the full encoder's row comparison,
  with its port-bearing slots when NodePorts' used ports moved); on a
  full frame both port encoders give the same `dirty`.

The port's `delta_hits`, `fold_hits` and `full_encodes` are asserted
where the reference's tests assert its own, and held equal to the
reference's counters where the reference can take the same path (its fold
needs its C++ row writer). No cycle runs: host only."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import k8s_scheduler_tpu.config.types as ref_config
import k8s_scheduler_tpu.framework.queuesort as ref_queuesort
import k8s_scheduler_tpu.models as ref_models
import k8s_scheduler_tpu.models.api as ref_api
import k8s_scheduler_tpu.models.packing as ref_packing
import k8s_scheduler_tpu.utils.synth as ref_synth
import k8s_scheduler_tpu_torch.config as port_config
import k8s_scheduler_tpu_torch.framework.queuesort as port_queuesort
import k8s_scheduler_tpu_torch.models as port_models
import k8s_scheduler_tpu_torch.models.api as port_api
import k8s_scheduler_tpu_torch.utils.synth as port_synth
from k8s_scheduler_tpu import native as ref_native
from k8s_scheduler_tpu_torch.models import packing
from k8s_scheduler_tpu_torch.models.encoding import (
    ARRAY_FIELDS,
    AUX_FIELDS,
    pref_raw_bound,
)
from torch_one_thread import one_torch_thread  # noqa: F401

REF_FOLDS = ref_native.pod_rows_into is not None  # the reference's fold can run


@dataclasses.dataclass
class Frame:
    nodes: list
    pending: list
    existing: list = ()
    groups: list = ()
    mutated: tuple = ()  # pods whose nominated node changed in place
    kw: dict = dataclasses.field(default_factory=dict)  # volumes


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


class Trio:
    """The port's encoder, a full-encoding port encoder and the reference's,
    fed the same objects frame by frame."""

    def __init__(self, port_kw=None, ref_kw=None, ref_full=False, **kw):
        self.port = port_models.SnapshotEncoder(device="cpu", **kw, **(port_kw or {}))
        self.full = port_models.SnapshotEncoder(device="cpu", incremental=False, **kw,
                                                **(port_kw or {}))
        self.ref = ref_models.SnapshotEncoder(**kw, **(ref_kw or {}))
        self.ref_full = ref_full  # the reference's full encode, not its encode_packed
        self.frames = []  # (path, frame) of the port's encoder

    def step(self, pf: Frame, rf: Frame):
        args = (pf.nodes, pf.pending, pf.existing, pf.groups)
        n0 = self.port.delta_hits
        got = self.port.encode_packed(*args, mutated_ids={id(p) for p in pf.mutated}, **pf.kw)
        delta = self.port.delta_hits > n0
        full = self.full.encode_packed(*args, mutated_ids={id(p) for p in pf.mutated}, **pf.kw)
        if self.ref_full:
            snap = self.ref.encode(rf.nodes, rf.pending, rf.existing, rf.groups, **rf.kw)
            rspec = ref_packing.make_spec(snap)
            w, b = ref_packing.pack(snap, rspec)
        else:
            w, b, rspec, _view, _rdirty = self.ref.encode_packed(
                rf.nodes, rf.pending, rf.existing, rf.groups,
                mutated_ids={id(p) for p in rf.mutated}, **rf.kw)
        # the delta frame is the full encode's, bit for bit
        assert got.spec.key() == full.spec.key()
        assert torch.equal(got.wbuf, full.wbuf) and torch.equal(got.bbuf, full.bbuf)
        # and the reference's
        ref = ref_packing.unpack(np.asarray(w), np.asarray(b), rspec)
        for name in ARRAY_FIELDS:
            have, want = _bits(getattr(got.snap, name)), _bits(getattr(ref, name))
            assert have.dtype == want.dtype and have.shape == want.shape, name
            np.testing.assert_array_equal(have, want, err_msg=name)
        for name in AUX_FIELDS:
            assert getattr(got.snap, name) == getattr(ref, name), name
        assert got.snap.pref_raw_bound == pref_raw_bound(
            ref.pod_pref_aff, ref.pod_pref_aff_w, ref.pod_tsc, ref.exist_pref_aff,
            ref.exist_pref_aff_w)
        # dirty covers every row a full encode finds changed
        if delta:
            assert got.dirty is not None and full.dirty is not None
            assert set(full.dirty.tolist()) <= set(got.dirty.tolist())
            assert (set(self.full.last_changed_slots.tolist())
                    <= set(self.port.last_changed_slots.tolist()))
            assert self.port.delta_profile
        else:
            assert (got.dirty is None) == (full.dirty is None)
            if got.dirty is not None:
                np.testing.assert_array_equal(got.dirty, full.dirty)
            assert self.port.delta_profile == {}
        self.frames.append(("delta" if delta else "full", got))
        return got

    def run(self, scenario, **kw):
        for pf, rf in zip(scenario(port_models, port_api, port_synth, **kw),
                          scenario(ref_models, ref_api, ref_synth, **kw)):
            self.step(pf, rf)
        return self

    def paths(self):
        return [p for p, _ in self.frames]

    def counters(self, enc):
        return (enc.full_encodes, enc.delta_hits)


# ---- the reference's sequences (tests/test_packed_encoder.py) ----------


def churned(m, api, synth):
    rng = np.random.default_rng(0)
    nodes = synth.make_cluster(10)
    pending = synth.make_pods(
        60, seed=1, affinity_fraction=0.3, anti_affinity_fraction=0.2,
        spread_fraction=0.2, selector_fraction=0.3, num_apps=6, priorities=(0, 10))
    existing = [(p, f"node-{i % 10}") for i, p in enumerate(
        synth.make_pods(20, seed=2, name_prefix="run", affinity_fraction=0.2, num_apps=6))]
    for i in range(8):
        idx = rng.choice(len(pending), size=15, replace=False)
        fresh = synth.make_pods(
            15, seed=100 + i, name_prefix=f"p{i}-", affinity_fraction=0.3,
            spread_fraction=0.2, selector_fraction=0.3, num_apps=6, priorities=(0, 10))
        for j, f in zip(idx, fresh):
            pending[j] = f
        yield Frame(nodes, pending, existing)


def pending_counts(m, api, synth):
    nodes = synth.make_cluster(4)
    pods = synth.make_pods(40, seed=3)
    yield Frame(nodes, pods)
    yield Frame(nodes, pods[:25])  # shrink
    # grow, with new app labels: the interning grows, a full encode
    yield Frame(nodes, pods[:25] + synth.make_pods(10, seed=4, name_prefix="n"))
    yield Frame(nodes, [])  # empty pending


def stable_change(m, api, synth):
    nodes = synth.make_cluster(4)
    pods = synth.make_pods(20, seed=5)
    yield Frame(nodes, pods, [(pods[0], "node-0")])
    nodes2 = synth.make_cluster(5)  # a new node list: full path
    yield Frame(nodes2, pods, [(pods[0], "node-0")])
    # the running list changed in place of an element: full path
    yield Frame(nodes2, pods, [(pods[0], "node-1"), (pods[1], "node-2")])
    yield Frame(nodes2, pods, [(pods[0], "node-1"), (pods[1], "node-2")])


def nomination(m, api, synth):
    nodes = synth.make_cluster(4)
    pods = synth.make_pods(20, seed=6)
    yield Frame(nodes, pods)
    pods[3].nominated_node_name = "node-2"  # what serving does after preemption
    yield Frame(nodes, pods, mutated=(pods[3],))


def gangs_ports_pins(m, api, synth):
    nodes = synth.make_cluster(6)
    pods = [m.MakePod(f"g-{i}").req({"cpu": "500m"}).group("job-a").created(float(i)).obj()
            for i in range(4)]
    pods.append(m.MakePod("portpod").req({"cpu": "100m"}).host_port(8080).obj())
    pods.append(m.MakePod("pinned").req({"cpu": "100m"}).node("node-2").obj())
    pods.append(m.MakePod("port2").req({"cpu": "100m"}).host_port(8081).obj())
    groups = [api.PodGroup("job-a", 3)]
    yield Frame(nodes, pods, groups=groups)
    # a new distinct port within the sticky Q pad; the port ids of the
    # unchanged port pod behind it move
    pods[4] = m.MakePod("portpod2").req({"cpu": "100m"}).host_port(8082).obj()
    yield Frame(nodes, pods, groups=groups)
    pods[4] = m.MakePod("noport").req({"cpu": "100m"}).obj()
    yield Frame(nodes, pods, groups=groups)
    yield Frame(nodes, pods, groups=[api.PodGroup("job-a", 4)])  # min member through the delta


def volumes(m, api, synth):
    """Claims with and without PVCs and PVs (modes 0-2) in the dirty batch."""
    nodes = synth.make_cluster(6)
    pending = synth.make_pods(30, seed=11, affinity_fraction=0.3, num_apps=4)
    pending += [m.MakePod(f"vol-{i}").req({"cpu": "250m"}).volume(f"claim-{i}").obj()
                for i in range(4)]
    vol = dict(
        pvcs=[api.PersistentVolumeClaim("claim-0", storage_class="local", request=2**30),
              api.PersistentVolumeClaim("claim-new", storage_class="local", request=2**30)],
        pvs=[api.PersistentVolume("pv-0", capacity=2**31, storage_class="local")],
        storage_classes=[api.StorageClass("local", api.VOLUME_BINDING_WAIT,
                                          provisioner=False)])
    yield Frame(nodes, pending, kw=vol)
    pending[0] = synth.make_pods(1, seed=99, name_prefix="fresh", num_apps=4)[0]
    pending[30] = m.MakePod("vol-new").req({"cpu": "250m"}).volume("claim-new").obj()
    yield Frame(nodes, pending, kw=vol)
    pending[1] = synth.make_pods(1, seed=100, name_prefix="fresh2", num_apps=4)[0]
    yield Frame(nodes, pending, kw=vol)


def guard_overflow(m, api, synth):
    nodes = synth.make_cluster(4)
    pods = synth.make_pods(20, seed=12)
    yield Frame(nodes, pods)
    pods[3] = (m.MakePod("many-labels").req({"cpu": "100m"})
               .labels({f"key-{j}": f"v-{j}" for j in range(40)}).obj())  # past MPL
    yield Frame(nodes, pods)
    pods[4] = synth.make_pods(1, seed=101, name_prefix="after")[0]
    yield Frame(nodes, pods)  # a delta over the grown arena


def fold(m, api, synth):
    nodes = synth.make_cluster(8)
    pods = synth.make_pods(40, seed=21, affinity_fraction=0.2, num_apps=5)
    pods[7] = m.MakePod("portpod").req({"cpu": "100m"}).host_port(8080).obj()
    existing = [(p, f"node-{i % 8}") for i, p in enumerate(
        synth.make_pods(20, seed=22, name_prefix="run", num_apps=5))]
    yield Frame(nodes, pods, existing)
    yield Frame(nodes, pods, existing)  # warm the delta path
    # bindings fold in (append), one of them port-bearing
    bound = [(pods[i], f"node-{i % 8}") for i in range(6)]
    bound.append((m.MakePod("bport").req({"cpu": "100m"}).host_port(9090).obj(), "node-3"))
    existing2 = existing + bound
    pending2 = pods[6:] + synth.make_pods(5, seed=31, name_prefix="arr", num_apps=5)
    yield Frame(nodes, pending2, existing2)
    existing3 = existing2[:len(existing)]  # a completion batch: the tail leaves
    yield Frame(nodes, pending2, existing3)
    # re-base: an appended pod older than every running one
    old_pod = m.MakePod("ancient").req({"cpu": "100m"}).created(-1000.0).obj()
    existing4 = existing3 + [(old_pod, "node-1")]
    yield Frame(nodes, pending2, existing4)
    yield Frame(nodes, pending2, existing4[1:])  # a removal from the front: full path


def fold_float(m, api, synth):
    """0.1-core requests are inexact in f32: a subtracting un-fold would
    drift by ULPs from a fresh assembly."""
    nodes = synth.make_cluster(4)
    pods = [m.MakePod(f"t-{i}").req({"cpu": "100m", "memory": "100Mi"}).obj()
            for i in range(24)]
    existing = [(m.MakePod(f"r-{i}").req({"cpu": "100m"}).obj(), f"node-{i % 4}")
                for i in range(12)]
    yield Frame(nodes, pods, existing)
    yield Frame(nodes, pods, existing)
    for r in range(3):
        existing = existing + [(pods[r * 4 + j], f"node-{j % 4}") for j in range(4)]
        yield Frame(nodes, pods, existing)
        existing = existing[:12]
        yield Frame(nodes, pods, existing)


def fold_pdbs(m, api, synth):
    """A fold under PDBs: the appended pods' exist_pdb rows, in list order,
    at most two a pod; a PDB's disruptionsAllowed changing: full path."""
    nodes = synth.make_cluster(6)
    pods = synth.make_pods(24, seed=41, num_apps=3)
    existing = [(p, f"node-{i % 6}") for i, p in enumerate(
        synth.make_pods(12, seed=42, name_prefix="run", num_apps=3))]
    sel = m.LabelSelector
    pdbs = [api.PodDisruptionBudget("all", selector=sel(), disruptions_allowed=1),
            api.PodDisruptionBudget("app-1", selector=sel(match_labels={"app": "app-1"}),
                                    disruptions_allowed=0),
            api.PodDisruptionBudget("app-2", selector=sel(match_labels={"app": "app-2"}),
                                    disruptions_allowed=2)]
    yield Frame(nodes, pods, existing, kw=dict(pdbs=pdbs))
    existing = existing + [(pods[i], f"node-{i % 6}") for i in range(5)]
    yield Frame(nodes, pods[5:], existing, kw=dict(pdbs=pdbs))
    pdbs[1].disruptions_allowed = 1
    yield Frame(nodes, pods[5:], existing, kw=dict(pdbs=pdbs))
    yield Frame(nodes, pods[5:], existing[:14], kw=dict(pdbs=pdbs))


def queue_sorted(m, api, synth):
    nodes = synth.make_cluster(4)
    pods = synth.make_pods(30, seed=51, priorities=(0, 5, 10))
    yield Frame(nodes, pods)
    for k in (2, 9, 17):
        pods[k] = m.MakePod(f"late-{k}").req({"cpu": "100m"}).priority(10).created(
            -float(k)).obj()
    yield Frame(nodes, pods)


# ---- the tests ----------------------------------------------------------


def test_packed_equals_full_over_churned_sequence():
    t = Trio(pad_pods=128, pad_nodes=16).run(churned)
    assert len({f.spec.layout_key() for _, f in t.frames}) == 1  # sticky dims
    assert t.counters(t.port) == t.counters(t.ref)
    assert t.paths()[0] == "full" and t.port.delta_hits >= 5
    assert t.full.delta_hits == 0 and t.full.full_encodes == 8


def test_packed_pending_count_changes():
    t = Trio(pad_pods=128, pad_nodes=16).run(pending_counts)
    assert t.paths() == ["full", "delta", "full", "delta"]
    assert t.counters(t.port) == t.counters(t.ref)
    # the shrink empties slots 25-39: their rows changed
    assert set(range(25, 40)) <= set(t.frames[1][1].dirty.tolist())


def test_packed_detects_stable_change():
    t = Trio(pad_pods=128, pad_nodes=16).run(stable_change)
    assert t.paths() == ["full", "full", "full", "delta"]
    assert t.counters(t.port) == t.counters(t.ref)
    assert t.port.full_reason == "the running list changed other than by an append or a tail removal"


def test_packed_nominated_mutation_reported():
    t = Trio(pad_pods=128, pad_nodes=16).run(nomination)
    assert t.paths() == ["full", "delta"]
    assert t.frames[1][1].dirty.tolist() == [3]
    assert t.counters(t.port) == t.counters(t.ref)


def test_packed_gangs_and_ports_and_pins():
    t = Trio(pad_pods=128, pad_nodes=16).run(gangs_ports_pins)
    assert t.paths() == ["full", "delta", "delta", "delta"]
    assert t.counters(t.port) == t.counters(t.ref)
    # slot 6 keeps its pod but its port id moves when slot 4's port leaves
    assert t.frames[2][1].dirty.tolist() == [4, 6]
    assert t.frames[3][1].snap.group_min_member[0] == 4


def test_packed_volume_rows():
    t = Trio(pad_pods=128, pad_nodes=16).run(volumes)
    assert t.paths() == ["full", "delta", "delta"]
    assert t.counters(t.port) == t.counters(t.ref)
    assert bool(t.frames[-1][1].snap.has_volumes)


def test_packed_guard_overflow_falls_back_to_full():
    t = Trio(pad_pods=128, pad_nodes=16).run(guard_overflow)
    assert t.paths() == ["full", "full", "delta"]
    assert t.counters(t.port) == t.counters(t.ref)


def test_fold_existing_append_tail_remove_and_rebase():
    t = Trio(pad_pods=128, pad_nodes=16).run(fold)
    assert t.paths() == ["full", "delta", "delta", "delta", "delta", "full"]
    assert t.port.fold_hits == 3 and t.port.full_encodes == 2
    if REF_FOLDS:
        assert t.counters(t.port) == t.counters(t.ref) and t.ref.fold_hits == 3
    # the port-bearing bound pod moved node-3's used ports: the pending
    # port pod's slot joins the dirty rows of the append and the removal
    for k in (2, 3):
        assert 1 in t.frames[k][1].dirty.tolist()
    # re-based on the ancient pod: the run pods (created at 0-19) start at 1000-1019
    assert t.frames[4][1].snap.exist_start[:20].tolist() == [1000.0 + k for k in range(20)]


def test_fold_unfold_float_exactness_under_inexact_requests():
    t = Trio(pad_pods=128, pad_nodes=16).run(fold_float)
    assert t.port.fold_hits == 6 and t.port.full_encodes == 1
    if REF_FOLDS:
        assert t.ref.fold_hits >= 6 and t.counters(t.port) == t.counters(t.ref)


def test_fold_under_pdbs():
    t = Trio(pad_pods=128, pad_nodes=16, pad_existing=32).run(fold_pdbs)
    assert t.paths() == ["full", "delta", "full", "delta"]
    assert t.port.fold_hits == 2
    assert (t.frames[1][1].snap.exist_pdb[12:17] >= 0).any()
    if REF_FOLDS:
        assert t.counters(t.port) == t.counters(t.ref)


def test_pad_ma_mc_existing_presize_keeps_regime_stable():
    """MA / MC bucket by 2: a later 4-term pod flips the layout unless
    pad_ma / pad_mc pre-size it; pad_existing and pad_pods_per_node
    pre-size E and MPN into their buckets."""
    def aff_pod(m, name, terms):
        p = m.MakePod(name).req({"cpu": "1"})
        for _ in range(terms):
            p = p.pod_affinity("kubernetes.io/hostname", {"app": "x"})
        return p.spread(1, "kubernetes.io/hostname", {"app": "x"}).obj()

    def layouts(m, api, synth, **kw):
        node = m.MakeNode("n0").capacity({"cpu": "8"}).labels({"app": "x"}).obj()
        yield Frame([node], [aff_pod(m, "p0", 1)])
        yield Frame([node], [aff_pod(m, "p0", 1), aff_pod(m, "p1", 4)])

    unsized = Trio(pad_pods=8, pad_nodes=4).run(layouts)
    keys = [f.spec.layout_key() for _, f in unsized.frames]
    assert keys[0] != keys[1] and unsized.paths() == ["full", "full"]
    kw = dict(pad_pods=8, pad_nodes=4, pad_ma=4, pad_mc=4, pad_existing=100,
              pad_pods_per_node=12)
    sized = Trio(**kw)
    assert sized.port._sticky_dims == {}
    sized.run(layouts)
    assert sized.port._sticky_dims["MA"] == 4 and sized.port._sticky_dims["MC"] == 4
    assert sized.port._sticky_dims["E"] == 128 and sized.port._sticky_dims["MPN"] == 16
    keys = [f.spec.layout_key() for _, f in sized.frames]
    assert keys[0] == keys[1] and sized.paths() == ["full", "delta"]
    assert sized.port._sticky_dims == sized.ref._sticky_dims


def test_sticky_dims_do_not_shrink():
    enc = port_models.SnapshotEncoder(device="cpu", pad_pods=32, pad_nodes=8)
    nodes = port_synth.make_cluster(2)
    many = port_models.MakePod("lab").labels({f"k{i}": f"v{i}" for i in range(12)}).req(
        {"cpu": "1"}).obj()
    mpl = enc.encode(nodes, [many]).pod_label_keys.shape[1]
    tiny = port_models.MakePod("tiny").req({"cpu": "1"}).obj()
    assert enc.encode(nodes, [tiny]).pod_label_keys.shape[1] == mpl


def test_queue_sort_creation_sort_frames():
    t = Trio(pad_pods=64, pad_nodes=8, port_kw=dict(queue_sort=port_queuesort.CreationSort()),
             ref_kw=dict(queue_sort=ref_queuesort.CreationSort())).run(queue_sorted)
    assert t.paths() == ["full", "delta"]
    prio = Trio(pad_pods=64, pad_nodes=8).run(queue_sorted)
    for (_, a), (_, b) in zip(t.frames, prio.frames):
        assert not torch.equal(a.snap.pod_order, b.snap.pod_order)
    # FIFO: the three late pods were created first
    order = t.frames[1][1].snap.pod_order
    assert sorted(order[[2, 9, 17]].tolist()) == [0, 1, 2]


def test_queue_sort_for_profile_reads_the_config():
    cfg = {"profiles": [{"schedulerName": "fifo", "plugins": {"queueSort": {
        "enabled": [{"name": "CreationSort"}]}}, "pluginConfig": [
        {"name": "CreationSort", "args": {"newest_first": True}}]}, {}]}
    port_cfg, ref_cfg = port_config.load_config(cfg), ref_config.load_config(cfg)
    for name in ("fifo", "default-scheduler"):
        qs = port_queuesort.queue_sort_for_profile(port_cfg.profile(name))
        rq = ref_queuesort.queue_sort_for_profile(ref_cfg.profile(name))
        assert qs.name == rq.name and qs.args == rq.args
        prio = np.array([3, 1, 3, 0, 2], np.int32)
        creation = np.array([5.0, 1.0, 2.0, 2.0, 9.0])
        pods = [None] * 5
        np.testing.assert_array_equal(qs.rank(pods, prio, creation),
                                      rq.rank(pods, prio, creation))
    with pytest.raises(KeyError):
        port_queuesort.make_queue_sort("NoSuchSort")


def test_ingest_pod_round_trip():
    """Rows staged at admission are consumed by the next delta
    (`ingest_hits`); a staged parse that grows an interning table makes the
    next frame take the full path once; a pod staged before any full
    encode is a miss."""
    def arrivals(m, api, synth, enc=None):
        nodes = synth.make_cluster(4)
        pods = synth.make_pods(20, seed=61, num_apps=3)
        yield Frame(nodes, pods)
        fresh = synth.make_pods(3, seed=62, name_prefix="arr", num_apps=3)
        for p in fresh:
            assert enc[m].ingest_pod(p)
        pods = pods[:17] + fresh
        yield Frame(nodes, pods)
        new_label = m.MakePod("newlabel").req({"cpu": "100m"}).labels({"team": "z"}).obj()
        assert enc[m].ingest_pod(new_label)
        pods = pods[:19] + [new_label]
        yield Frame(nodes, pods)  # the staged table growth: full path
        late = synth.make_pods(1, seed=63, name_prefix="late", num_apps=3)[0]
        assert enc[m].ingest_pod(late)
        yield Frame(nodes, pods[:19] + [late])

    t = Trio(pad_pods=32, pad_nodes=8)
    enc = {port_models: t.port, ref_models: t.ref}
    assert not port_models.SnapshotEncoder(device="cpu").ingest_pod(
        port_models.MakePod("early").obj())
    t.run(arrivals, enc=enc)
    assert t.paths() == ["full", "delta", "full", "delta"]
    assert t.port.full_reason == "an ingested row grew an interning table"
    assert t.port.ingest_hits == 4 == t.ref.ingest_hits
    assert t.port.ingest_misses == 0 and "ingest" in t.port.delta_profile
    # the full path consumes no staged row: "newlabel"'s waits for clear_ingest
    assert len(t.port._staged) == 1
    t.port.clear_ingest()
    assert not t.port._staged
    # a staged row outlives the full path's cache sweep while it is staged
    enc = port_models.SnapshotEncoder(device="cpu", pad_pods=32, pad_nodes=8)
    nodes = port_synth.make_cluster(2)
    enc.encode_packed(nodes, port_synth.make_pods(20, seed=64))
    held = port_models.MakePod("held").req({"cpu": "100m"}).obj()
    enc.ingest_pod(held)
    enc.encode_packed(nodes, port_synth.make_pods(4, seed=65, name_prefix="x"))
    assert len(enc._pod_cache) < 20 and id(held) in enc._pod_cache
    enc.clear_ingest()
    assert not enc._staged


def test_hysteresis_pad_unit():
    enc = port_models.SnapshotEncoder(device="cpu", pad_hysteresis_pct=25.0)
    assert enc.hysteresis_pad("P", 64, 60) == 64  # first sighting
    assert enc.hysteresis_pad("P", 128, 80) == 128  # up-step: at once
    assert enc.hysteresis_pad("P", 64, 60) == 128  # 6% headroom in 64: hold
    assert enc.hysteresis_pad("P", 64, 40) == 64  # 37%: step down
    enc0 = port_models.SnapshotEncoder(device="cpu")
    assert enc0.hysteresis_pad("P", 128, 80) == 128
    assert enc0.hysteresis_pad("P", 64, 60) == 64


def test_hysteresis_holds_regime_under_oscillating_trace():
    """A pending count oscillating across a bucket boundary flips the
    layout at every crossing without hysteresis and once with it
    (tests/test_compile_cache.py's trace), as the reference's does."""
    def keys(pct, m, synth, device=None):
        kw = {"device": device} if device else {}
        enc = m.SnapshotEncoder(pad_hysteresis_pct=pct, **kw)
        nodes = synth.make_cluster(8)
        out = []
        for i in range(8):
            snap = enc.encode(nodes, synth.make_pods(70 if i % 2 else 60, seed=i))
            out.append((snap.P, snap.N))
        return out

    base = keys(0.0, port_models, port_synth, "cpu")
    assert sum(a != b for a, b in zip(base, base[1:])) >= 7
    held = keys(15.0, port_models, port_synth, "cpu")
    assert sum(a != b for a, b in zip(held, held[1:])) == 1
    assert held[1:] == [held[1]] * 7
    assert held == keys(15.0, ref_models, ref_synth) and base == keys(0.0, ref_models, ref_synth)


def test_hysteresis_hold_goes_through_the_delta_path():
    """With the knob on, a shrinking pending set keeps the held P on the
    delta path exactly as the full path does; with it off, the down-step
    is a full encode. The reference's delta path keeps its P pad whatever
    the bucket (its tests fix pad_pods), so here the frames are held to the
    reference's full encode."""
    def shrink(m, api, synth):
        nodes = synth.make_cluster(4)
        pods = synth.make_pods(70, seed=71)
        yield Frame(nodes, pods)
        yield Frame(nodes, pods[:60])
        yield Frame(nodes, pods[:40])

    held = Trio(pad_hysteresis_pct=15.0, ref_full=True).run(shrink)
    assert held.paths() == ["full", "delta", "full"]
    assert [f.snap.P for _, f in held.frames] == [128, 128, 64]
    plain = Trio(ref_full=True).run(shrink)
    assert plain.paths() == ["full", "full", "delta"]


def test_encoder_without_device_wants_the_card():
    if torch.cuda.is_available():
        assert port_models.SnapshotEncoder().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            port_models.SnapshotEncoder()


def test_frames_are_independent_of_later_encodes():
    """Each frame's buffers are its own: a later delta rewrites the arena,
    not an earlier frame's snapshot."""
    enc = port_models.SnapshotEncoder(device="cpu", pad_pods=32, pad_nodes=8)
    nodes = port_synth.make_cluster(4)
    pods = port_synth.make_pods(20, seed=81)
    f1 = enc.encode_packed(nodes, pods)
    w1 = f1.wbuf.clone()
    pods[0] = port_models.MakePod("other").req({"cpu": "3"}).obj()
    f2 = enc.encode_packed(nodes, pods)
    assert enc.delta_hits == 1 and torch.equal(f1.wbuf, w1)
    assert not torch.equal(f1.snap.pod_requested, f2.snap.pod_requested)
    hw, hb = enc.host_buffers()
    assert np.array_equal(hw.view(np.int32), f2.wbuf.numpy())
    assert np.array_equal(hb, f2.bbuf.numpy())
    # a direct encode() leaves the arena behind: the next frame is full
    enc.encode(nodes, pods)
    enc.encode_packed(nodes, pods)
    assert enc.full_encodes == 2
    assert enc.full_reason == "a direct encode() since the last packed frame"
    spec = packing.spec_of_fields({n: getattr(f2.snap, n).numpy() for n in ARRAY_FIELDS},
                                  {n: getattr(f2.snap, n) for n in AUX_FIELDS
                                   + ("pref_raw_bound",)})
    assert spec.key() == f2.spec.key()


def test_delta_frames_sweep_the_row_cache():
    """Serving takes the delta path almost every frame: the rows of pods
    that left are dropped there too, the cache bounded by twice the live
    set."""
    enc = port_models.SnapshotEncoder(device="cpu", pad_pods=16, pad_nodes=8)
    nodes = port_synth.make_cluster(4)
    mk = port_models.MakePod
    pods = [mk(f"p{i}").req({"cpu": "100m"}).obj() for i in range(10)]
    for f in range(8):
        pods = pods[5:] + [mk(f"f{f}-{i}").req({"cpu": "100m"}).obj() for i in range(5)]
        enc.encode_packed(nodes, pods)
        assert len(enc._pod_cache) <= 2 * len(pods)
    assert enc.full_encodes == 1 and enc.delta_hits == 7
