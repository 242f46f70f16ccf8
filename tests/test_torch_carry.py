"""The port's device-carry latency path against the reference's.

- `models/packing.py`: pack / unpack round-trips every field bit for bit
  on the five synth configs at small scale, with the reference's field
  layout (names, dtypes, shapes), every field a 16-byte-aligned view into
  the two buffers, and `encode_packed`'s snapshot equal to the reference
  encoder's.
- The reference's churn loop (tests/test_carry.py: 10 nodes, 70 pods with
  priorities and affinity, 6 frames of 18 replaced pods): the port's
  carry cycle (`build_packed_cycle_carry_fn` over `CarryKeeper`) bit-equal
  to the reference's on the same objects (the engine's round counters
  included) and to the port's fresh rounds cycle; the carried `sbase` and `mp` equal to a fresh `carry_init` after
  every update; packed preemption equal to the reference's and to
  `build_preemption_fn`.
- NodePorts' coupling to the existing pods: a running pod with a host
  port appended to the existing set marks every port-bearing pending slot
  dirty, and the updated carry equals a fresh one.
- A gang that is dropped after its members claimed static PVs: the
  cycle's `pv_claimed` refolds the survivors' claims as the reference's.
- Packed preemption on a volume gate equal to the reference's.

Every comparison is exact (floats by their bits)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import k8s_scheduler_tpu.core.cycle as ref_cycle
import k8s_scheduler_tpu.models as ref_models
import k8s_scheduler_tpu.models.packing as ref_packing
import k8s_scheduler_tpu.utils.synth as ref_synth
import k8s_scheduler_tpu_torch.models as port_models
import k8s_scheduler_tpu_torch.utils.synth as port_synth
from k8s_scheduler_tpu_torch.core import cycle as port_cycle
from k8s_scheduler_tpu_torch.models import packing
from test_torch_cycle_volumes import _preemption_objects
from test_torch_encoding import assert_same_snapshot, fixture
from test_torch_volumes import PORT, REF, objects
from torch_one_thread import one_torch_thread  # noqa: F401

RESULT = ("assignment", "node_requested", "unschedulable", "gang_dropped", "reject_counts",
          "pv_claimed", "rounds_used", "accepted_per_round", "diag_per_round")
PREEMPTION = ("nominated", "victims", "num_preemptors")


def _bits(t) -> np.ndarray:
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(got, want, fields) -> None:
    for f in fields:
        g, w = _bits(getattr(got, f)), _bits(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def _same_carry(a: dict, b: dict) -> None:
    assert torch.equal(a["sbase"].view(torch.int32), b["sbase"].view(torch.int32))
    assert torch.equal(a["mp"], b["mp"])


@pytest.mark.parametrize("name", ["cfg1", "cfg2", "cfg3", "cfg4", "cfg5"])
def test_pack_unpack_round_trip(name):
    nodes, pods, existing, groups = fixture(name, port_models, port_synth)
    snap = port_models.SnapshotEncoder(device="cpu").encode(nodes, pods, existing, groups)
    spec = packing.make_spec(snap)
    w, b = packing.pack(snap, spec)
    wt, bt = torch.from_numpy(w.view(np.int32)), torch.from_numpy(b)
    got = packing.unpack(wt, bt, spec)
    for f in dataclasses.fields(snap):
        want, have = getattr(snap, f.name), getattr(got, f.name)
        if isinstance(want, torch.Tensor):
            assert have.dtype == want.dtype and have.shape == want.shape, f.name
            np.testing.assert_array_equal(_bits(have), _bits(want), err_msg=f.name)
            buf = bt if want.dtype == torch.bool else wt
            assert have.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
            assert (have.data_ptr() - buf.data_ptr()) % 16 == 0, f.name
        else:
            assert have == want, f.name
    # the reference's layout, field for field (offsets differ: the port
    # aligns each field)
    ref = ref_models.SnapshotEncoder().encode(*fixture(name, ref_models, ref_synth))
    rspec = ref_packing.make_spec(ref)
    assert [w_[:3] for w_ in spec.words] == [w_[:3] for w_ in rspec.words]
    assert [b_[:2] for b_ in spec.bools] == [b_[:2] for b_ in rspec.bools]
    frame = port_models.SnapshotEncoder(device="cpu").encode_packed(
        nodes, pods, existing, groups)
    assert frame.dirty is None and frame.spec.key() == spec.key()
    assert_same_snapshot(ref, frame.snap)


def _churn_pods(synth, n, seed, prefix=None):
    """tests/test_carry.py's pending draws: the first set with
    anti-affinity, the replacements (`prefix`) without."""
    kw = {"anti_affinity_fraction": 0.2} if prefix is None else {"name_prefix": prefix}
    return synth.make_pods(n, seed=seed, affinity_fraction=0.3, spread_fraction=0.2,
                           selector_fraction=0.3, num_apps=6, priorities=(0, 10), **kw)


class RefDriver:
    """The reference's carry path over packed frames, programs built per
    spec (its `tests/test_carry.py` drive, with its CarryKeeper)."""

    def __init__(self):
        self.enc = ref_models.SnapshotEncoder()
        self.key = None

    def step(self, nodes, pending, existing, groups=(), **vol):
        w, b, spec, _snap, dirty = self.enc.encode_packed(
            nodes, pending, existing, groups, vol.get("pvcs", ()), vol.get("pvs", ()),
            vol.get("storage_classes", ()))
        if spec.key() != self.key:
            self.key = spec.key()
            self.stable_fn = ref_cycle.build_stable_state_fn(spec)
            self.keeper = ref_cycle.CarryKeeper(spec)
            self.cycle = ref_cycle.build_packed_cycle_carry_fn(spec)
            self.preempt = ref_cycle.build_packed_preemption_fn(spec)
        stable = self.stable_fn(w, b)
        carry = self.keeper.state(w, b, stable, dirty, (spec.key(), self.enc._carry_key))
        out = self.cycle(w, b, stable, carry)
        return out, self.preempt(w, b, out, stable)


class PortDriver:
    """The port's carry path: a keeper per pack layout, the programs of
    each frame's spec."""

    def __init__(self):
        self.enc = port_models.SnapshotEncoder(device="cpu")
        self.keeper = None

    def step(self, nodes, pending, existing, groups=(), **vol):
        frame = self.enc.encode_packed(nodes, pending, existing, groups, **vol)
        w, b, spec = frame.wbuf, frame.bbuf, frame.spec
        stable = port_cycle.build_stable_state_fn(spec, device="cpu")(w, b)
        if self.keeper is None or self.keeper.spec.layout_key() != spec.layout_key():
            self.keeper = port_cycle.CarryKeeper(spec, device="cpu")
        carry = self.keeper.state(w, b, stable, frame.dirty, self.enc._carry_key)
        fresh = port_cycle.build_carry_fns(spec, device="cpu")[0](w, b, stable)
        _same_carry(carry, fresh)
        out = port_cycle.build_packed_cycle_carry_fn(spec, device="cpu")(w, b, stable, carry)
        _same_carry(carry, fresh)  # the cycle leaves the carry as it was
        pre = port_cycle.build_packed_preemption_fn(spec, device="cpu")(w, b, out, stable)
        # the fresh rounds cycle and preemption on the frame's snapshot
        d = port_cycle.build_cycle_fn(commit_mode="rounds", outputs="latency", device="cpu")(frame.snap)
        _same(out, d, ("assignment", "node_requested", "unschedulable", "gang_dropped",
                       "placed_round"))
        _same(pre, port_cycle.build_preemption_fn(device="cpu")(frame.snap, d), PREEMPTION)
        return frame, out, pre


def test_carry_cycle_matches_reference_over_churn():
    rng = np.random.default_rng(1)
    ref, port = RefDriver(), PortDriver()
    sides = {}
    for side, m, synth in (("ref", ref_models, ref_synth), ("port", port_models, port_synth)):
        existing = [(p, f"node-{i % 10}") for i, p in enumerate(
            synth.make_pods(20, seed=2, name_prefix="run", affinity_fraction=0.2, num_apps=6))]
        sides[side] = [synth.make_cluster(10), _churn_pods(synth, 70, 1), existing]
    updates = 0
    for i in range(6):
        idx = rng.choice(70, size=18, replace=False)
        for side, synth in (("ref", ref_synth), ("port", port_synth)):
            fresh = _churn_pods(synth, 18, 50 + i, f"c{i}-")
            for j, f in zip(idx, fresh):
                sides[side][1][j] = f
        want, want_pre = ref.step(*sides["ref"])
        frame, got, got_pre = port.step(*sides["port"])
        _same(got, want, RESULT)
        _same(got_pre, want_pre, PREEMPTION)
        assert (frame.dirty is None) == (i == 0)
        if i:
            assert set(frame.dirty) == set(port.enc.last_changed_slots)
            assert 0 < len(frame.dirty) <= 18 and port.keeper.last == "update"
            updates += 1
    assert updates == 5


def test_existing_pods_moving_used_ports_mark_port_pods_dirty():
    """NodePorts' static mask reads the running pods' host ports: appending
    a running pod that holds port 8080 on node-2 leaves every pending row
    as it was, and marks every port-bearing slot dirty (the reference's
    rule); the updated carry equals a fresh one and differs from the
    previous frame's on node-2 of the 8080 pods."""
    nodes = port_synth.make_cluster(6)
    pending = []
    for k, p in enumerate(port_synth.make_pods(24, seed=3)):
        if k % 3 == 0:
            p = port_models.MakePod(f"hp{k}").req({"cpu": "500m"}).host_port(
                8080 + k % 2).created(float(k)).obj()
        pending.append(p)
    existing = [(p, f"node-{i}") for i, p in enumerate(
        port_synth.make_pods(3, seed=4, name_prefix="run"))]
    port = PortDriver()
    f1, _, _ = port.step(nodes, pending, existing)
    before = port.keeper.carry["sbase"].clone()
    holder = port_models.MakePod("holder").req({"cpu": "100m"}).host_port(8080).obj()
    f2, _, _ = port.step(nodes, pending, existing + [(holder, "node-2")])
    port_slots = [k for k in range(len(pending)) if k % 3 == 0]
    assert f1.dirty is None and len(port.enc.last_changed_slots) == 0
    assert f2.dirty.tolist() == port_slots and port.keeper.last == "update"
    after = port.keeper.carry["sbase"]
    on_8080 = [k for k in port_slots if k % 2 == 0]
    assert (before[on_8080, 2] > -1e8).all() and (after[on_8080, 2] == -1e9).all()
    assert torch.equal(before[[k for k in port_slots if k % 2]],
                       after[[k for k in port_slots if k % 2]])


@pytest.mark.parametrize("name", ["gang_unwind", "gang_survivor"])
def test_dropped_gang_releases_its_static_pvs(name):
    """tests/test_pv_arbitration.py's gangs: the placed member claims a
    static PV and is unwound; `pv_claimed` holds only the survivors'
    claims (a refold, K12's plain version here), bit-equal to the
    reference's carry cycle."""
    nodes, pods, existing, groups, vol = objects(name, REF)
    want, want_pre = RefDriver().step(nodes, pods, existing, groups, **vol)
    nodes, pods, existing, groups, vol = objects(name, PORT)
    _, got, got_pre = PortDriver().step(nodes, pods, existing, groups, **vol)
    _same(got, want, RESULT)
    _same(got_pre, want_pre, PREEMPTION)
    assert got.gang_dropped.any()
    assert int(got.pv_claimed.sum()) == (1 if name == "gang_survivor" else 0)


def test_packed_preemption_matches_reference_on_a_volume_gate():
    """Three one-node zones full of low-priority pods and urgent pods whose
    volumes gate where they may preempt (test_torch_cycle_volumes):
    nominations and victims equal to the reference's packed preemption."""
    nodes, pods, existing, groups, vol = _preemption_objects("volume_gate", REF)
    want, want_pre = RefDriver().step(nodes, pods, existing, groups, **vol)
    nodes, pods, existing, groups, vol = _preemption_objects("volume_gate", PORT)
    _, got, got_pre = PortDriver().step(nodes, pods, existing, groups, **vol)
    _same(got, want, RESULT)
    _same(got_pre, want_pre, PREEMPTION)
    assert int(got_pre.num_preemptors) >= 1


def test_carry_entry_points_refuse_what_is_not_ported():
    with pytest.raises(NotImplementedError):
        port_cycle.build_packed_cycle_carry_fn(None, rounds_kw={"shortlist": 8}, device="cpu")
