"""Multi-cycle and speculative dispatch in the port
(`core/cycle.build_packed_multicycle_fn`, `core/pipeline.dispatch_multi`,
`Scheduler._schedule_profile_multi` / `_multi_spec`) against the
reference's, on the CPU. Every comparison is exact.

- The batch program: the port's loop on the port's frames gives the
  reference's loop on the reference's frames (assignment, unschedulable,
  gang drops, attempted, post-cycle capacity, cycles run, final carry) on
  randomized groups in both engines; K = 1; the early exit on drain; a
  gang whose members span inner cycles; the carry-in continuation equal to
  the combined batch; each envelope reason.
- The Scheduler: a K = 4 port Scheduler, with speculation on and off,
  gives the port's K = 1 run the same bind stream, flight outcome counts,
  state digest and journal decision and arrival streams on three seeded
  traces, and the reference's K = 4 run the same on the trace with a gang
  split across two arrival groups (one trace: the reference compiles its
  batch programs for 30-50 s a Scheduler on the CPU); the envelope
  fallback (sticky for affinity, per batch for host ports); the admission
  depth counts the coalescing buffers."""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

import k8s_scheduler_tpu.config as ref_config
import k8s_scheduler_tpu.core as ref_core
import k8s_scheduler_tpu.models as ref_models
import k8s_scheduler_tpu.models.api as ref_api
import k8s_scheduler_tpu.state as ref_state
from k8s_scheduler_tpu.core.cycle import build_packed_multicycle_fn as ref_build
from k8s_scheduler_tpu.core.cycle import multicycle_unsupported_reason as ref_reason
from k8s_scheduler_tpu.framework.runtime import Framework as RefFramework
from k8s_scheduler_tpu.models import packing as ref_packing
from k8s_scheduler_tpu.models.encoding import SnapshotEncoder as RefEncoder
from k8s_scheduler_tpu.state.journal import replay_dir
import k8s_scheduler_tpu_torch.config as port_config
import k8s_scheduler_tpu_torch.core as port_core
import k8s_scheduler_tpu_torch.models as port_models
import k8s_scheduler_tpu_torch.models.api as port_api
import k8s_scheduler_tpu_torch.state as port_state
from k8s_scheduler_tpu_torch.core.cycle import build_packed_multicycle_fn as port_build
from k8s_scheduler_tpu_torch.core.cycle import multicycle_unsupported_reason as port_reason
from k8s_scheduler_tpu_torch.models import packing as port_packing
from k8s_scheduler_tpu_torch.models.encoding import SnapshotEncoder as PortEncoder
from torch_one_thread import one_torch_thread  # noqa: F401

REF = (ref_models, ref_api)
PORT = (port_models, port_api)


class FakeClock:
    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


# ---- the batch program ----------------------------------------------------


def _objects(m, api, seed, n_groups, gang=False):
    rng = random.Random(seed)
    nodes = [m.MakeNode(f"n{i}").capacity({"cpu": "4", "memory": "8Gi"})
             .labels({"tier": ("a", "b")[i % 2]}).obj() for i in range(5)]
    groups, uid = [], 0
    for gi in range(n_groups):
        g = []
        for _ in range(rng.randint(1, 6)):
            pb = m.MakePod(f"p{uid}").req({"cpu": rng.choice(["1", "2", "3"]),
                                            "memory": "1Gi"})
            if rng.random() < 0.3:
                pb = pb.node_selector({"tier": "a"})
            g.append(pb.obj())
            uid += 1
        groups.append(g)
    pgs = []
    if gang:
        # a gang (minMember 2) whose members span inner cycles 0 and 1: the
        # straggler in cycle 1 is alone, and survives only through the
        # loop's placed-count carry
        pgs = [api.PodGroup("gang", 2)]
        groups[0] = [m.MakePod(f"g{i}").req({"cpu": "1"}).group("gang").obj()
                     for i in range(2)] + groups[0][:1]
        groups[1] = [m.MakePod("g2").req({"cpu": "1"}).group("gang").obj()] + groups[1][:1]
    return nodes, groups, pgs


def _ref_feed(nodes, groups, pgs, k):
    enc = RefEncoder()
    enc.pad_pods = enc.pad_nodes = 8
    snaps = [enc.encode(nodes, g, (), pod_groups=pgs) for g in groups]
    spec = ref_packing.make_spec(snaps[0])
    w = np.zeros((k, spec.n_words), np.uint32)
    b = np.zeros((k, spec.n_bytes), np.uint8)
    for i, s in enumerate(snaps):
        w[i], b[i] = ref_packing.pack(s, spec)
    return spec, w, b


def _port_feed(nodes, groups, pgs, k):
    enc = PortEncoder(device="cpu")
    enc.pad_pods = enc.pad_nodes = 8
    frames = [enc.encode_numpy(nodes, g, (), pod_groups=pgs) for g in groups]
    specs = [port_packing.spec_of_fields(f, dict(a, pref_raw_bound=0.0)) for f, a in frames]
    assert all(s.key() == specs[0].key() for s in specs)
    w = np.zeros((k, specs[0].n_words), np.uint32)
    b = np.zeros((k, specs[0].n_bytes), np.uint8)
    for i, (f, _a) in enumerate(frames):
        w[i], b[i] = port_packing.pack(f, specs[0])
    return specs[0], torch.from_numpy(w.view(np.int32)), torch.from_numpy(b)


def _both(seed, n_groups, k, n_cycles, mode="rounds", gang=False):
    rn, rg, rp = _objects(*REF, seed, n_groups, gang)
    pn, pg, pp = _objects(*PORT, seed, n_groups, gang)
    rspec, rw, rb = _ref_feed(rn, rg, rp, k)
    pspec, pw, pb = _port_feed(pn, pg, pp, k)
    kw = dict(commit_mode=mode, gang_scheduling=True)
    ref = ref_build(rspec, framework=RefFramework.from_config(), k=k, **kw)(
        rw, rb, None, np.int32(n_cycles))
    port = port_build(pspec, k=k, device="cpu", **kw)(pw, pb, None, n_cycles)
    return ref, port


def _assert_equal(ref, port):
    for f in ("assignment", "unschedulable", "gang_dropped", "attempted", "node_requested",
              "carry_node_requested", "carry_gplaced"):
        np.testing.assert_array_equal(getattr(port, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert port.cycles_run == int(ref.cycles_run)


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("mode", ["rounds", "scan"])
def test_batch_program_matches_the_reference(seed, mode):
    ref, port = _both(seed, 4, 4, 4, mode)
    _assert_equal(ref, port)
    assert port.cycles_run == 4 and (port.assignment.numpy() >= 0).any()


def test_batch_program_k1_degenerate():
    ref, port = _both(1, 1, 1, 1)
    _assert_equal(ref, port)
    assert port.cycles_run == 1


def test_batch_program_exits_early_on_drain():
    """Two live rows of K = 4: the loop runs two cycles and the unran rows
    keep the init fill."""
    ref, port = _both(2, 2, 4, 4)
    _assert_equal(ref, port)
    assert port.cycles_run == 2 and (port.assignment[2:] == -1).all()
    assert not port.attempted[2:].any()


def test_batch_program_gang_spans_inner_cycles():
    ref, port = _both(4, 3, 4, 3, gang=True)
    _assert_equal(ref, port)
    # the straggler in cycle 1 completes the gang only through the carry
    assert int(port.assignment[1, 0]) >= 0 and not bool(port.gang_dropped[1, 0])


def test_continuation_equals_the_combined_batch():
    """Rows 0..1 as one batch, rows 2..3 chained on its device carry
    (`carry_in=True`): the continuation's rows equal the combined batch's."""
    nodes, groups, pgs = _objects(*PORT, 7, 4, gang=True)
    spec, w, b = _port_feed(nodes, groups, pgs, 4)
    full = port_build(spec, k=4, device="cpu")(w, b, None, 4)
    wa, ba = torch.zeros_like(w), torch.zeros_like(b)
    wa[:2], ba[:2] = w[:2], b[:2]
    wb, bb = torch.zeros_like(w), torch.zeros_like(b)
    wb[:2], bb[:2] = w[2:], b[2:]
    a = port_build(spec, k=4, device="cpu")(wa, ba, None, 2)
    c = port_build(spec, k=4, carry_in=True, device="cpu")(
        wb, bb, None, 2, a.carry_node_requested, a.carry_gplaced)
    for f in ("assignment", "unschedulable", "gang_dropped", "node_requested"):
        assert torch.equal(getattr(c, f)[:2], getattr(full, f)[2:]), f
    assert torch.equal(c.carry_node_requested, full.carry_node_requested)
    assert torch.equal(a.carry_gplaced + c.carry_gplaced, full.carry_gplaced)


ENVELOPE = {
    "host_ports": lambda m, api: (m.MakePod("p").req({"cpu": "1"}).host_port(80).obj(), {}),
    "inter_pod_affinity": lambda m, api: (
        m.MakePod("p").req({"cpu": "1"}).pod_affinity("zone", {"app": "x"}).obj(), {}),
    "topology_spread": lambda m, api: (
        m.MakePod("p").req({"cpu": "1"}).spread(1, "zone", {"app": "x"}).obj(), {}),
    "volumes": lambda m, api: (m.MakePod("p").req({"cpu": "1"}).volume("data").obj(), dict(
        pvcs=[api.PersistentVolumeClaim("data", storage_class="local", request=1.0)],
        storage_classes=[api.StorageClass("local", api.VOLUME_BINDING_WAIT,
                                          provisioner=False)])),
    "none": lambda m, api: (m.MakePod("p").req({"cpu": "1"}).obj(), {}),
}


@pytest.mark.parametrize("why", sorted(ENVELOPE))
def test_envelope_reasons_match_the_reference(why):
    out = []
    for (m, api), enc in ((REF, RefEncoder()), (PORT, PortEncoder(device="cpu"))):
        enc.pad_pods = enc.pad_nodes = 8
        pod, kw = ENVELOPE[why](m, api)
        nodes = [m.MakeNode("n0").capacity({"cpu": "4"}).labels({"zone": "z"}).obj()]
        if m is ref_models:
            out.append(ref_reason(enc.encode(nodes, [pod], **kw)))
        else:
            fields, aux = enc.encode_numpy(nodes, [pod], **kw)
            out.append(port_reason((fields, aux)))
            out.append(port_reason(enc.encode(nodes, [pod], **kw)))
    assert out == [None if why == "none" else why] * 3


def test_envelope_reason_extender():
    snap = PortEncoder(device="cpu").encode([port_models.MakeNode("n").obj()],
                                            [port_models.MakePod("p").obj()])
    import dataclasses

    assert port_reason(dataclasses.replace(snap, has_extender=True)) == "extender"


# ---- the Scheduler ----------------------------------------------------------


def _drive(pkg, k, seed, state_dir, spec=False, gang=False, n_cycles=6):
    """One randomized arrival trace through a Scheduler with multiCycleK=k,
    journaling into state_dir, on a frozen clock (the reference's
    `tests/test_multicycle.py` trace, with config #2's selector mix and an
    optional gang split across two arrival groups)."""
    m, api = REF if pkg == "ref" else PORT
    config = ref_config if pkg == "ref" else port_config
    state_mod = ref_state if pkg == "ref" else port_state
    clock = FakeClock()
    binds: list = []
    cfg = config.SchedulerConfiguration(multi_cycle_k=k, multi_cycle_max_wait_ms=1e9,
                                        speculative_dispatch=spec)
    state = state_mod.DurableState(state_dir, snapshot_interval_seconds=0)
    kw = {} if pkg == "ref" else {"device": "cpu"}
    core = ref_core if pkg == "ref" else port_core
    sched = core.Scheduler(config=cfg, binder=lambda pod, node: binds.append((pod.uid, node)),
                           now=clock, pad_bucket=8, state=state, **kw)
    for i in range(6):
        sched.on_node_add(m.MakeNode(f"n{i}").capacity({"cpu": "4", "memory": "8Gi"})
                          .labels({"tier": ("a", "b")[i % 2]}).obj())
    if gang:
        sched.add_pod_group(api.PodGroup("gang", 2))
    rng = random.Random(seed)
    uid = 0
    for c in range(n_cycles):
        for _ in range(rng.randint(1, 5)):
            pb = m.MakePod(f"p{uid}").req({"cpu": rng.choice(["1", "2", "3"]),
                                            "memory": "1Gi"})
            if rng.random() < 0.3:
                pb = pb.node_selector({"tier": "b"})
            sched.on_pod_add(pb.obj())
            uid += 1
        if gang and c in (1, 2):
            for i in range(2 if c == 1 else 1):
                sched.on_pod_add(m.MakePod(f"g{c}{i}").req({"cpu": "1"}).group("gang").obj())
        sched.schedule_cycle()
    for _ in range(2):
        sched.schedule_cycle()
    recs = [(r.counts.get("pods"), r.counts.get("scheduled"), r.counts.get("unschedulable"),
             r.counts.get("gang_dropped")) for r in sched.flight.snapshot()]
    digest = state_mod.state_digest(sched.queue, sched.cache)
    ledger = sched.speculation_ledger()
    state.journal.flush()
    state.journal.close()
    return binds, recs, digest, ledger


def _journal_streams(state_dir):
    """The decision and arrival streams of a journal, without the cycle
    boundary markers whose position is the batching itself (the
    reference's `tests/test_multicycle.py` split)."""
    markers = {"q.pop", "q.move", "q.flush_backoff", "q.flush_timeout", "q.retire"}
    arrivals = {"q.add", "q.update", "q.delete", "c.add_node", "c.update_node",
                "c.remove_node", "c.add_pod", "c.remove_pod"}
    dec, arr = [], []
    for op, t, data in replay_dir(str(state_dir)):
        if op not in markers:
            (arr if op in arrivals else dec).append((op, t, data))
    return dec, arr


@pytest.mark.parametrize("seed", [0, 5, 9])
@pytest.mark.parametrize("spec", [False, True], ids=["spec_off", "spec_on"])
def test_scheduler_k4_matches_k1(tmp_path, seed, spec):
    gang = seed == 9
    p1 = _drive("port", 1, seed, str(tmp_path / "p1"), gang=gang)
    p4 = _drive("port", 4, seed, str(tmp_path / "p4"), spec=spec, gang=gang)
    assert p4[0] == p1[0] and p4[0]
    assert p4[1] == p1[1] and p4[2] == p1[2]
    if spec:
        assert p4[3]["adopted"] + p4[3]["abandoned"] > 0
    d1, a1 = _journal_streams(tmp_path / "p1")
    d4, a4 = _journal_streams(tmp_path / "p4")
    assert d4 == d1 and a4 == a1


@pytest.mark.parametrize("spec", [False, True], ids=["spec_off", "spec_on"])
def test_scheduler_k4_matches_the_reference_k4(tmp_path, spec):
    p4 = _drive("port", 4, 9, str(tmp_path / "p4"), spec=spec, gang=True)
    r4 = _drive("ref", 4, 9, str(tmp_path / "r4"), spec=spec, gang=True)
    assert p4 == r4 and any(u.startswith("default/g") for u, _n in p4[0])
    assert _journal_streams(tmp_path / "p4") == _journal_streams(tmp_path / "r4")


def _served(k, pods, mc_wait_ms=1e9):
    clock = FakeClock()
    binds: list = []
    s = port_core.Scheduler(port_config.SchedulerConfiguration(
        multi_cycle_k=k, multi_cycle_max_wait_ms=mc_wait_ms), now=clock, pad_bucket=8,
        binder=lambda pod, node: binds.append((pod.uid, node)), device="cpu")
    for i in range(4):
        s.on_node_add(port_models.MakeNode(f"n{i}").capacity({"cpu": "8"})
                      .labels({"zone": f"z{i % 2}"}).obj())
    for group in pods:
        for p in group:
            s.on_pod_add(p)
        s.schedule_cycle()
    s.schedule_cycle()
    return s, binds


def test_envelope_fallback_pins_affinity_and_not_host_ports():
    mp = port_models.MakePod
    affine = [[mp(f"a{i}").req({"cpu": "1"}).obj()] for i in range(2)] + [
        [mp("x").req({"cpu": "1"}).pod_affinity("zone", {"app": "y"}).obj()]]
    s4, b4 = _served(4, affine)
    _s1, b1 = _served(1, affine)
    assert b4 == b1 and s4._mc_off == {"default-scheduler": "inter_pod_affinity"}
    ports = [[mp(f"h{i}").req({"cpu": "1"}).host_port(80 + i).obj()] for i in range(2)]
    s4, b4 = _served(4, ports)
    _s1, b1 = _served(1, ports)
    assert b4 == b1 and s4._mc_off == {}


def test_admission_depth_counts_the_coalescing_buffers():
    from k8s_scheduler_tpu_torch.service.admission import AdmissionController

    s, binds = port_core.Scheduler(port_config.SchedulerConfiguration(
        multi_cycle_k=4, multi_cycle_max_wait_ms=1e9), now=FakeClock(), pad_bucket=8,
        device="cpu"), []
    s.on_node_add(port_models.MakeNode("n0").capacity({"cpu": "8"}).obj())
    adm = AdmissionController(s)
    assert adm.submit([port_models.MakePod("p0").req({"cpu": "1"}).obj()]).accepted == 1
    s.schedule_cycle()  # popped into the coalescing buffer, not dispatched
    assert len(s.queue) == 0 and adm.queue_depth() == 1
    s.schedule_cycle()  # an empty pop flushes the buffer
    assert adm.queue_depth() == 0 and s.cache.existing_pods()


def test_speculative_redispatch_keeps_the_sampling_rotation():
    """120 nodes (the sampling window rotates by the frame's cycle_index)
    and groups whose node selectors grow the interning tables, so a
    speculative continuation is skipped and its groups dispatched again:
    they must re-stamp the cycle indices of their first encode, as K = 1
    and the non-speculative batch do. (The reference re-encodes them past
    it and diverges from its own K = 1 here; found on the card by
    chip_smoke.py phase 14.)"""
    def drive(k, spec):
        binds: list = []
        s = port_core.Scheduler(port_config.SchedulerConfiguration(
            multi_cycle_k=k, multi_cycle_max_wait_ms=1e9, speculative_dispatch=spec),
            binder=lambda p, n: binds.append((p.uid, n)), now=FakeClock(), pad_bucket=8,
            device="cpu")
        for i in range(120):
            s.on_node_add(port_models.MakeNode(f"n{i}").capacity({"cpu": "4", "memory": "8Gi"})
                          .labels({"tier": f"t{i % 5}"}).obj())
        rng, uid = random.Random(3), 0
        for c in range(8):
            for _ in range(6):
                pb = port_models.MakePod(f"p{uid}").req({"cpu": rng.choice(["1", "2"])})
                if c in (1, 2, 5, 6) and rng.random() < 0.5:
                    pb = pb.node_selector({"tier": f"t{c % 5}"})
                s.on_pod_add(pb.obj())
                uid += 1
            s.schedule_cycle()
        for _ in range(2):
            s.schedule_cycle()
        return binds, s.speculation_ledger()

    b1, _ = drive(1, False)
    b4, _ = drive(4, False)
    b4s, led = drive(4, True)
    assert b1 and b4 == b1 and b4s == b1 and led["adopted"] > 0


def test_streamed_rows_equal_the_stacked_fetch():
    """`dispatch_multi`'s per-row fetch (`decisions_row`) against the
    stacked fetch (`decisions`) and `build_multicycle_slim_fn` over the same
    batch result; the handle counts as fetched once every live row was."""
    from k8s_scheduler_tpu_torch.core.pipeline import ServingPipeline, build_multicycle_slim_fn

    nodes, groups, pgs = _objects(*PORT, 5, 3, gang=True)
    spec, w, b = _port_feed(nodes, groups, pgs, 4)
    pipe = ServingPipeline(lambda *a: None, device="cpu")
    pipe.multi_fn = port_build(spec, k=4, device="cpu")
    h = pipe.dispatch_multi(w, b, None, 3, device_put=False)
    rows = [h.decisions_row(i) for i in range(2)]
    assert not h.fetched
    rows.append(h.decisions_row(2))
    assert h.fetched and h.cycles_run() == 3
    a, u, gd, att, cr = h.decisions()
    r = h.result
    sa, sf, scr = build_multicycle_slim_fn(r.node_requested.shape[1])(
        r.assignment, r.unschedulable, r.gang_dropped, r.attempted, r.cycles_run)
    assert cr == scr == 3
    for i, (ra, ru, rg, rt) in enumerate(rows):
        assert (ra == a[i]).all() and (ru == u[i]).all() and (rg == gd[i]).all()
        assert (rt == att[i]).all() and (ra == sa[i].numpy()).all()
        assert ((sf[i].numpy() & 4) != 0).tolist() == rt.tolist()
        assert (ra == r.assignment[i].numpy()).all()
