"""The port's scan engine on snapshots with volumes, against the reference's.

`build_cycle_fn(commit_mode="scan", device="cpu")` runs VolumeBinding's
per-pod hooks (`VolumeBinding.dyn_mask` / `extra_update` over the row
twins of `ops/volumes.py`) and must decide bit-equal to the reference's
scan on every fixture of test_torch_volumes: assignment, node_requested,
unschedulable and gang_dropped of the latency outputs, and on five
fixtures (the gangs, same-cycle contention, the 8-slot dominance groups,
config #4's volume draw) the full outputs too, reject counts and the
claim bitmap after the gang unwind included. The reference side is one
jitted full-outputs scan for every fixture (its decisions are its latency
program's, which its own tests hold), so fixtures of one shape compile
once.

Beside the cycle: the three row twins against the reference's row
functions on seeded claim bitmaps, nodes and pending slots; a Python
transcription of K13's volume test (csrc/scan_commit.cu `vol_ok`) over
the packed pod rows and PV lists against the row twin on every node; a
step's claims (`VolumeBinding.extra_update`) against K11's function on
the pod's row (the kernel makes them with the same `pv::choose_by`);
`scan_commit_plain` on K13's volume edge cases
(`kernel_cases.scan_volume_objects`) against the reference's
greedy_commit with its hooks; and K13's launch shape and row layout with
the claim bitmap, without a card."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k8s_scheduler_tpu.core.cycle as ref_cycle
import k8s_scheduler_tpu.framework.interfaces as ref_if
import k8s_scheduler_tpu.framework.runtime as ref_rt
import k8s_scheduler_tpu.models as ref_models
import k8s_scheduler_tpu.ops.commit as ref_commit
import k8s_scheduler_tpu.ops.volumes as ref_vol
from k8s_scheduler_tpu_torch.core.cycle import build_cycle_fn
from k8s_scheduler_tpu_torch.framework.interfaces import CycleContext
from k8s_scheduler_tpu_torch.framework.runtime import Framework
from k8s_scheduler_tpu_torch.ops import scan_commit as sc
from k8s_scheduler_tpu_torch.ops import volumes as port_vol
from k8s_scheduler_tpu_torch.utils import kernel_cases
from test_torch_volumes import FIXTURES, Case, carry, reference_snapshot

DECISIONS = ("assignment", "node_requested", "unschedulable", "gang_dropped")
FULL = ("gang_unwind", "gang_survivor", "two_pvs_4", "eight_slot_dominance", "cfg4_volumes")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's plain scans, whose steps are many
    small ops: with several test workers sharing the cores, idle pool
    threads made a cfg4 scan 30x slower. Restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(got, want, what):
    g, w = _bits(got.numpy()), _bits(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype, w.dtype, g.shape, w.shape)
    np.testing.assert_array_equal(g, w, err_msg=what)


@functools.cache
def _ref_scan():
    return ref_cycle.build_cycle_fn(commit_mode="scan")


@functools.lru_cache(maxsize=None)
def _run(name):
    """(reference full result, port latency decision, port full result,
    port snapshot) of a fixture."""
    ref_snap = reference_snapshot(name)
    want = _ref_scan()(ref_snap)
    snap = carry(ref_snap)
    lat = build_cycle_fn(commit_mode="scan", outputs="latency", device="cpu")(snap)
    full = (build_cycle_fn(commit_mode="scan", device="cpu")(snap) if name in FULL
            else None)
    return want, lat, full, snap


@pytest.mark.parametrize("name", list(FIXTURES))
def test_scan_volume_cycle_bit_equal_to_reference(name):
    want, got, _, snap = _run(name)
    for f in DECISIONS:
        _eq(getattr(got, f), getattr(want, f), f)
    a = got.assignment.numpy()
    if name in ("single_pv_3", "gang_unwind", "claimed_pv"):
        assert (a >= 0).sum() == (1 if name == "single_pv_3" else 0)
    if name == "three_pvs_3":
        assert (a[: 3] >= 0).all()
    if name == "cfg4_volumes":
        placed = snap.pod_valid & (got.assignment >= 0)
        assert int(placed.sum()) > 300
        assert bool((placed[:, None] & (snap.pod_vol_mode == 1)).any())


@pytest.mark.parametrize("name", FULL)
def test_scan_volume_full_outputs_bit_equal_to_reference(name):
    want, lat, got, _ = _run(name)
    for f in DECISIONS + ("reject_counts", "pv_claimed", "rounds_used"):
        _eq(getattr(got, f), getattr(want, f), f)
    for f in DECISIONS:
        assert torch.equal(getattr(got, f), getattr(lat, f)), f
    if name == "gang_unwind":  # the member's claim went with the unwind
        assert got.gang_dropped.any() and not got.pv_claimed.any()
    if name == "gang_survivor":
        assert got.gang_dropped.any() and int(got.pv_claimed.sum()) == 1
    if name == "cfg4_volumes":
        col = Framework.from_config().filter_names.index("VolumeBinding")
        assert int(got.reject_counts[:, col].sum()) > 0


# ---- the row twins ---------------------------------------------------------------

ROW_FIXTURES = ("cfg4_volumes", "eight_slot_dominance", "three_slot_chain", "contending",
                "dynamic_topologies", "static_and_dynamic", "two_pvcs_one_pv_provisioner")


def _claimants(c, k=6):
    """Up to k valid pods with an unbound slot (the first ones by index)."""
    mode = c.port.pod_vol_mode.numpy()
    rows = np.flatnonzero(np.asarray(c.ref.pod_valid) & (mode == 1).any(1))
    return rows[:k].tolist()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ROW_FIXTURES)
def test_row_twins_match_reference(name, seed):
    c = Case(name, seed)
    rng = np.random.default_rng(100 + seed)
    claimed = c.claimed if seed else np.zeros_like(c.claimed)
    jc, tc = jnp.asarray(claimed), torch.from_numpy(claimed)
    tables = CycleContext(c.port).volume_tables
    MVol = c.port.pod_vol_mode.shape[1]
    for p in _claimants(c):
        tp = torch.tensor(p, dtype=torch.int32)
        _eq(port_vol.volume_mask_unbound_row(c.port, tables, tc, tp),
            ref_vol.volume_mask_unbound_row(c.ref, c.em, jc, p), f"mask row {p}")
        node = int(c.node_of[p])
        tn = torch.tensor(node, dtype=torch.int32)
        pending = (c.port.pod_vol_mode[p] == 1).numpy() & (rng.random(MVol) < 0.8)
        for j in range(MVol):
            _eq(port_vol.chosen_pv_row(c.port, tables, tc, tn, tp, j),
                ref_vol.chosen_pv_row(c.ref, c.em, jc, node, p, j), f"chosen_pv_row {p} {j}")
            _eq(port_vol.chosen_pv_sdr_row(c.port, tables, tc, tn, tp, torch.from_numpy(pending),
                                           j),
                ref_vol.chosen_pv_sdr_row(c.ref, c.em, jc, node, p, jnp.asarray(pending), j),
                f"chosen_pv_sdr_row {p} {j}")


# ---- K13's volume path, transcribed ------------------------------------------------


def _vol_ok_model(x, row, lay, n, claimed, subs):
    """csrc/scan_commit.cu `vol_ok` in Python over a packed pod row (ints),
    the PV lists and the claim bitmap (bool [V]) at node n."""
    t = x.vol_tables
    V, MVol, n_sub = x.vol
    mode = row[lay["vmode"]:lay["vmode"] + MVol]
    rid = row[lay["vrid"]:lay["vrid"] + MVol]
    cls = row[lay["vcls"]:lay["vcls"] + MVol]
    size = np.array(row[lay["vsize"]:lay["vsize"] + MVol], np.int32).view(np.float32)
    member = row[lay["vmem"]:lay["vmem"] + MVol]
    req = t.req.numpy()
    needy = 0
    for s in range(MVol):
        dyn = rid[s] != -2 and (rid[s] < 0 or bool(req[min(rid[s], req.shape[0] - 1), n]))
        if mode[s] == 1 and not dyn:
            needy |= 1 << s
    if not needy:
        return True
    hall = x.vol_multi and bin(needy).count("1") >= 2
    lst = sorted(t.node_pv[int(t.node_off[n]):int(t.node_off[n + 1])].tolist()
                 + t.global_pv.tolist())
    pv_cls, pv_cap = x.pv_class.numpy(), x.pv_cap.numpy()
    has, cnt = 0, [0] * n_sub
    for v in lst:
        if claimed[v]:
            continue
        cap = np.float32(pv_cap[v]) + np.float32(1e-3)
        b = sum(1 << s for s in range(MVol)
                if mode[s] == 1 and pv_cls[v] == cls[s] and cap >= size[s])
        has |= b
        for k in range(n_sub):
            cnt[k] += (b & subs[k]) != 0
    if needy & ~has:
        return False
    if not hall:
        return True
    if any(cnt[k] < bin(subs[k] & needy).count("1") for k in range(MVol, n_sub)):
        return False
    return not (MVol > 6 and any(cnt[g] < bin(member[g] & needy).count("1")
                                 for g in range(MVol)))


@pytest.mark.parametrize("name", ROW_FIXTURES)
def test_kernel_volume_test_transcribed_matches_row_twin(name):
    """The kernel's per-node volume test over its packed operands equals
    the row twin on every node, for every claimant, on seeded bitmaps."""
    c = Case(name, 1)
    fw = Framework.from_config()
    ctx = CycleContext(c.port)
    x = sc.scan_commit_inputs(fw, ctx, torch.zeros((c.port.P, c.port.N)), fw.extra_init(ctx))
    assert x.flags & sc.F_VOLUMES
    V, MVol, n_sub = x.vol
    lay = sc.row_layout(x.pod_requested.shape[1], x.pod_port_ids.shape[1],
                        x.aff_terms.shape[1], x.tsc.shape[1], x.node_domains.shape[1], MVol)
    rows = sc.pod_rows(x)
    assert rows.shape[1] == lay["W"]
    flags = sc.pod_flags(x)
    subs = [int(v) for v in sc.vm._subset_masks(MVol, x.vol_multi, "cpu")]
    assert len(subs) == n_sub
    n_real = int(c.port.num_nodes)
    for claimed in (np.zeros_like(c.claimed), c.claimed):
        for p in _claimants(c, 4):
            assert int(flags[p]) & sc.POD_VOL
            row = rows[p].tolist()
            want = port_vol.volume_mask_unbound_row(
                c.port, ctx.volume_tables, torch.from_numpy(claimed), torch.tensor(p))
            got = [_vol_ok_model(x, row, lay, n, claimed, subs) for n in range(n_real)]
            assert got == want[:n_real].tolist(), p
    # a pod without an unbound slot takes the skip
    plain = (c.port.pod_vol_mode != 1).all(1)
    assert not (flags[plain] & sc.POD_VOL).any()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ROW_FIXTURES)
def test_step_claims_are_the_pod_rows_pv_choice(name, seed):
    """A committed step's claims (`VolumeBinding.extra_update`: slot by slot
    against the updated bitmap) are K11's function on the pod's row at its
    node against the bitmap before the step, and a step that does not
    commit claims nothing."""
    c = Case(name, seed)
    fw = Framework.from_config()
    vb = next(f for f in fw.filters if f.name == "VolumeBinding")
    ctx = CycleContext(c.port)
    claimed = torch.from_numpy(c.claimed if seed else np.zeros_like(c.claimed))
    tn = torch.from_numpy(c.node_of)
    slots = port_vol.chosen_pv_slots(c.port, c.req, claimed, tn,
                                     torch.ones_like(c.port.pod_valid))
    for p in _claimants(c):
        tp = torch.tensor(p, dtype=torch.int32)
        after = vb.extra_update(ctx, claimed, tp, tn[p], torch.tensor(True))
        want = claimed.clone()
        ch = slots[p][slots[p] >= 0].long()
        want[ch] = True
        assert torch.equal(after, want), p
        assert torch.equal(vb.extra_update(ctx, claimed, tp, tn[p], torch.tensor(False)),
                           claimed)


# ---- K13's volume edge cases -------------------------------------------------------


@pytest.mark.parametrize("tag", kernel_cases.SCAN_VOLUME_TAGS)
def test_scan_volume_edge_cases_match_reference(tag):
    """`scan_commit_plain` (what K13 is held against on the card) on each
    volume edge case equals the reference's greedy_commit with its hooks:
    assignment, requested resources and the claim bitmap."""
    nodes, pods, existing, opts = kernel_cases.scan_volume_objects(ref_models, (tag,))[tag]
    ref = kernel_cases.prepare(kernel_cases.encode_case(
        ref_models.SnapshotEncoder(), nodes, pods, existing, opts), opts)
    x = kernel_cases.scan_inputs(carry(ref), opts)
    assert x.flags & sc.F_VOLUMES
    got = sc.scan_commit_plain(x)
    fw = ref_rt.Framework.from_config()

    def run(snap, order, sbase):
        ctx = ref_if.CycleContext(snap)
        ctx.matched_pending
        return ref_commit.greedy_commit(
            order=order, static_mask=sbase > sc.NEG_INF / 2, static_score=sbase,
            pod_requested=snap.pod_requested, pod_valid=snap.pod_valid,
            pod_nominated=snap.pod_nominated, node_allocatable=snap.node_allocatable,
            node_requested=snap.node_requested,
            dyn_fn=lambda p, nr, ext, row: fw.dyn(ctx, p, nr, ext, row),
            extra=fw.extra_init(ctx),
            update_fn=lambda ext, p, node, ok: fw.extra_update(ctx, ext, p, node, ok))

    want = jax.jit(run)(ref, jnp.asarray(x.order.numpy()), jnp.asarray(x.sbase.numpy()))
    _eq(got.assignment, want.assignment, "assignment")
    _eq(got.node_requested, want.node_requested, "node_requested")
    _eq(got.pv_claimed, want.extra["VolumeBinding"], "pv_claimed")
    a = got.assignment[: len(pods)].tolist()
    claimed = torch.nonzero(got.pv_claimed).flatten().tolist()
    V = x.pv_class.shape[0]
    if tag.startswith("V="):
        assert V == int(tag[2:]) and V - 1 in claimed and (V < 33 or 31 in claimed)
    if tag == "a node with an empty list":
        assert a[:4] == [0, 1, 2, -1] and a[4] == 35
    if tag == "only global PVs":
        assert len(claimed) == 6 and a.count(-1) == 2
        assert len({kernel_cases.scan_cta(n, x.shape[1]) for n in a if n >= 0}) == 3
    if tag == "two pods contending for one PV":
        assert a == [25, -1, 25] and claimed == [0]
    if tag == "an 8-slot pod under the dominance groups":
        assert x.vol[1] == 8 and a == [7, 29] and len(claimed) == 16
    if tag == "dynamic provisioning and rid == -2":
        assert a[0] >= 27 and a[1] == 3 and a[3] == -1 and claimed == [1]
    if tag == "a nominated node the volume mask rejects":
        assert x.pod_nominated[1] == 9 and a == [9, 2]
    if tag == "a gang that unwinds after claiming":
        assert a == [14, 27, -1, 5] and claimed == [0, 1, 2]


def test_gang_unwind_edge_case_refolds_the_claims():
    """The gang edge case through the full scan cycle: the unwound members'
    claims are released by the refold over the survivors, as the
    reference's."""
    tag = "a gang that unwinds after claiming"
    nodes, pods, existing, opts = kernel_cases.scan_volume_objects(ref_models, (tag,))[tag]
    ref = kernel_cases.encode_case(ref_models.SnapshotEncoder(), nodes, pods, existing, opts)
    want = ref_cycle.build_cycle_fn(commit_mode="scan")(ref)
    got = build_cycle_fn(commit_mode="scan", device="cpu")(carry(ref))
    for f in DECISIONS + ("pv_claimed", "reject_counts"):
        _eq(getattr(got, f), getattr(want, f), f)
    assert torch.nonzero(got.pv_claimed).flatten().tolist() == [2]


# ---- the launch without a card ----------------------------------------------------


def test_launch_shape_with_the_claim_bitmap():
    """Config #4's volume cell (N = 8192 padded, V = 11000, MVol = 2, Hall
    over one pair) fits the 16-CTA and the portable 8-CTA clusters with its
    1376-byte bitmap; a V whose bitmap does not fit raises, on both."""
    R, K, Q, S, MP, MA, MC = 4, 2, 1, 500, 1, 2, 2
    base = sc.row_layout(R, MP, MA, MC, K)
    lay = sc.row_layout(R, MP, MA, MC, K, 2)
    assert lay["W"] == base["W"] + 10
    assert [lay[f] for f in ("vmode", "vrid", "vcls", "vsize", "vmem")] == [
        base["W"] + 2 * i for i in range(5)]
    for cluster in (sc.CLUSTER, sc.CLUSTER_PORTABLE):
        plain = sc.launch_shape(8192, R, K, Q, S, base["W"], cluster)
        vol = sc.launch_shape(8192, R, K, Q, S, lay["W"], cluster, V=11000, n_sub=3)
        L = vol["layout"]
        assert L["vsub"] - L["cbits"] == 1376 and L["wcnt"] - L["vsub"] == 16
        assert plain["smem"] < vol["smem"] <= sc.SMEM_LIMIT
        for full in (False, True):
            with pytest.raises(ValueError, match="V=2000000"):
                sc.launch_shape(8192, R, K, Q, S, lay["W"], cluster, full, V=2_000_000, n_sub=3)
    # the largest V beside config #4's 16 slices, and one more word
    room = sc.SMEM_LIMIT - sc.launch_shape(8192, R, K, Q, S, lay["W"], V=0, n_sub=3)["smem"]
    V_max = room // 4 * 32
    sc.launch_shape(8192, R, K, Q, S, lay["W"], V=V_max, n_sub=3)
    with pytest.raises(ValueError):
        sc.launch_shape(8192, R, K, Q, S, lay["W"], V=V_max + 32 * 4, n_sub=3)
    with pytest.raises(ValueError, match="subsets"):
        sc.launch_shape(8192, R, K, Q, S, lay["W"], V=11000, n_sub=65)


def test_scan_inputs_carry_the_volume_operands():
    """The cfg4 fixture's packed scan inputs: the volume flag, V, MVol and
    the subset count, the bitmap from the plugins' state, POD_VOL on the
    pods with an unbound slot; off without VolumeBinding in the profile."""
    import k8s_scheduler_tpu_torch.config as port_config

    snap = carry(reference_snapshot("cfg4_volumes"))
    fw = Framework.from_config()
    ctx = CycleContext(snap)
    extra = fw.extra_init(ctx)
    x = sc.scan_commit_inputs(fw, ctx, torch.zeros((snap.P, snap.N)), extra)
    assert x.vol == (snap.pv_avail.shape[0], 2, 3) and x.pv_claimed is extra["VolumeBinding"]
    assert torch.equal(sc.pod_flags(x) & sc.POD_VOL > 0, (snap.pod_vol_mode == 1).any(1))
    sc._dims(x)
    no_vb = port_config.SchedulerConfiguration(profiles=[port_config.Profile(
        plugins=port_config.Plugins(filter=port_config.PluginSet(disabled=["VolumeBinding"])))])
    fw2 = Framework.from_config(no_vb)
    x2 = sc.scan_commit_inputs(fw2, ctx, torch.zeros((snap.P, snap.N)), fw2.extra_init(ctx))
    assert not x2.flags & sc.F_VOLUMES and x2.vol == (0, 0, 0)
    assert sc.pod_rows(x2).shape[1] == sc.pod_rows(x).shape[1] - 10
