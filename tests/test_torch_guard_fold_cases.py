"""K6 `guard_sweep` and K12 `pv_fold`: their seeded edge cases
(`utils/kernel_cases.guard_cases` and `fold_cases`, which chip_smoke.py and
`kernel_variants` hold the kernels to on the card) through the plain
versions against the reference, and the premises of the kernels' designs.

- K6: each case of `guard_raw_cases` (a pod run and a group across a tile
  boundary, a group longer than several tiles, no padding, all padding, a
  pod in every slot, spread caps at 1, L not a multiple of the tile, no
  caps, keys above the padding key, config #4's shape): `guard_sweep_plain`
  equal to the reference's `_seg_scan_tables` sweep under jax.jit, and to a
  sequential per-entry count where the groups are short; each case sets up
  the situation it is named for.
- K6's premise: on every participant table the rounds engine gives the
  sweep (the affinity and the volume workloads, every round), equal
  `s_packed` values belong to one pod, since the ranks are the snapshot's
  pod order, a permutation.
- K12: each case of `fold_objects` and each of its three draws:
  `pv_fold_plain` equal to the reference's `fold_pv_claims` under jax.jit;
  each case sets up its situation (no claimant, more claimants in one CTA
  than its threads, several passes, an SDR choice that differs from the
  greedy one, one PV's claimants and winner entry in three CTAs, V = 97);
  `launch_shape` splits the rows and the PVs over the cluster."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k8s_scheduler_tpu.models as ref_models
import k8s_scheduler_tpu.models.api as ref_api
import k8s_scheduler_tpu.ops.volumes as ref_vol
from k8s_scheduler_tpu.framework.interfaces import CycleContext as RefContext
from k8s_scheduler_tpu_torch.core.cycle import build_cycle_fn
from k8s_scheduler_tpu_torch.models import SnapshotEncoder
from k8s_scheduler_tpu_torch.ops import guard_sweep, pv_fold, volumes
from k8s_scheduler_tpu_torch.utils import kernel_cases, synth
from test_torch_kernels_plain import _reference_guard, _sequential_guard
from torch_one_thread import one_torch_thread  # noqa: F401

# ---- K6 --------------------------------------------------------------------

_GUARD = kernel_cases.guard_cases("cpu")


def _groups(args):
    """(start, length) of every group of a sorted table, padding included."""
    s_packed, _, rank_bits, *_ = args
    keys = (s_packed >> rank_bits).numpy()
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    return starts, np.diff(np.r_[starts, keys.shape[0]])


def test_guard_tags_name_every_case():
    assert tuple(_GUARD) == kernel_cases.GUARD_TAGS


@pytest.mark.parametrize("tag", kernel_cases.GUARD_TAGS)
def test_guard_edge_case_plain_matches_reference(tag):
    args = _GUARD[tag]
    s_packed, perm, rank_bits, B, role_tab, caps, gk_invalid = args
    got = guard_sweep.guard_sweep_plain(*args).numpy()
    caps_np = (np.full(perm.shape[0], guard_sweep.NO_CAP, np.int32) if caps is None
               else caps.numpy())
    # the reference always tests spread: without caps, every cap is NO_CAP
    want = jax.jit(_reference_guard, static_argnums=(2, 5))(
        (s_packed >> rank_bits).numpy(), perm.numpy(), B, role_tab.numpy(), caps_np,
        gk_invalid)
    np.testing.assert_array_equal(got, np.asarray(want))
    _, lengths = _groups(args)
    if perm.shape[0] <= 2500 and lengths.max(initial=0) <= 600:
        seq_caps = torch.from_numpy(caps_np)
        np.testing.assert_array_equal(got, _sequential_guard(
            s_packed, perm, rank_bits, B, role_tab, seq_caps, gk_invalid))


@pytest.mark.parametrize("tag", kernel_cases.GUARD_TAGS)
def test_guard_edge_case_exercises_its_situation(tag):
    args = _GUARD[tag]
    s_packed, perm, rank_bits, B, role_tab, caps, gk_invalid = args
    T = guard_sweep.TILE
    L = perm.shape[0]
    keys = (s_packed >> rank_bits).numpy()
    valid = keys != gk_invalid
    starts, lengths = _groups(args)
    ok = guard_sweep.guard_sweep_plain(*args).numpy()
    assert L == role_tab.shape[0] * B and T == kernel_cases.GUARD_TILE
    if tag == "a pod run across a tile boundary":
        sp = s_packed.numpy()
        at = kernel_cases.GUARD_BOUNDARY
        assert at % T == 0 and sp[at - 1] == sp[at] and keys[0] == keys[at]  # in group 0
        pod = int(perm[at]) % B
        assert ok[pod]  # passes only if its own MATCH before the boundary is not counted
        assert at + 4 < lengths[0]
    elif tag == "a group longer than several tiles":
        i = int(np.argmax(lengths))
        assert lengths[i] > 3 * T and starts[i] % T != 0 and keys[starts[i]] != gk_invalid
        assert 0 < ok.sum() < B
    elif tag == "no padding":
        assert valid.all() and 0 < ok.sum() < B
    elif tag == "all padding":
        assert not valid.any() and ok.all()
    elif tag == "a pod with entries in every slot":
        sp = s_packed.numpy()
        runs = np.diff(np.r_[np.flatnonzero(np.r_[True, sp[1:] != sp[:-1]]), L])
        assert runs.max() == role_tab.shape[0]
    elif tag == "spread caps at 1":
        spread = role_tab.numpy()[perm.numpy() // B] == guard_sweep.RB_SPREAD
        assert (caps.numpy()[perm.numpy()][spread] == 1).all() and 0 < ok.sum() < B
    elif tag == "L not a multiple of the tile":
        assert L % T != 0 and L > T
    elif tag == "no spread caps":
        assert caps is None and (role_tab == guard_sweep.RB_SPREAD).any()
    elif tag == "keys after the padding key":
        assert (keys > gk_invalid).any() and (keys == gk_invalid).any()
        assert keys[-1] > gk_invalid
    elif tag == "config #4's shape":
        assert role_tab.shape[0] == 22 and valid.mean() < 0.1 and L > 40 * 1024
        assert lengths[keys[starts] != gk_invalid].max() < 32


def _rounds_guard_calls(workload):
    """The K6 calls of one rounds cycle of config #4's workload at test size
    (with `config4_volumes` for "volumes"), through a recording plain
    sweep; and the snapshot."""
    nodes, existing, pending = synth.config4_workload((7,), 60, 150, 200, num_apps=12)
    kw = {}
    if workload == "volumes":
        existing, pods, pvcs, pvs, classes = synth.config4_volumes(nodes, existing,
                                                                   pending[7], seed=7)
        kw = dict(pvcs=pvcs, pvs=pvs, storage_classes=classes)
    else:
        pods = pending[7]
    snap = SnapshotEncoder(device="cpu").encode(nodes, pods, existing, **kw)
    calls = []

    def rec(*args):
        calls.append(args)
        return guard_sweep.guard_sweep_plain(*args)

    build_cycle_fn(commit_mode="rounds", outputs="latency", device="cpu", guard_sweep_fn=rec)(snap)
    return snap, calls


@pytest.mark.parametrize("workload", ["affinity", "volumes"])
def test_rounds_guard_tables_keep_one_pod_per_packed_key(workload):
    """K6 finds a pod run's head by `s_packed` equality: on every table the
    rounds engine sorts for it, equal packed keys are one pod's entries,
    because the ranks it packs are the snapshot's pod order (a permutation
    of the valid pods; only valid pods are accepted, so only they emit
    entries) taken at distinct pod rows."""
    snap, calls = _rounds_guard_calls(workload)
    order = snap.pod_order[snap.pod_valid]
    assert sorted(order.tolist()) == list(range(int(snap.pod_valid.sum())))
    assert len(calls) >= 2
    n_tables = 0
    for s_packed, perm, rank_bits, B, role_tab, caps, gk_invalid in calls:
        keys = s_packed >> rank_bits
        valid = keys != gk_invalid
        n_tables += bool(valid.any())
        sp, pod = s_packed[valid], (perm % B)[valid]
        rank = sp & ((1 << rank_bits) - 1)
        # a rank names one pod, and a pod one rank
        pairs = torch.unique(torch.stack([rank, pod], 1), dim=0)
        assert torch.unique(pairs[:, 0]).numel() == pairs.shape[0]
        assert torch.unique(pairs[:, 1]).numel() == pairs.shape[0]
        same = sp[1:] == sp[:-1]
        assert torch.equal(pod[1:][same], pod[:-1][same])
    assert n_tables >= 2


# ---- K12 -------------------------------------------------------------------

_FOLD = kernel_cases.fold_cases("cpu")


def _fold_reference(tag):
    nodes, pods, kw = kernel_cases.fold_objects(ref_models, ref_api)[tag]
    ref = ref_models.SnapshotEncoder().encode(nodes, pods, **kw)
    if tag in kernel_cases.FOLD_PVS:
        ref = kernel_cases.narrow_pvs(ref, kernel_cases.FOLD_PVS[tag])
    return ref, RefContext(ref).expr_node_mask


def test_fold_tags_name_every_case():
    assert tuple(kernel_cases.fold_objects(ref_models, ref_api)) == kernel_cases.FOLD_TAGS
    assert list(_FOLD) == [f"{t}, draw {d}" for t in kernel_cases.FOLD_TAGS
                           for d in range(3)]


@pytest.mark.parametrize("tag", kernel_cases.FOLD_TAGS)
def test_fold_edge_case_plain_matches_reference(tag):
    ref, em = _fold_reference(tag)
    fold = jax.jit(lambda c, a, n, r: ref_vol.fold_pv_claims(ref, em, c, a, n, r))
    for d in range(3):
        snap, tables, claimed, accepted, node_of, rank = _FOLD[f"{tag}, draw {d}"]
        assert snap.pv_avail.shape == ref.pv_avail.shape
        np.testing.assert_array_equal(rank.numpy(), np.asarray(ref.pod_order))
        got = volumes.pv_fold_plain(snap, tables, claimed, accepted, node_of, rank)
        want = fold(*(jnp.asarray(x.numpy()) for x in (claimed, accepted, node_of, rank)))
        assert got.numpy().dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"draw {d}")


@pytest.mark.parametrize("tag", kernel_cases.FOLD_TAGS)
def test_fold_edge_case_exercises_its_situation(tag):
    for d in range(3):
        snap, tables, claimed, accepted, node_of, rank = _FOLD[f"{tag}, draw {d}"]
        B, V = snap.P, snap.pv_avail.shape[0]
        rows = accepted & (snap.pod_vol_mode == 1).any(dim=1)
        _, passes = volumes.fold_pv_claims_passes(snap, tables.req, claimed, accepted,
                                                  node_of, rank)
        ctas = [kernel_cases.fold_cta(int(r)) for r in torch.nonzero(rows).flatten()]
        if tag == "no claimant":
            assert int(rows.sum()) == 0 and passes == 1
        elif tag == "more claimants than a CTA's threads":
            assert max(ctas.count(c) for c in set(ctas)) > pv_fold.THREADS
            for cl in (pv_fold.CLUSTER, pv_fold.CLUSTER_PORTABLE):
                per = [kernel_cases.fold_cta(int(r), cl) for r in torch.nonzero(rows).flatten()]
                assert max(per.count(c) for c in set(per)) > pv_fold.THREADS
            assert passes > 3
        elif tag == "a contended batch":
            assert passes >= 3 and int(rows.sum()) == 12
        elif tag == "SDR pods whose greedy choice dead-ends":
            assert volumes._multi(snap)
            pending = accepted[:, None] & (snap.pod_vol_mode == 1)
            greedy = volumes.chosen_pv(snap, tables.req, claimed, node_of, pending[:, 0], 0)
            sdr = volumes.chosen_pv_sdr(snap, tables.req, claimed, node_of, pending, 0)
            assert bool(((greedy != sdr) & (sdr >= 0)).any())
        elif tag == "one PV, claimants in two CTAs":
            assert torch.nonzero(rows).flatten().tolist() == [0, 39]
            for cl in (pv_fold.CLUSTER, pv_fold.CLUSTER_PORTABLE):
                shape = pv_fold.launch_shape(B, V, cl)
                owners = {kernel_cases.fold_cta(0, cl), kernel_cases.fold_cta(39, cl),
                          45 // shape["vs"]}
                assert len(owners) == 3
            assert int(rank[39]) < int(rank[0]) and passes == 2
        elif tag == "V = 97":
            assert V == 97 and passes > 1


@pytest.mark.parametrize("B,V,cluster,rows,vs", [
    (16384, 11000, 16, 1024, 688), (16384, 11000, 8, 2048, 1375), (2048, 11000, 16, 128, 688),
    (0, 0, 16, 0, 0), (64, 52, 8, 32, 7), (40, 97, 16, 32, 7)])
def test_pv_fold_launch_shape(B, V, cluster, rows, vs):
    shape = pv_fold.launch_shape(B, V, cluster)
    assert (shape["rows"], shape["vs"]) == (rows, vs)
    assert shape["smem"] == 8 * vs + 20 * rows <= pv_fold.SMEM_LIMIT


def test_pv_fold_refuses_more_than_a_cta_holds():
    with pytest.raises(ValueError, match="shared memory"):
        pv_fold.launch_shape(16 * 12000, 11000, 16)
    pv_fold.launch_shape(16 * 10000, 11000, 16)  # 200 KB + 5.5 KB
