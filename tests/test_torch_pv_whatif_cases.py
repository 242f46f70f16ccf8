"""K11 `pv_choice` and K8 `preempt_whatif`: their seeded edge cases
(`utils/kernel_cases.pv_choice_cases` and `whatif_cases`, which
chip_smoke.py holds the kernels on) through the plain versions against the
reference, on the CPU.

- K11: each case of `pv_choice_objects` and each of its three draws:
  `pv_choice_plain` equal to the reference's `chosen_pv_slots` under
  jax.jit, bit for bit; and each case exercises its situation (a node
  list over the kernel's register cap, global PVs between the node's, one
  and eight volume slots, every PV claimed, inactive rows with pending
  slots, node_of outside [0, N), slots that ride dynamic provisioning, a
  capacity at the + 1e-3 edge).
- K8: each case of `whatif_objects` through both packages' rounds cycle
  and preemption pass (the port's with its plain stages): the nominations,
  victims and preemptor count bit for bit. The reference's what-if table
  is internal to its preemption pass, so the plain version is held through
  what it decides; each case's recorded `WhatIfInputs` exercise its
  situation (72 pods a node and more owned anti terms than the kernel
  keeps, nodes without a domain, candidates without terms, winner ports,
  one of affinity and spread, ScheduleAnyway, counts that meet their
  thresholds exactly, the bootstrap rule)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k8s_scheduler_tpu.core.cycle as ref_cycle
import k8s_scheduler_tpu.models as ref_models
import k8s_scheduler_tpu.models.api as ref_api
import k8s_scheduler_tpu.ops.volumes as ref_vol
from k8s_scheduler_tpu.framework.interfaces import CycleContext as RefContext
from k8s_scheduler_tpu_torch.models import encoding
from k8s_scheduler_tpu_torch.ops import preemption, volumes
from k8s_scheduler_tpu_torch.utils import kernel_cases as kc
from torch_one_thread import one_torch_thread  # noqa: F401

# ---- K11 -------------------------------------------------------------------

_CHOICE = kc.pv_choice_cases("cpu")


def _choice_reference(tag):
    nodes, pods, kw = kc.pv_choice_objects(ref_models, ref_api)[tag]
    ref = ref_models.SnapshotEncoder().encode(nodes, pods, **kw)
    if tag in kc.PV_CHOICE_VOL:
        ref = kc.narrow_vol_slots(ref, kc.PV_CHOICE_VOL[tag])
    return ref, RefContext(ref).expr_node_mask


def test_pv_choice_tags_name_every_case():
    assert tuple(kc.pv_choice_objects(ref_models, ref_api)) == kc.PV_CHOICE_TAGS
    assert list(_CHOICE) == [f"{t}, draw {d}" for t in kc.PV_CHOICE_TAGS for d in range(3)]


@pytest.mark.parametrize("tag", kc.PV_CHOICE_TAGS)
def test_pv_choice_edge_case_plain_matches_reference(tag):
    ref, em = _choice_reference(tag)
    choose = jax.jit(lambda c, n, a: ref_vol.chosen_pv_slots(ref, em, c, n, a))
    for d in range(3):
        snap, tables, claimed, node_of, active = _CHOICE[f"{tag}, draw {d}"]
        assert snap.pod_vol_mode.shape == ref.pod_vol_mode.shape
        got = volumes.pv_choice_plain(snap, tables, claimed, node_of, active)
        want = choose(*(jnp.asarray(x.numpy()) for x in (claimed, node_of, active)))
        assert got.numpy().dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"draw {d}")


@pytest.mark.parametrize("tag", kc.PV_CHOICE_TAGS)
def test_pv_choice_edge_case_exercises_its_situation(tag):
    for d in range(3):
        snap, tables, claimed, node_of, active = _CHOICE[f"{tag}, draw {d}"]
        got = volumes.pv_choice_plain(snap, tables, claimed, node_of, active)
        pending = (snap.pod_vol_mode == 1) & snap.pod_valid[:, None]
        rows = active & pending.any(dim=1)
        node = node_of.clamp(0, snap.N - 1).long()
        lens = tables.node_off[node + 1] - tables.node_off[node] + tables.global_pv.shape[0]
        MVol = snap.pod_vol_mode.shape[1]
        assert rows.any()
        if tag == "a node list longer than the register cap":
            assert (lens[rows] > kc.PV_CHOICE_CAP).any() and (lens[rows] <= kc.PV_CHOICE_CAP).any()
            assert (got[rows & (lens > kc.PV_CHOICE_CAP)] >= 0).any()
        elif tag == "global PVs merged with the node's list":
            g, pv = tables.global_pv, tables.node_pv
            assert g.numel() and (g.min() < pv.max()) and (g.max() > pv.min())
            assert torch.isin(got, g).any() and torch.isin(got, pv).any()
        elif tag == "MVol = 1":
            assert MVol == 1 and not volumes._multi(snap)
        elif tag == "MVol = 8":
            assert MVol == 8 and volumes._multi(snap) and MVol - 1 > 6
            assert ((got >= 0).sum(dim=1) >= 6).any()
        elif tag == "every PV claimed":
            assert int((~claimed).sum()) <= 1 and (got < 0).all() == (d != 1)
        elif tag == "inactive rows with slots":
            assert (~active & pending.any(dim=1) & snap.pod_valid).any()
            assert (got[~active] == -1).all()
        elif tag == "node_of out of range":
            assert (node_of < 0).any() and (node_of >= snap.N).any()
            assert (got[rows & ((node_of < 0) | (node_of >= snap.N))] >= 0).any()
        elif tag == "slots that ride dynamic provisioning":
            dyn = volumes._dyn_at_node(snap, tables.req, node_of)
            assert (dyn & pending).any() and (~dyn & pending).any()
        elif tag == "capacities at the + 1e-3 edge":
            cap = snap.pv_capacity + np.float32(1e-3)
            size = snap.pod_vol_size[pending]
            assert torch.isin(size, cap).any()  # a request equal to cap + 1e-3
            above = torch.nextafter(cap, torch.full_like(cap, np.inf))
            assert torch.isin(size, above).any()  # and one step over it
        assert (got[~rows] == -1).all()


# ---- K8 --------------------------------------------------------------------


@pytest.mark.parametrize("tag", kc.WHATIF_TAGS)
def test_whatif_edge_case_preemption_matches_reference(tag):
    nodes, pods, existing = kc.whatif_objects(ref_models)[tag]
    ref = ref_models.SnapshotEncoder().encode(nodes, pods, existing)
    dec = ref_cycle.build_cycle_fn(commit_mode="rounds", outputs="latency")(ref)
    want = ref_cycle.build_preemption_fn()(ref, dec)
    snap, d, got, x = kc.whatif_inputs_of(tag)
    np.testing.assert_array_equal(d.assignment.numpy(), np.asarray(dec.assignment))
    for f in ("nominated", "victims", "num_preemptors"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert int(got.num_preemptors) > 0


@pytest.mark.parametrize("tag", kc.WHATIF_TAGS)
def test_whatif_edge_case_exercises_its_situation(tag):
    snap, d, r, x = kc.whatif_inputs_of(tag)
    ok = preemption.nonresource_ok_plain(x)
    C2, N, K1 = ok.shape
    MPN = x.node_pods.shape[1]
    assert K1 == MPN + 1 and not ok.all() and ok.any()
    valid = x.node_pods >= 0
    if tag == "MPN = 72":
        assert MPN == 72 and valid.sum(dim=1).max() > 64
        # the kept owned terms overflow on the crowded node
        e = x.node_pods[0][valid[0]].long()
        assert int((x.exist_anti[e, :, 0] >= 0).sum()) > kc.WHATIF_OWN_CAP
        # a verdict changes past the first 64 prefixes
        assert (ok[:, 0, 64:] != ok[:, 0, 64:65]).any() or (ok[:, 0, 64] != ok[:, 0, 63]).any()
    elif tag == "nodes with no domain for a key":
        assert (x.node_domains[: int(snap.num_nodes)] < 0).any()
    elif tag == "candidates with no terms":
        assert (x.anti[..., 0] < 0).all() and (x.aff[..., 0] < 0).all()
        assert (x.row_d > 0).any() and not ok[:, : int(snap.num_nodes)].all()
    elif tag == "host ports with winner_conf set":
        assert x.winner_conf.any() and (x.ports >= 0).any()
        assert ((x.exist_ports >= 0).any(dim=1)[x.node_pods.clamp(min=0).long()] & valid).any()
    elif tag == "affinity without spread":
        assert x.has_affinity and not x.has_spread
    elif tag == "spread without affinity":
        assert x.has_spread and not x.has_affinity
    elif tag == "a ScheduleAnyway spread term":
        when = x.tsc[..., 2]
        assert (when == encoding.WHEN_SCHEDULE_ANYWAY).any()
        assert (when == encoding.WHEN_DO_NOT_SCHEDULE).any()
    elif tag == "counts at the 0.5 thresholds":
        # anti: a verdict that turns true exactly at the last matching victim
        assert (~ok[..., 0] & ok[..., -1]).any()
    elif tag == "the bootstrap rule":
        sel = x.aff[:, 0, 0].clamp(min=0).long()
        assert (x.mp_c[torch.arange(C2), sel]).all()
        # node 0 holds every matching pod, all of them victims: evicting them
        # all leaves none anywhere, and the candidates pass by the bootstrap;
        # node 1 holds none while they run elsewhere, so it never passes
        me0 = x.me[sel][:, x.node_pods[0].clamp(min=0).long()] & valid[0]
        assert torch.equal(me0.sum(dim=1).float(), x.total[sel])
        assert ok[:, 0, -1].all() and (~ok[:, 1]).all(dim=1).any()
