"""The plain torch versions of the port's hand-written kernels against the
reference expressions they replace (the kernels themselves are held
against these plain versions on the card by chip_smoke.py).

- K1 `static_base_plain` against where(static_lean mask, clip(score),
  NEG_INF) from the JAX framework, alone and with node sampling and the
  fit filter folded in: masks and values bit-equal.
- K2 `claim_pass_plain` against the reference's pass body (round + u32
  hash tie-break + argmax_first + nominated override), across dead,
  accepted, nominated and anchor-delta states: bit-equal.
- K5 `capacity_plain` against the reference's resolve_capacity body (f32
  cumsum prefix, one-hot product fold) and the revocation fold, on sorted
  claims with long per-node runs: bit-equal.
- K6 `guard_sweep_plain` against the reference's `_seg_scan_tables` sweep
  and its per-role tests over random participant tables with every role,
  and against a sequential per-entry count: bit-equal.
- K7-K9, preemption's `prefilter_plain`, `nonresource_ok_plain` and
  `claim_loop_plain`, on hand-made inputs with known answers (K7 also on
  its seeded edge cases, `kernel_cases.prefilter_cases`, against a numpy
  transcription of the reference's prefilter): each
  node-choice key deciding in turn, PDB budgets over three groups spent
  across ranks, claimed ports, gates, what-if verdicts, every what-if
  constraint; `prefix_sums_f32` against jnp.cumsum across XLA's scan
  chunks; K9's seeded edge cases (`utils/kernel_cases.claim_cases`) each
  set up the situation it is named for.
- K10-K12, `volumes.volume_mask_plain` (both variants),
  `pv_choice_plain` and `pv_fold_plain` on their kernels' signatures,
  against the reference's volume_mask / volume_mask_unbound,
  chosen_pv_slots and fold_pv_claims: bit-equal, with the static base
  ANDing K10's mask equal to the reference's static_lean composition, and
  a contended batch whose fold needs more than one pass.
- On CPU tensors the dispatching wrappers run the plain versions and
  launch nothing."""

from __future__ import annotations

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k8s_scheduler_tpu.core.cycle as ref_cycle
import k8s_scheduler_tpu.framework.interfaces as ref_if
import k8s_scheduler_tpu.framework.runtime as ref_rt
import k8s_scheduler_tpu.models as ref_models
import k8s_scheduler_tpu.ops.argsel as ref_argsel
import k8s_scheduler_tpu.ops.resources as ref_res
import k8s_scheduler_tpu.ops.rounds as ref_rounds
from k8s_scheduler_tpu_torch.core.cycle import sampling_window
from k8s_scheduler_tpu_torch.framework.interfaces import CycleContext
from k8s_scheduler_tpu_torch.framework.runtime import Framework
from k8s_scheduler_tpu_torch.models.encoding import AUX_FIELDS, snapshot_from_numpy
from k8s_scheduler_tpu_torch.ops import (capacity, claim_pass, dyn_round, guard_sweep,
                                         interpod_terms, kernel_build, preempt_claim,
                                         preempt_prefilter, preempt_whatif, preemption,
                                         scan_commit, static_base)
from k8s_scheduler_tpu_torch.utils import kernel_cases
from test_torch_encoding import reference_snapshot
from torch_one_thread import one_torch_thread  # noqa: F401

def _carry(ref):
    return snapshot_from_numpy(
        ref.array_fields(), {k: getattr(ref, k) for k in AUX_FIELDS}, device="cpu"
    )


@pytest.mark.parametrize("fixture", ["mixed", "cfg2", "nominated"])
@pytest.mark.parametrize("variant", ["static_lean", "sampling", "fit"])
def test_static_base_plain_matches_reference(fixture, variant):
    ref = reference_snapshot(fixture)
    if variant == "sampling":  # a cluster wide enough for the window to bite
        import k8s_scheduler_tpu.models as rm
        import k8s_scheduler_tpu.utils.synth as rs

        ref = rm.SnapshotEncoder().encode(
            rs.make_cluster(260, taint_fraction=0.3),
            rs.make_pods(90, seed=8, selector_fraction=0.5, toleration_fraction=0.4),
        )
    port = _carry(ref)
    rfw = ref_rt.Framework.from_config()

    def ref_sbase(s):
        mask, score = rfw.static_lean(ref_if.CycleContext(s))
        if variant == "sampling":
            mask = mask & ref_cycle.sampling_mask(s, 30)
        if variant == "fit":
            mask = mask & ref_res.fit_mask(s.pod_requested, s.node_allocatable,
                                           s.node_requested)
        return jnp.where(mask, jnp.clip(score, -1e6, 1e6), ref_rounds.NEG_INF)

    want = np.asarray(jax.jit(ref_sbase)(ref))
    x = static_base.static_base_inputs(
        Framework.from_config(), CycleContext(port), fit=variant == "fit",
        sampling=sampling_window(port, 30) if variant == "sampling" else None,
    )
    got = static_base.static_base_plain(x).numpy()
    np.testing.assert_array_equal(got > -5e8, want > -5e8)
    np.testing.assert_array_equal(got, want)


def _reference_pass(base, mask, dead, acc, delta, gid, nominated):
    """ops/rounds.py one_round's wide pass body, verbatim in JAX."""
    B, N = base.shape
    avail = mask & ~dead & ~acc[:, None]
    tie = ref_rounds._tie_break(gid, N)
    scored = (jnp.round(base + delta[None, :]) + tie) if delta is not None \
        else (jnp.round(base) + tie)
    eff = jnp.where(avail, scored, ref_rounds.NEG_INF)
    pid = jnp.arange(B, dtype=jnp.int32)
    nom = jnp.clip(nominated, 0, N - 1)
    nom_ok = (nominated >= 0) & avail[pid, nom]
    best = jnp.where(nom_ok, nom, ref_argsel.argmax_first(eff, axis=1)).astype(jnp.int32)
    return best, avail[pid, best]


@pytest.mark.parametrize("state", range(6))
def test_claim_pass_plain_matches_reference(state):
    rng = np.random.default_rng(100 + state)
    B, N = 57, 131
    # integer-heavy scores: many rounding ties for the hash to break
    base = (rng.integers(0, 40, (B, N)) * 0.5
            + rng.choice([0.0, 0.25, 0.49, 0.51], (B, N))).astype(np.float32)
    base[rng.random((B, N)) < 0.1] = -1e9
    mask = rng.random((B, N)) < [0.9, 0.5, 0.2, 0.9, 0.05, 0.7][state]
    dead = rng.random((B, N)) < [0.0, 0.1, 0.3, 0.5, 0.0, 0.2][state]
    acc = rng.random(B) < [0.0, 0.2, 0.5, 0.1, 0.0, 0.9][state]
    delta = None if state in (0, 4) else rng.normal(0, 3, N).astype(np.float32)
    nominated = np.where(rng.random(B) < 0.3, rng.integers(0, N, B), -1).astype(np.int32)
    gid = rng.permutation(10 * B)[:B].astype(np.int32)
    want = jax.jit(_reference_pass)(base, mask, dead, acc, delta, gid, nominated)
    t = torch.from_numpy
    got = claim_pass.claim_pass_plain(
        t(base), t(mask), t(dead), t(acc), None if delta is None else t(delta),
        t(gid), t(nominated),
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_wrappers_use_plain_versions_on_cpu():
    """CPU tensors take the plain versions and count no kernel launch."""
    port = _carry(reference_snapshot("mixed"))
    x = static_base.static_base_inputs(Framework.from_config(), CycleContext(port))
    kernel_build.reset_launch_counts()
    torch.testing.assert_close(static_base.static_base(x),
                               static_base.static_base_plain(x), rtol=0, atol=0)
    B, N = x.shape
    args = (torch.zeros(B, N), torch.ones(B, N, dtype=torch.bool),
            torch.zeros(B, N, dtype=torch.bool), torch.zeros(B, dtype=torch.bool),
            None, torch.arange(B, dtype=torch.int32), port.pod_nominated)
    got, want = claim_pass.claim_pass(*args), claim_pass.claim_pass_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    cap_args = _capacity_case(0)[0]
    got, want = capacity.capacity(*cap_args), capacity.capacity_plain(*cap_args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    g_args = _guard_case(0)
    assert torch.equal(guard_sweep.guard_sweep(*g_args),
                       guard_sweep.guard_sweep_plain(*g_args))
    raw, feas = torch.randn(5, 9), torch.rand(5, 9) < 0.5
    assert torch.equal(interpod_terms.interpod_norm(raw, feas, True),
                       interpod_terms.interpod_norm_plain(raw, feas, True))
    x = _claim_inputs([[(1, 2, 0, [0]), (2, 2, 0, [])]], [(9, 2, 0), (9, 2, -1)], free=[0])
    got, want = preempt_claim.preempt_claim(x), preemption.claim_loop_plain(x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1].victims, want[1].victims)
    t = x.tables
    pf_args = (x.prio, x.req, x.live, t.vict_prio, t.prefix_freed,
               x.alloc - x.node_requested, x.gate, x.node_valid)
    assert torch.equal(preempt_prefilter.preempt_prefilter(*pf_args),
                       preemption.prefilter_plain(*pf_args))
    w = _whatif_case()
    assert torch.equal(preempt_whatif.preempt_whatif(w), preemption.nonresource_ok_plain(w))
    d = kernel_cases.dyn_cases("cpu")["B = 13, N = 13"]
    assert torch.equal(dyn_round.dyn_mask(*d["mask"])[0], dyn_round.dyn_mask_plain(*d["mask"])[0])
    assert torch.equal(dyn_round.dyn_score(*d["score"]), dyn_round.dyn_score_plain(*d["score"]))
    sx, srows = kernel_cases.static_reject_cases("cpu")["seeded rows"]
    assert torch.equal(static_base.static_rejects(sx, srows),
                       static_base.static_rejects_plain(sx, srows))
    r = kernel_cases.dyn_reject_cases("cpu")["every part kind, F = 9"]
    assert torch.equal(dyn_round.dyn_rejects(*r), dyn_round.dyn_rejects_plain(*r))
    assert set(kernel_build.launch_counts) == {
        "static_base", "claim_pass", "interpod_terms", "interpod_norm",
        "affinity_update", "capacity", "guard_sweep", "preempt_prefilter",
        "preempt_whatif", "preempt_claim", "volume_mask", "pv_choice", "pv_fold",
        "scan_commit", "dyn_mask", "dyn_score", "static_rejects", "dyn_rejects"}
    assert all(v == 0 for v in kernel_build.launch_counts.values())


def test_interpod_terms_guard_on_the_raw_sums():
    """K3's host-side guard: config #4's full workload (no preferred terms:
    the ScheduleAnyway bound, MC counts) is accepted; existing pods whose
    preferred weights the symmetric sums could add past 2^24 are refused
    before any launch. The bound is the snapshot's, read with no device
    sync."""
    from k8s_scheduler_tpu_torch.models import SnapshotEncoder
    from k8s_scheduler_tpu_torch.utils import synth

    nodes, existing, pending = synth.config4_workload([202])
    snap = SnapshotEncoder(device="cpu").encode(nodes, pending[202], existing)
    assert snap.pref_raw_bound == snap.pod_tsc.shape[1] * (snap.P + snap.exist_node.shape[0])
    interpod_terms.check_exact_range(snap)

    ref = reference_snapshot("cfg4")
    fields = dict(ref.array_fields())
    terms = np.array(fields["exist_pref_aff"])
    weights = np.array(fields["exist_pref_aff_w"])
    terms[:, 0] = (0, 0)  # every existing pod: one preferred term ...
    weights[:, 0] = np.float32(2**24 // terms.shape[0] + 1)  # ... summing past 2^24
    fields["exist_pref_aff"], fields["exist_pref_aff_w"] = terms, weights
    heavy = snapshot_from_numpy(fields, {k: getattr(ref, k) for k in AUX_FIELDS},
                                device="cpu")
    assert heavy.pref_raw_bound >= interpod_terms.EXACT_F32
    with pytest.raises(ValueError, match="2\\^24"):
        interpod_terms.check_exact_range(heavy)
    interpod_terms.check_exact_range(_carry(ref))


# the seeded K1 edge cases (utils/kernel_cases.py): each static filter
# alone, the fit filter and the sampling window alone, 0-3 score terms
K1_EDGE = (
    [(f"{f} alone", (f,), 3, None) for f in kernel_cases.K1_FILTERS]
    + [("fit alone", (), 3, "fit"), ("sampling alone", (), 3, "sampling")]
    + [(f"{k} score terms", kernel_cases.K1_FILTERS, k, None) for k in range(4)])


@pytest.mark.parametrize("case", K1_EDGE, ids=[c[0] for c in K1_EDGE])
def test_static_base_plain_edge_cases_match_reference(case):
    import k8s_scheduler_tpu.config as ref_config
    import k8s_scheduler_tpu.models as ref_models
    import k8s_scheduler_tpu_torch.config as port_config

    _, filters, n_scores, extra = case
    nodes, pods, existing = kernel_cases.k1_objects(ref_models)
    ref = ref_models.SnapshotEncoder().encode(nodes, pods, existing)
    port = _carry(ref)
    rfw = ref_rt.Framework.from_config(kernel_cases.k1_profile(ref_config, filters, n_scores))
    pct = kernel_cases.K1_SAMPLING_PCT

    def ref_sbase(s):
        mask, score = rfw.static_lean(ref_if.CycleContext(s))
        if extra == "sampling":
            mask = mask & ref_cycle.sampling_mask(s, pct)
        if extra == "fit":
            mask = mask & ref_res.fit_mask(s.pod_requested, s.node_allocatable,
                                           s.node_requested)
        return jnp.where(mask, jnp.clip(score, -1e6, 1e6), ref_rounds.NEG_INF)

    want = np.asarray(jax.jit(ref_sbase)(ref))
    x = static_base.static_base_inputs(
        Framework.from_config(kernel_cases.k1_profile(port_config, filters, n_scores)),
        CycleContext(port), fit=extra == "fit",
        sampling=sampling_window(port, pct) if extra == "sampling" else None)
    assert len(x.terms) == n_scores
    got = static_base.static_base_plain(x).numpy()
    np.testing.assert_array_equal(got > -5e8, want > -5e8)
    np.testing.assert_array_equal(got, want)
    # the filter under test masks pairs that node validity alone keeps
    valid = np.asarray(ref.node_valid)[None, :] & np.asarray(ref.pod_valid)[:, None]
    if filters != kernel_cases.K1_FILTERS:
        assert ((got < -5e8) & valid).any()


def test_static_base_rejects_an_uncovered_static_plugin():
    from k8s_scheduler_tpu_torch.framework.interfaces import PluginBase

    class Custom(PluginBase):
        name = "Custom"

        def static_mask(self, ctx):
            return torch.ones((ctx.snap.P, ctx.snap.N), dtype=torch.bool)

    port = _carry(reference_snapshot("cfg1"))
    fw = Framework.from_config()
    fw.filters.append(Custom())
    with pytest.raises(NotImplementedError, match="Custom"):
        static_base.static_base_inputs(fw, CycleContext(port))


# ---- K5 capacity ----------------------------------------------------------


def _capacity_case(seed):
    """Sorted claims of one pass: B claims on few nodes (runs of dozens),
    some dead (node N); requests are dyadic like the encoder's."""
    rng = np.random.default_rng(seed)
    B, N, R = 300, 11, 3
    best = rng.integers(0, N, B).astype(np.int32)
    live = rng.random(B) < 0.85
    rank = rng.permutation(B).astype(np.int32)
    req = (rng.integers(1, 16, (B, R)) * np.array([0.25, 2.0**28, 1.0])).astype(np.float32)
    alloc = (rng.integers(8, 40, (N, R)) * np.array([1.0, 2.0**30, 10.0])).astype(np.float32)
    node_req = (alloc * rng.choice([0.0, 0.25, 0.5], (N, 1))).astype(np.float32)
    rank_bits = int(B - 1).bit_length()
    key = np.where(live, best, N).astype(np.int64) * (1 << rank_bits) + rank
    order = np.argsort(key, kind="stable")
    t = torch.from_numpy
    slack = ref_res_slack(alloc)
    return (t(key[order]), t(order), rank_bits, t(req), t(node_req), t(alloc),
            t(slack), True), (live, best, rank, req, node_req, alloc, slack)


def ref_res_slack(alloc):
    return np.array(jax.jit(lambda a: ref_rounds._REL_EPS * a + ref_rounds._REL_EPS)(alloc))


def _reference_capacity(live, best, rank, req, node_req, alloc, slack):
    """ops/rounds.py resolve_capacity's body, verbatim in JAX."""
    B, N = live.shape[0], node_req.shape[0]
    rank_space = 1 << int(B - 1).bit_length()
    nkey = jnp.where(live, best, N).astype(jnp.uint32)
    packed = nkey * jnp.uint32(rank_space) + rank.astype(jnp.uint32)
    packed_s, order = jax.lax.sort((packed, jnp.arange(B, dtype=jnp.int32)), num_keys=1)
    s_node = (packed_s // jnp.uint32(rank_space)).astype(jnp.int32)
    s_live = s_node < N
    s_req = jnp.where(s_live[:, None], req[order], 0.0)
    cum = jnp.cumsum(s_req, axis=0)
    before = cum - s_req
    i = jnp.arange(B, dtype=jnp.int32)
    seg_start = jnp.concatenate([jnp.ones((1,), bool), s_node[1:] != s_node[:-1]])
    seg_first = jax.lax.cummax(jnp.where(seg_start, i, -1))
    seg_before = before - before[seg_first]
    nsafe = jnp.clip(s_node, 0, N - 1)
    free = alloc[nsafe] - node_req[nsafe] + slack[nsafe]
    fits = jnp.all(seg_before + s_req <= free, axis=1) & s_live
    accepted = jnp.zeros((B,), bool).at[order].set(fits)
    oh = jax.nn.one_hot(jnp.where(accepted, best, 0), N, dtype=jnp.float32)
    add = jnp.where(accepted[:, None], req, 0.0)
    return accepted, node_req + jnp.matmul(oh.T, add, precision=jax.lax.Precision.HIGHEST)


@pytest.mark.parametrize("seed", range(4))
def test_capacity_plain_matches_reference_resolve_capacity(seed):
    args, raw = _capacity_case(seed)
    want = jax.jit(_reference_capacity)(*raw)
    got = capacity.capacity_plain(*args)
    assert int(np.asarray(want[0]).sum()) > 0
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("seed", range(3))
def test_capacity_plain_revocation_fold_matches_scatter(seed):
    """check=False folds every live claim: the reference's round-end
    `.at[node].add(-req)` of the revoked claims."""
    rng = np.random.default_rng(50 + seed)
    _, (live, best, rank, req, node_req, alloc, slack) = _capacity_case(seed)
    N = node_req.shape[0]
    revoked = live & (rng.random(live.shape[0]) < 0.3)
    key = np.where(revoked, best, N).astype(np.int64)
    order = np.argsort(key, kind="stable")
    t = torch.from_numpy
    acc, got = capacity.capacity_plain(t(key[order]), t(order), 0, t(-req), t(node_req),
                                       t(alloc), t(slack), False)
    want = jax.jit(lambda nr: nr.at[jnp.where(revoked, best, 0)].add(
        jnp.where(revoked[:, None], -req, 0.0)))(node_req)
    np.testing.assert_array_equal(acc.numpy(), revoked)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


_CAPACITY_CASES = kernel_cases.capacity_cases()


@pytest.mark.parametrize("tag", [t for t in _CAPACITY_CASES if "fold" not in t])
def test_capacity_plain_edge_cases_match_reference(tag):
    """The seeded K5 edge cases (utils/kernel_cases.py): node runs across
    the 32- and 256-claim boundaries, one and eight resources, every claim
    dead."""
    args, raw = _CAPACITY_CASES[tag]
    want = jax.jit(_reference_capacity)(*raw)
    got = capacity.capacity_plain(*args)
    live = raw[0]
    assert int(np.asarray(want[0]).sum()) == 0 if not live.any() else \
        0 < int(np.asarray(want[0]).sum()) < int(live.sum())
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # by value: the cases' -0.0 rows (the kernel's bit-copy rule, held on
    # the card) come out +0.0 from the reference's one-hot add where no
    # claim lands; the encoder never makes -0.0
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_capacity_plain_edge_fold_matches_scatter():
    """The seeded revocation fold of five claims (check=False, negative
    requests): the reference's `.at[node].add(-req)`."""
    args, (revoked, best, req, node_req) = _CAPACITY_CASES["revocation fold, 5 claims"]
    acc, got = capacity.capacity_plain(*args)
    want = jax.jit(lambda nr: nr.at[jnp.where(revoked, best, 0)].add(
        jnp.where(revoked[:, None], -req, 0.0)))(node_req)
    np.testing.assert_array_equal(acc.numpy(), revoked)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- K6 guard sweep -------------------------------------------------------

_ROLES = [guard_sweep.RB_MATCH, guard_sweep.RB_ANTI, guard_sweep.RB_BOOT,
          guard_sweep.RB_GMATCH, guard_sweep.RB_SPREAD, guard_sweep.RB_PORT,
          guard_sweep.RB_PV, guard_sweep.RB_MATCH]


def _guard_case(seed, n_keys=7):
    """A sorted participant table: B claimants x 8 emit slots over a few
    groups, a third of the entries padding (GK_INVALID), spread caps 1-3,
    and pods that emit several entries into one group."""
    rng = np.random.default_rng(seed)
    B, slots = 64, len(_ROLES)
    gk_invalid = 1000
    keys = rng.integers(0, n_keys, (slots, B))
    keys[rng.random((slots, B)) < 0.33] = gk_invalid
    rank = rng.permutation(B)
    rank_bits = int(B - 1).bit_length()
    packed = (keys.astype(np.int64) << rank_bits) + rank[None, :]
    packed = packed.reshape(-1)
    perm = np.argsort(packed, kind="stable")
    caps = np.where(np.array(_ROLES)[:, None] == guard_sweep.RB_SPREAD,
                    rng.integers(1, 4, (slots, B)), guard_sweep.NO_CAP).reshape(-1)
    t = torch.from_numpy
    return (t(packed[perm]), t(perm), rank_bits, B,
            torch.tensor(_ROLES, dtype=torch.int32), t(caps.astype(np.int32)), gk_invalid)


def _reference_guard(keys_s, perm, B, role_tab, caps, gk_invalid):
    """ops/rounds.py guards_ok's sweep after the sort, verbatim in JAX."""
    slot = perm // B
    pods_s = perm - slot * B
    role_s = role_tab[slot]
    cap_s = caps[perm]
    before = ref_rounds._seg_scan_tables(keys_s, pods_s, {
        "match": (role_s == 1).astype(jnp.int32),
        "anti": (role_s == 2).astype(jnp.int32),
        "boot": (role_s == 4).astype(jnp.int32),
        "gmatch": (role_s == 8).astype(jnp.int32),
        "port": (role_s == 32).astype(jnp.int32),
        "pv": (role_s == 64).astype(jnp.int32),
        "arrive": ((role_s == 1) | (role_s == 16)).astype(jnp.int32),
    })
    ok_e = jnp.ones(keys_s.shape, bool)
    ok_e &= jnp.where(role_s == 2, before["match"] == 0, True)
    ok_e &= jnp.where(role_s == 1, before["anti"] == 0, True)
    ok_e &= jnp.where(role_s == 4, (before["boot"] == 0) & (before["gmatch"] == 0), True)
    ok_e &= jnp.where(role_s == 16, before["arrive"] < cap_s, True)
    ok_e &= jnp.where(role_s == 32, before["port"] == 0, True)
    ok_e &= jnp.where(role_s == 64, before["pv"] == 0, True)
    ok_e |= keys_s == gk_invalid
    return jnp.ones((B,), jnp.int32).at[pods_s].min(ok_e.astype(jnp.int32)) > 0


def _sequential_guard(s_packed, perm, rank_bits, B, role_tab, caps, gk_invalid):
    """Per entry, count the group's entries of other pods ranked before it."""
    keys = (s_packed >> rank_bits).tolist()
    pods = (perm % B).tolist()
    roles = role_tab[perm // B].tolist()
    rank = (s_packed & ((1 << rank_bits) - 1)).tolist()
    ok = [True] * B
    for i, (k, p, r) in enumerate(zip(keys, pods, roles)):
        if k == gk_invalid:
            continue
        prior = [roles[j] for j in range(len(keys))
                 if keys[j] == k and rank[j] < rank[i] and pods[j] != p]
        n = {x: prior.count(x) for x in (1, 2, 4, 8, 16, 32, 64)}
        good = {2: n[1] == 0, 1: n[2] == 0, 4: n[4] + n[8] == 0,
                16: n[1] + n[16] < int(caps[perm[i]]), 32: n[32] == 0,
                64: n[64] == 0}.get(r, True)
        ok[p] = ok[p] and good
    return np.array(ok)


@pytest.mark.parametrize("seed", range(6))
def test_guard_sweep_plain_matches_reference_sweep(seed):
    args = _guard_case(seed, n_keys=[3, 7, 20, 2, 5, 11][seed])
    s_packed, perm, rank_bits, B, role_tab, caps, gk_invalid = args
    got = guard_sweep.guard_sweep_plain(*args).numpy()
    want = jax.jit(_reference_guard, static_argnums=(2, 5))(
        (s_packed >> rank_bits).numpy(), perm.numpy(), B, role_tab.numpy(),
        caps.numpy(), gk_invalid)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, _sequential_guard(*args))
    assert 0 < got.sum() < B


# ---- K7-K9 preemption stages ------------------------------------------------


def _victim_tables(nodes, R=1):
    """VictimTables of hand-made nodes: each a list of victims (priority,
    request, start, pdb ids), listed ascending by priority as the encoder
    sorts them."""
    N = len(nodes)
    MPN = max(1, max(len(v) for v in nodes))
    E = sum(len(v) for v in nodes) + 1
    node_pods = np.full((N, MPN), -1, np.int32)
    prio = np.zeros(E, np.int32)
    req = np.zeros((E, R), np.float32)
    start = np.zeros(E, np.float32)
    pdb = np.full((E, 2), -1, np.int32)
    e = 0
    for n, vs in enumerate(nodes):
        for j, (p, q, s, gs) in enumerate(vs):
            node_pods[n, j] = e
            prio[e], req[e], start[e] = p, q, s
            pdb[e, : len(gs)] = gs
            e += 1
    t = torch.from_numpy
    snap = types.SimpleNamespace(
        exist_valid=t(np.arange(E) < e), node_pods=t(node_pods), exist_priority=t(prio),
        exist_requested=t(req), exist_start=t(start), exist_pdb=t(pdb),
        device=torch.device("cpu"))
    return preemption.victim_tables(snap), E


def _claim_inputs(nodes, preemptors, free, pdb_allowed=(0,), gate=None, ok_nr=None,
                  Q=2):
    """ClaimInputs for hand-made nodes (see `_victim_tables`; one resource),
    preemptors (priority, request, port id or -1) in rank order, each node's
    free room before eviction, PDB budgets, and optional gate / what-if
    tables (all true by default)."""
    vt, E = _victim_tables(nodes)
    N, MPN = vt.node_pods.shape
    C2 = len(preemptors)
    t = torch.tensor
    alloc = torch.full((N, 1), 100.0)
    return preemption.ClaimInputs(
        n_live=t([C2], dtype=torch.int32), live=torch.ones(C2, dtype=torch.bool),
        prio=t([p for p, _, _ in preemptors], dtype=torch.int32),
        req=t([[float(q)] for _, q, _ in preemptors]),
        port_ids=t([[port] for _, _, port in preemptors], dtype=torch.int32),
        gate=torch.ones((C2, N), dtype=torch.bool) if gate is None else t(gate),
        ok_nr=(torch.ones((C2, N, MPN + 1), dtype=torch.bool) if ok_nr is None
               else t(ok_nr)),
        node_valid=torch.ones(N, dtype=torch.bool), alloc=alloc,
        node_requested=alloc - t([[float(f)] for f in free]), slack=torch.zeros((N, 1)),
        pdb_allowed=t(list(pdb_allowed), dtype=torch.int32), tables=vt,
        num_existing=E, num_ports=Q)


def test_prefix_sums_follow_the_reference_cumsum_order():
    """`prefix_sums_f32` against jnp.cumsum on f32 values that round, over
    lengths inside and across XLA's 16-entry scan chunk."""
    rng = np.random.default_rng(3)
    for L in (1, 8, 16, 17, 24, 40):
        x = (rng.integers(10**8, 10**9, (64, L, 2)) * rng.choice([1.0, 0.37], (64, L, 2))
             ).astype(np.float32)
        want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(x))
        got = preemption.prefix_sums_f32(torch.from_numpy(x), dim=1).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"L={L}")
        if L >= 24:  # a plain left-to-right sum differs somewhere
            assert (np.cumsum(x, axis=1, dtype=np.float32) != want).any()


def test_prefilter_plain_known_answers():
    """Five candidates against three nodes: a fit needing both victims, a
    priority that makes only a too-small prefix eligible, a gate that
    excludes the only fitting node, a non-candidate, and an invalid node."""
    vt, _ = _victim_tables([[(1, 1.0, 0, []), (5, 2.0, 0, [])], [],
                            [(2, 1.0, 0, []), (3, 1.0, 0, [])]])
    t = torch.tensor
    prio = t([10, 4, 10, 10, 10], dtype=torch.int32)
    req = t([[3.0], [3.0], [2.0], [1.0], [2.0]])
    cand_ok = t([True, True, True, False, True])
    free0 = t([[0.0], [10.0], [0.0]])
    gate = t([[1, 1, 1], [1, 1, 1], [0, 1, 1], [1, 1, 1], [1, 0, 1]], dtype=torch.bool)
    node_valid = t([True, True, False])
    got = preemption.prefilter_plain(prio, req, cand_ok, vt.vict_prio, vt.prefix_freed,
                                     free0, gate, node_valid)
    assert got.tolist() == [True, False, False, False, True]


def _reference_prefilter(x: dict) -> np.ndarray:
    """Reference `ops/preemption.py:219-232` in numpy, candidates in chunks:
    elig over the valid victims below the priority, the fit of every
    prefix in f32 (free0 + prefix_freed, one rounding), prefixes 1..elig,
    gate and node_valid, then cand_ok."""
    prio, req, vict_prio = x["prio"], x["req"], x["vict_prio"]
    vict_valid = vict_prio != kernel_cases._BIG_I32
    ks = np.arange(vict_prio.shape[1] + 1)
    out = []
    for c0 in range(0, prio.shape[0], 16):
        sl = slice(c0, c0 + 16)
        elig = np.sum(vict_valid[None] & (vict_prio[None] < prio[sl, None, None]), axis=2)
        fits = np.all(req[sl, None, None, :]
                      <= x["free0"][None, :, None, :] + x["prefix_freed"][None], axis=-1)
        allowed = fits & (ks[None, None] >= 1) & (ks[None, None] <= elig[:, :, None])
        out.append(np.any(allowed & x["gate"][sl, :, None] & x["node_valid"][None, :, None],
                          axis=(1, 2)))
    return np.concatenate(out) & x["cand_ok"]


@pytest.mark.parametrize("tag", kernel_cases.PREFILTER_TAGS)
def test_prefilter_plain_edge_cases_match_reference(tag):
    """K7's seeded edge cases (`kernel_cases.prefilter_cases`, which the
    card holds the kernel against): `prefilter_plain` equals the numpy
    transcription of the reference's prefilter on each, and the case sets
    up what it is named for."""
    raw = kernel_cases.prefilter_raw_cases()[tag]
    args = kernel_cases.prefilter_args(raw, "cpu")
    want = _reference_prefilter(raw)
    got = preemption.prefilter_plain(*args)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(preempt_prefilter.preempt_prefilter(*args), got)
    C, R = raw["req"].shape
    N, MPN = raw["vict_prio"].shape
    shape = preempt_prefilter.launch_shape(C, N, MPN, R)
    assert shape["staged"] == (not tag.startswith("tables from L2")), shape
    if tag in ("no victim below the priority", "every candidate infeasible",
               "node_valid false on the only fit"):
        assert not want.any() and raw["cand_ok"].any()
    if tag.startswith("the only fit") or tag == "C = 1":
        assert want.all()
    if tag == "an exact fit at equality":
        assert want.tolist() == [c % 2 == 0 for c in range(C)]
    if tag == "cand_ok false on half":
        assert want.any() and not want[::2].any()
    if tag in ("MPN = 1", "prefix rooms out of order", "negative free room"):
        assert 0 < want.sum() < raw["cand_ok"].sum()
    if tag == "negative free room":
        assert (raw["free0"] < 0).all()
    if tag == "prefix rooms out of order":
        assert (np.diff(raw["prefix_freed"][:, 1:], axis=1) < 0).any()


@pytest.mark.parametrize("case", ["viol", "max_prio", "prio_sum", "count", "start", "index"])
def test_claim_loop_plain_lexmin_keys(case):
    """Two nodes that tie on every node-choice key before `case` and differ
    at it; the winner is the node the key prefers."""
    v = {  # (node 0 victims, node 1 victims, PDB budgets, winner)
        "viol": ([(1, 4, 0, [0])], [(2, 4, 0, [1])], (0, 1), 1),
        "max_prio": ([(5, 4, 0, [])], [(3, 4, 0, [])], (0,), 1),
        "prio_sum": ([(2, 2, 0, []), (3, 2, 0, [])], [(0, 1, 0, []), (3, 3, 0, [])], (0,), 1),
        "count": ([(0, 2, 0, []), (3, 2, 0, [])], [(3, 4, 0, [])], (0,), 1),
        "start": ([(3, 4, 5.0, [])], [(3, 4, 9.0, [])], (0,), 1),
        "index": ([(3, 4, 7.0, [])], [(3, 4, 7.0, [])], (0,), 0),
    }[case]
    n0, n1, budgets, winner = v
    x = _claim_inputs([n0, n1], [(10, 4, -1)], free=[0, 0], pdb_allowed=budgets)
    noms, cy = preemption.claim_loop_plain(x)
    assert noms.tolist() == [winner]
    k = len((n0, n1)[winner])
    assert cy.k_claimed.tolist() == [k if n == winner else 0 for n in range(2)]
    assert cy.nominated_req[winner].tolist() == [4.0]
    assert int(cy.victims.sum()) == k


def test_claim_loop_plain_carry_across_ranks():
    """Three PDB groups (GP = 3) and three ranks: rank 0 takes node 0's
    first victim without a violation (group 0's budget is then spent);
    rank 1 violates one budget on every node (group 0 on node 0, group 2 on
    nodes 1 and 2) and takes node 1, whose victim has the lowest priority,
    holding port 1 there; rank 2 wants port 1, so node 1 is out, and of the
    two last-resort nodes takes node 0 (victim priority 2 < 3), past
    k_claimed = 1."""
    nodes = [[(1, 2, 0, [0]), (2, 2, 0, [0])],
             [(1, 2, 0, [1, 2])],
             [(3, 2, 0, [2]), (3, 2, 1.0, [2])]]
    x = _claim_inputs(nodes, [(9, 2, -1), (8, 2, 1), (7, 2, 1)], free=[0, 0, 0],
                      pdb_allowed=(1, 1, 0))
    noms, cy = preemption.claim_loop_plain(x)
    assert noms.tolist() == [0, 1, 0]
    assert cy.k_claimed.tolist() == [2, 1, 0]
    assert cy.pdb_used.tolist() == [2, 1, 1]
    assert cy.victims.nonzero().flatten().tolist() == [0, 1, 2]
    assert cy.claimed_q.tolist() == [[False, True], [False, True], [False, False]]
    assert cy.nominated_req[:, 0].tolist() == [4.0, 2.0, 0.0]


def test_claim_loop_plain_gates_and_whatif():
    """A rank that fits only on a gated node, or only past a prefix the
    what-if forbids, gets no nomination; a dead rank nominates nothing."""
    nodes = [[(1, 2, 0, []), (2, 2, 0, [])]]
    ok_nr = [[[True, True, False]], [[True, False, True]]]
    x = _claim_inputs(nodes, [(9, 4, -1), (9, 2, -1)], free=[0], ok_nr=ok_nr)
    noms, cy = preemption.claim_loop_plain(x)
    # rank 0 needs both victims (k=2 forbidden); rank 1's k=1 forbidden,
    # k=2 allowed (two victims for a 2-unit pod)
    assert noms.tolist() == [-1, 0] and cy.k_claimed.tolist() == [2]
    x = _claim_inputs(nodes, [(9, 2, -1)], free=[0], gate=[[False]])
    assert preemption.claim_loop_plain(x)[0].tolist() == [-1]
    x = _claim_inputs(nodes, [(9, 2, -1)], free=[0])
    x.n_live = torch.tensor([0], dtype=torch.int32)
    assert preemption.claim_loop_plain(x)[0].tolist() == [-1]


_CLAIM_CASES = kernel_cases.claim_cases()


@pytest.mark.parametrize("tag", list(_CLAIM_CASES))
def test_claim_edge_cases_exercise_their_situation(tag):
    """The seeded K9 edge cases (utils/kernel_cases.claim_cases, held
    against the kernel on the card) set up what each is named for, under
    the plain loop; every case's victims are the claimed prefixes."""
    x = _CLAIM_CASES[tag]
    noms, cy = preemption.claim_loop_plain(x)
    n_live, N = int(x.n_live), x.gate.shape[1]
    got = [n for n in noms.tolist() if n >= 0]
    assert noms[n_live:].eq(-1).all()
    assert int(cy.victims.sum()) == int(cy.k_claimed.sum())
    if tag == "n_live=0":
        assert not got
    else:
        assert got
    if tag == "N=13":  # one node a slice: the last slices hold no node
        assert -(-N // kernel_cases.CLAIM_SLICES) * (kernel_cases.CLAIM_SLICES - 1) >= N
    if tag.startswith("N="):
        assert N % kernel_cases.CLAIM_SLICES != 0
    if tag == "winner in the last slice":
        assert min(got) >= N - N // kernel_cases.CLAIM_SLICES
    if tag == "equal keys in two slices":
        assert got[:2] == [700, 7000] and set(got) == {700, 7000}
    if tag == "one node, consecutive ranks":
        assert got == [4321] * 8 and int(cy.k_claimed[4321]) == 8
    if tag == "PDB budgets spent, 64 ranks":
        assert n_live == 64 and bool((cy.pdb_used >= x.pdb_allowed).any())
    if tag == "ports block later ranks":
        assert len(got) < n_live
    if tag in ("n_live=C2", "PDB budgets spent, 64 ranks"):
        assert n_live == x.live.shape[0]
    if tag == "R=8":
        assert x.req.shape[1] == 8
    if tag == "MB=4":
        assert x.tables.vict_pdb.shape[2] == 4
    if tag == "priority sums wrap":
        assert bool((x.tables.prefix_prio < 0).any())


@pytest.mark.parametrize("N, refused", [(preempt_claim.MAX_NODES, False),
                                        (preempt_claim.MAX_NODES + 1, True)])
def test_preempt_claim_node_limit(N, refused):
    """K9's cluster holds at most 2048 nodes a CTA: above 16 CTAs' worth
    the wrapper refuses the inputs with a ValueError naming the limit,
    before it touches the card (here, CPU tensors)."""
    x = kernel_cases._claim_inputs(np.random.default_rng(5), "cpu", N=N, C2=1, R=1, MPN=1,
                                   MB=1, GP=1, Q=1, MP=1)
    if refused:
        with pytest.raises(ValueError, match=f"at most {preempt_claim.MAX_NODES}"):
            preempt_claim.preempt_claim_cuda(x)
    else:
        assert preempt_claim._dims(x)[1] == N


def _whatif_case():
    """One candidate on two nodes (one zone domain each, hostname keys),
    node 0's victims: slot 0 matches selector 0 and holds port 80, slot 1
    matches selector 0 and owns an anti term against selector 1."""
    t = torch.tensor
    node_pods = t([[0, 1], [2, -1]], dtype=torch.int32)
    node_domains = t([[0, 2], [1, 3]], dtype=torch.int32)  # keys: zone, hostname
    me = t([[True, True, False], [False, False, True]])  # [S=2, E=3]
    counts = t([[2.0, 0.0, 2.0, 0.0], [0.0, 1.0, 0.0, 1.0]])  # [S, D]
    x = preemption.WhatIfInputs(
        node_pods=node_pods, node_domains=node_domains,
        ports=t([[-1]], dtype=torch.int32),
        exist_ports=t([[80], [-1], [-1]], dtype=torch.int32),
        winner_conf=t([[False, False]]), has_affinity=True, has_spread=False,
        anti=t([[[-1, -1]]], dtype=torch.int32), aff=t([[[-1, -1]]], dtype=torch.int32),
        counts=counts, total=counts[:, :2].sum(dim=1), mp_c=t([[False, False]]), me=me,
        exist_anti=t([[[-1, -1]], [[1, 1]], [[-1, -1]]], dtype=torch.int32),
        row_d=torch.zeros((1, 4)))
    return x


@pytest.mark.parametrize("term", ["anti", "aff", "aff_boot", "symmetric", "ports",
                                  "winner", "spread"])
def test_whatif_plain_known_answers(term):
    x = _whatif_case()
    t = torch.tensor
    if term == "anti":  # anti toward selector 0 by hostname: both matches must go
        x.anti = t([[[0, 1]]], dtype=torch.int32)
        want = [[False, False, True], [True, True, True]]
    elif term == "aff":  # affinity to selector 0 by hostname: keep one match
        x.aff = t([[[0, 1]]], dtype=torch.int32)
        want = [[True, True, False], [False, False, False]]
    elif term == "aff_boot":  # selector 1 (one pod, on node 1); the candidate
        x.aff = t([[[1, 1]]], dtype=torch.int32)  # matches it: evicting the
        x.mp_c = t([[False, True]])  # last one bootstraps
        want = [[False, False, False], [True, True, True]]
    elif term == "symmetric":  # slot 1 owns anti(selector 1) by hostname
        x.mp_c = t([[False, True]])
        x.row_d = t([[0.0, 0.0, 1.0, 0.0]])
        want = [[False, False, True], [True, True, True]]
    elif term == "ports":
        x.ports = t([[80]], dtype=torch.int32)
        want = [[False, True, True], [True, True, True]]
    elif term == "winner":
        x.ports = t([[80]], dtype=torch.int32)
        x.winner_conf = t([[False, True]])
        want = [[False, True, True], [False, False, False]]
    else:  # DoNotSchedule maxSkew 1 by zone on selector 0: zone 0 holds 2,
        x.has_affinity, x.has_spread = False, True  # zone 1 holds 0
        x.tsc = t([[[0, 0, 0]]], dtype=torch.int32)
        x.tsc_skew = t([[1]], dtype=torch.int32)
        x.sp_min1, x.sp_amin, x.sp_min2 = (t([0.0, 0.0, 0.0, 0.0]),
                                           t([1, 1, 0, 0], dtype=torch.int32),
                                           t([2.0, 1.0, 1e9, 1e9]))
        want = [[False, False, True], [True, True, True]]
    got = preemption.nonresource_ok_plain(x)
    assert got[0].tolist() == want


# ---- K10-K12 volume_mask, pv_choice, pv_fold ------------------------------


def _volume_case(name):
    import test_torch_volumes as tv

    ref = tv.reference_snapshot(name)
    port = _carry(ref)
    ctx = CycleContext(port)
    return ref, port, ref_if.CycleContext(ref).expr_node_mask, ctx.volume_tables


@pytest.mark.parametrize("name", ["cfg4_volumes", "eight_slot_tight", "contending",
                                  "conjunction"])
def test_volume_kernel_twins_match_reference(name):
    import k8s_scheduler_tpu.ops.volumes as ref_vol

    from k8s_scheduler_tpu_torch.ops import volumes

    ref, port, em, tables = _volume_case(name)
    rng = np.random.default_rng(3)
    V, P = port.pv_avail.shape[0], port.P
    claimed = rng.random(V) < 0.25
    node_of = rng.integers(0, int(port.num_nodes), P).astype(np.int32)
    active = (rng.random(P) < 0.9) & np.asarray(ref.pod_valid)
    t, j = torch.from_numpy, jnp.asarray
    pairs = [
        (volumes.volume_mask_plain(port, tables, None, False), ref_vol.volume_mask(ref, em)),
        (volumes.volume_mask_plain(port, tables, t(claimed), True),
         ref_vol.volume_mask_unbound(ref, em, j(claimed))),
        (volumes.pv_choice_plain(port, tables, t(claimed), t(node_of), t(active)),
         ref_vol.chosen_pv_slots(ref, em, j(claimed), j(node_of), j(active))),
        (volumes.pv_fold_plain(port, tables, t(claimed), t(active), t(node_of),
                               port.pod_order.to(torch.int32)),
         ref_vol.fold_pv_claims(ref, em, j(claimed), j(active), j(node_of),
                                j(np.asarray(ref.pod_order).astype(np.int32)))),
    ]
    for got, want in pairs:
        w = np.asarray(want)
        assert got.numpy().dtype == w.dtype
        np.testing.assert_array_equal(got.numpy(), w)


@pytest.mark.parametrize("name", ["cfg4_volumes", "bound_zone", "three_slot_chain"])
def test_static_base_with_volume_mask_matches_reference(name):
    """K1 with VolumeBinding's static mask as its mask operand equals the
    reference's where(static_lean mask, clip(score), NEG_INF)."""
    ref, port, _, _ = _volume_case(name)
    fw = Framework.from_config()
    x = static_base.static_base_inputs(fw, CycleContext(port), fit=False)
    assert x.flags & static_base.F_MASK and x.mask is not None
    mask, score = ref_rt.Framework.from_config().static_lean(ref_if.CycleContext(ref))
    want = np.where(np.asarray(mask), np.clip(np.asarray(score), -1e6, 1e6),
                    np.float32(static_base.NEG_INF))
    got = static_base.static_base_plain(x).numpy()
    np.testing.assert_array_equal(got > static_base.NEG_INF / 2, np.asarray(mask))
    np.testing.assert_array_equal(got, want)


def test_pv_fold_plain_contended_batch_takes_several_passes():
    """Four claimants of one class on one node over two equivalent PVs, all
    accepted at once: every claimant chooses pv-0 in the first pass, the
    lowest rank wins it, the next pass gives pv-1 to the next rank — the
    fold takes more than one pass, as the reference's, while the guard key
    (K11's function, contention-free) names pv-0 for all four."""
    import k8s_scheduler_tpu.ops.volumes as ref_vol

    from k8s_scheduler_tpu_torch.ops import volumes

    ref, port, em, tables = _volume_case("two_pvs_4")
    P, V = port.P, port.pv_avail.shape[0]
    accepted = np.asarray(ref.pod_valid).copy()
    node_of = np.zeros(P, np.int32)
    claimed0 = np.zeros(V, bool)
    rank = np.asarray(ref.pod_order).astype(np.int32)
    t, j = torch.from_numpy, jnp.asarray
    keys = volumes.pv_choice_plain(port, tables, t(claimed0), t(node_of), t(accepted))
    assert keys[:4, 0].tolist() == [0, 0, 0, 0]
    got = volumes.pv_fold_plain(port, tables, t(claimed0), t(accepted), t(node_of), t(rank))
    want = ref_vol.fold_pv_claims(ref, em, j(claimed0), j(accepted), j(node_of), j(rank))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[:2].tolist() == [True, True] and int(got.sum()) == 2
    # one pass alone claims only pv-0: the second claim needed a second pass
    one = volumes.chosen_pv(port, tables.req, t(claimed0), t(node_of), t(accepted), 0)
    assert set(one[:4].tolist()) == {0}
    # pv-0, then pv-1, then a pass in which the last two find nothing
    claimed, n_passes = volumes.fold_pv_claims_passes(
        port, tables.req, t(claimed0), t(accepted), t(node_of), t(rank))
    assert torch.equal(claimed, got) and n_passes == 3


# ---- K13 `scan_commit`: its seeded edge cases and its launch shape -------

def test_scan_tags_name_every_case():
    assert tuple(kernel_cases.scan_objects(ref_models)) == kernel_cases.SCAN_TAGS


@functools.cache
def _scan_case(tag):
    """(reference snapshot, port ScanInputs, opts) of one K13 edge case:
    the objects encoded by the reference, cut as the case says, carried to
    the port and packed there (once per case in this file; read-only)."""
    nodes, pods, existing, opts = kernel_cases.scan_objects(ref_models, (tag,))[tag]
    enc = ref_models.SnapshotEncoder(**(
        {"resource_names": opts["resources"]} if "resources" in opts else {}))
    ref = kernel_cases.prepare(enc.encode(nodes, pods, existing), opts)
    return ref, kernel_cases.scan_inputs(_carry(ref), opts), opts


@functools.cache
def _scan_plain(tag):
    """`scan_commit_plain` on one K13 edge case, run once per case in this
    file (two tests read it; read-only)."""
    return scan_commit.scan_commit_plain(_scan_case(tag)[1])


def _reference_scan(ref, x, opts):
    """The reference's greedy_commit with its framework's per-pod hooks
    (jitted) over the packed static base and rank order."""
    import k8s_scheduler_tpu.config as ref_config
    import k8s_scheduler_tpu.ops.commit as ref_commit

    fw = ref_rt.Framework.from_config(kernel_cases.scan_profile(ref_config,
                                                                opts.get("profile")))

    def run(snap, order, sbase):
        ctx = ref_if.CycleContext(snap)
        ctx.matched_pending  # materialised at the trace's own scope, as the cycle does
        return ref_commit.greedy_commit(
            order=order, static_mask=sbase > scan_commit.NEG_INF / 2, static_score=sbase,
            pod_requested=snap.pod_requested, pod_valid=snap.pod_valid,
            pod_nominated=snap.pod_nominated, node_allocatable=snap.node_allocatable,
            node_requested=snap.node_requested,
            dyn_fn=lambda p, nr, ext, row: fw.dyn(ctx, p, nr, ext, row),
            extra=fw.extra_init(ctx),
            update_fn=lambda ext, p, node, ok: fw.extra_update(ctx, ext, p, node, ok))

    return jax.jit(run)(ref, jnp.asarray(x.order.numpy()), jnp.asarray(x.sbase.numpy()))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("tag", kernel_cases.SCAN_TAGS)
def test_scan_plain_edge_cases_match_reference(tag):
    """`scan_commit_plain` (what K13 is held against on the card) on each
    seeded K13 edge case equals the reference's greedy_commit with its
    hooks bit for bit: assignment, requested resources, the port bitmap
    and the four affinity tables."""
    ref, x, opts = _scan_case(tag)
    got = _scan_plain(tag)
    want = _reference_scan(ref, x, opts)
    np.testing.assert_array_equal(got.assignment.numpy(), np.asarray(want.assignment))
    np.testing.assert_array_equal(_bits(got.node_requested.numpy()),
                                  _bits(want.node_requested))
    np.testing.assert_array_equal(got.ports.numpy(), np.asarray(want.extra["NodePorts"]))
    st = want.extra.get("InterPodAffinity")
    if st is not None:
        for f in ("counts", "total", "anti_presence", "pref_sym"):
            np.testing.assert_array_equal(_bits(getattr(got.state, f).numpy()),
                                          _bits(getattr(st, f)), err_msg=f)


@pytest.mark.parametrize("tag", kernel_cases.SCAN_TAGS)
def test_scan_edge_cases_exercise_their_situation(tag):
    """Each K13 edge case sets up what it is named for, under the plain
    scan, on the kernel's 16 CTAs (CTA c owns the slice of ceil(N / 16)
    nodes from c * ceil(N / 16))."""
    _, x, _ = _scan_case(tag)
    res = _scan_plain(tag)
    P, N = x.shape
    ranked = [p for p in x.order.tolist() if x.pod_valid[p]]
    a = res.assignment.tolist()
    placed = [a[p] for p in ranked]
    assert any(n >= 0 for n in placed)
    assert all(a[p] == -1 for p in range(P) if not x.pod_valid[p])
    ns = -(-N // kernel_cases.SCAN_SLICES)
    def _cta(n):
        return kernel_cases.scan_cta(n, N)

    if tag == "N=13":  # one node a CTA: the last three CTAs hold no node
        assert N == 13 < kernel_cases.SCAN_SLICES
    if tag in ("N=8193", "N=16*512+7"):  # ragged: thread 0 of a CTA owns two nodes
        assert N % kernel_cases.SCAN_SLICES != 0 and ns > scan_commit.THREADS
        assert len({_cta(n) for n in placed if n >= 0}) > 2
    if tag == "winner in the last slice":
        assert _cta(placed[0]) == kernel_cases.SCAN_SLICES - 1
    if tag == "equal best scores in two slices":
        assert placed[:2] == [5, 20] and _cta(5) != _cta(20)
    if tag == "-0.0 / +0.0 tie":
        row = x.sbase[ranked[0]]
        assert str(float(row[9])) == "-0.0" and str(float(row[25])) == "0.0"
        assert placed[0] == 9 and x.terms == ()
    if tag == "nominated: another slice, and infeasible":
        nom = x.pod_nominated.tolist()
        assert placed[0] == nom[ranked[0]] == 3  # honoured, though node 30 scores higher
        assert _cta(placed[1]) != _cta(3)  # the argmax, unnominated
        assert nom[ranked[2]] == 4 and placed[2] not in (-1, 4)  # infeasible: argmax
    if tag == "no feasible node":
        assert placed[1] == -1 and placed[2] >= 0
    if tag == "hard spread, minimum in another slice's zone":
        # z2 (nodes 24-31, CTAs 12-15), the minimum, in other CTAs than the
        # counted pods' nodes
        assert placed[0] >= 24 and _cta(placed[0]) not in {_cta(n) for n in (0, 3, 17, 20)}
        assert bool(((x.tsc[..., 0] >= 0) & (x.tsc[..., 2] == 0)).any())
    if tag == "matched selectors counted in another slice's zone":
        zone = x.node_domains[placed[0], 1] if x.node_domains.shape[1] > 1 else None
        assert zone is not None
        later = placed[4:]  # affinity to app w: the zone its +1s went to
        assert all(int(x.node_domains[n, 1]) == int(zone) for n in later)
        assert len({_cta(n) for n in later}) > 1
    if tag == "required affinity bootstrapped by total == 0":
        assert float(x.state.total.sum()) == 0 and placed[0] >= 0
        assert bool(x.aff_self[ranked[0]].any())
    if tag in ("anti-affinity written by one pod and read by the next",
               "host-port conflicts between consecutive pods"):
        assert len(set(placed)) == len(placed) == 4 and -1 not in placed
    if tag == "host-port conflicts between consecutive pods":
        assert int(res.ports.sum()) == 4
    if tag == "pad pods interleaved in order":
        v = x.pod_valid[x.order.long()].tolist()
        assert v[:4] == [True, False, True, False]
    if tag == "R=1":
        assert x.pod_requested.shape[1] == 1
    if tag == "R=8":
        assert x.pod_requested.shape[1] == 8


@pytest.mark.parametrize("N, cluster, slice_, per_thread", [
    (13, 16, 1, 1), (8192, 16, 512, 1), (8193, 16, 513, 2),
    (scan_commit.MAX_NODES, 16, 1024, 2), (8192, 8, 1024, 2),
    (scan_commit.MAX_NODES_PORTABLE, 8, 1024, 2)])
def test_scan_commit_launch_shape(N, cluster, slice_, per_thread):
    """K13's launch without a card: a cluster of 16 CTAs (or the portable
    8) of 512 threads, CTA c owning nodes [c * ns, (c + 1) * ns); config
    #4's shape (R = 4, K = 2, one port, S = 500) fits shared memory, its
    slice's node state far below the 227 KB."""
    W = scan_commit.row_layout(4, 1, 1, 1, 2)["W"]
    shape = scan_commit.launch_shape(N, 4, 2, 1, 500, W, cluster)
    assert (shape["cluster"], shape["slice"], shape["nodes_a_thread"]) == (
        cluster, slice_, per_thread)
    lay = shape["layout"]
    node_bytes = 4 * slice_ * (3 * 4 + 2 + 1)  # [R] x 3, [K], one port word
    assert shape["smem"] <= scan_commit.SMEM_LIMIT
    assert 0 <= shape["smem"] - lay["alloc"] - node_bytes < 5 * 16
    assert lay["alloc"] - lay["total"] >= 500 * 4


@pytest.mark.parametrize("N, cluster", [(scan_commit.MAX_NODES + 1, 16),
                                        (scan_commit.MAX_NODES_PORTABLE + 1, 8)])
def test_scan_commit_refuses_more_nodes_than_a_cluster_holds(N, cluster):
    """Above 1024 nodes a CTA the launch is refused with a ValueError that
    names the limit: 16384 on 16 CTAs, 8192 on the portable 8."""
    W = scan_commit.row_layout(4, 1, 1, 1, 2)["W"]
    with pytest.raises(ValueError, match=f"at most {cluster * 1024} on a cluster of {cluster}"):
        scan_commit.launch_shape(N, 4, 2, 1, 500, W, cluster)


def test_scan_pod_rows_and_order():
    """The wrapper's packing: each pod row holds the pod's operands (and its
    nominated node's domains) where `row_layout` says, the valid pods come
    first in rank order, and the
    pod flags say which pods the kernel may skip an exchange for (no
    preferred term and no matched selector whose preferred-weight row the
    scan ever makes nonzero; no ScheduleAnyway constraint)."""
    _, x, _ = _scan_case("N=13")
    rows = scan_commit.pod_rows(x)
    P, R, MA, MC = x.shape[0], x.pod_requested.shape[1], x.aff_terms.shape[1], x.tsc.shape[1]
    K = x.node_domains.shape[1]
    lay = scan_commit.row_layout(R, x.pod_port_ids.shape[1], MA, MC, K)
    assert rows.shape == (P, lay["W"]) and rows.dtype == torch.int32
    f32 = rows.view(torch.float32)
    assert torch.equal(f32[:, lay["req"]:lay["req"] + R], x.pod_requested)
    assert torch.equal(rows[:, lay["tsc"]:lay["tsc"] + 3 * MC], x.tsc.reshape(P, -1))
    assert torch.equal(rows[:, lay["nom"]], x.pod_nominated)
    nom = x.pod_nominated
    assert bool((nom >= 0).any())
    assert torch.equal(rows[nom >= 0, lay["nomdom"]:lay["nomdom"] + K],
                       x.node_domains[nom[nom >= 0].long()])
    assert torch.equal(rows[:, lay["p"]], torch.arange(P, dtype=torch.int32))
    nsel = x.sel_ptr[1:] - x.sel_ptr[:-1]
    assert torch.equal(rows[:, lay["nsel"]], nsel) and int(nsel.max()) >= 1
    for p in range(P):
        want = x.sel_list[int(x.sel_ptr[p]):int(x.sel_ptr[p + 1])].tolist()[:scan_commit.POD_SELS]
        got = rows[p, lay["sels"]:lay["sels"] + scan_commit.POD_SELS].tolist()
        assert got == want + [-1] * (scan_commit.POD_SELS - len(want))
    vorder, nv = scan_commit.valid_order(x)
    ranked = [p for p in x.order.tolist() if x.pod_valid[p]]
    assert int(nv) == len(ranked) and vorder[:len(ranked)].tolist() == ranked
    flags = rows[:, lay["flags"]]
    final = _scan_plain("N=13").state
    has_pref = (x.pref_terms[..., 0] >= 0).any(1)
    soft = ((x.tsc[..., 0] >= 0) & (x.tsc[..., 2] == 1)).any(1)
    hard = ((x.tsc[..., 0] >= 0) & (x.tsc[..., 2] == 0)).any(1)
    assert torch.equal((flags & scan_commit.POD_HARD) > 0, hard)
    assert torch.equal((flags & scan_commit.POD_SPR_NORM) > 0, soft)
    for p in range(P):
        sels = x.sel_list[int(x.sel_ptr[p]):int(x.sel_ptr[p + 1])].long()
        if not flags[p] & scan_commit.POD_AFF_NORM:
            assert not has_pref[p] and not bool(final.pref_sym[sels].any())
    assert bool((flags & scan_commit.POD_AFF_NORM).any()) and bool(
        ((flags & scan_commit.POD_AFF_NORM) == 0).any())
