"""The plain torch versions of the port's hand-written kernels against the
reference expressions they replace (the kernels themselves are held
against these plain versions on the card by chip_smoke.py).

- K1 `static_base_plain` against where(static_lean mask, clip(score),
  NEG_INF) from the JAX framework, alone and with node sampling and the
  fit filter folded in: masks bit-equal, values within atol 1e-3.
- K2 `claim_pass_plain` against the reference's pass body (round + u32
  hash tie-break + argmax_first + nominated override), across dead,
  accepted, nominated and anchor-delta states: bit-equal.
- K5 `capacity_plain` against the reference's resolve_capacity body (f32
  cumsum prefix, one-hot product fold) and the revocation fold, on sorted
  claims with long per-node runs: bit-equal.
- K6 `guard_sweep_plain` against the reference's `_seg_scan_tables` sweep
  and its per-role tests over random participant tables with every role,
  and against a sequential per-entry count: bit-equal.
- On CPU tensors the dispatching wrappers run the plain versions and
  launch nothing."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k8s_scheduler_tpu.core.cycle as ref_cycle
import k8s_scheduler_tpu.framework.interfaces as ref_if
import k8s_scheduler_tpu.framework.runtime as ref_rt
import k8s_scheduler_tpu.ops.argsel as ref_argsel
import k8s_scheduler_tpu.ops.resources as ref_res
import k8s_scheduler_tpu.ops.rounds as ref_rounds
from k8s_scheduler_tpu_torch.core.cycle import sampling_window
from k8s_scheduler_tpu_torch.framework.interfaces import CycleContext
from k8s_scheduler_tpu_torch.framework.runtime import Framework
from k8s_scheduler_tpu_torch.models.encoding import AUX_FIELDS, snapshot_from_numpy
from k8s_scheduler_tpu_torch.ops import (capacity, claim_pass, guard_sweep,
                                         interpod_terms, kernel_build, static_base)
from test_torch_encoding import reference_snapshot

SBASE_ATOL = 1e-3  # f32 static-base values (observed: exact)


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
    np.testing.assert_allclose(got, want, rtol=0, atol=SBASE_ATOL)


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
    assert set(kernel_build.launch_counts) == {
        "static_base", "claim_pass", "interpod_terms", "interpod_norm",
        "affinity_update", "capacity", "guard_sweep"}
    assert all(v == 0 for v in kernel_build.launch_counts.values())


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
