"""The plain torch versions of the port's hand-written kernels against the
reference expressions they replace (the kernels themselves are held
against these plain versions on the card by chip_smoke.py).

- K1 `static_base_plain` against where(static_lean mask, clip(score),
  NEG_INF) from the JAX framework, alone and with node sampling and the
  fit filter folded in: masks bit-equal, values within atol 1e-3.
- K2 `claim_pass_plain` against the reference's pass body (round + u32
  hash tie-break + argmax_first + nominated override), across dead,
  accepted, nominated and anchor-delta states: bit-equal.
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
from k8s_scheduler_tpu_torch.ops import claim_pass, kernel_build, static_base
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
    assert kernel_build.launch_counts == {"static_base": 0, "claim_pass": 0}


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
