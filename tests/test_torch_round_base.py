"""The rounds engine's claim base, `base = vsbase + score` from
`Framework.dyn_batched`, against the reference's round program
(`k8s_scheduler_tpu/ops/rounds.py:581`), jitted as the round jits it, bit
for bit before the claim pass rounds it.

The profiles are those where the dynamic score sum can be one bare
product that the compiled add may fuse: BalancedAllocation as the one
dynamic score, the fit score over three resources as the one dynamic
score (a weight sum of 3, whose reciprocal is inexact), and both scores
over three resources (`test_torch_commit._profile`'s `balanced_static`,
`fit_three_static` and `three_resources`)."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import k8s_scheduler_tpu.config as ref_config
import k8s_scheduler_tpu.framework.interfaces as ref_if
import k8s_scheduler_tpu.framework.runtime as ref_rt
import k8s_scheduler_tpu_torch.config as port_config
from k8s_scheduler_tpu_torch.framework.interfaces import CycleContext
from k8s_scheduler_tpu_torch.framework.runtime import Framework
from k8s_scheduler_tpu_torch.models.encoding import AUX_FIELDS, snapshot_from_numpy
from k8s_scheduler_tpu_torch.ops import rounds, static_base
from test_torch_commit import _profile
from test_torch_encoding import reference_snapshot

@pytest.mark.parametrize("fixture", ["cfg2", "c1"])
@pytest.mark.parametrize("profile", ["balanced_static", "fit_three_static",
                                     "three_resources"])
def test_round_base_matches_reference_round_program(fixture, profile):
    ref = reference_snapshot(fixture)
    port = snapshot_from_numpy(
        ref.array_fields(), {k: getattr(ref, k) for k in AUX_FIELDS}, device="cpu"
    )
    rfw = ref_rt.Framework.from_config(_profile(ref_config, profile))
    fw = Framework.from_config(_profile(port_config, profile))
    ctx = CycleContext(port)
    vsbase = static_base.static_base_plain(static_base.static_base_inputs(fw, ctx))
    vsmask = vsbase > rounds.NEG_INF * 0.5
    assert bool((vsbase[vsmask] != 0).any())  # the static scores are on

    def ref_base(s, vsbase):
        c = ref_if.CycleContext(s)
        _, score, _ = rfw.dyn_batched(c, s.node_requested, rfw.extra_init(c),
                                      vsbase > rounds.NEG_INF * 0.5)
        return vsbase + score

    want = np.asarray(jax.jit(ref_base)(ref, vsbase.numpy()))
    _, got = fw.dyn_batched(ctx, port.node_requested, fw.extra_init(ctx), vsbase)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
