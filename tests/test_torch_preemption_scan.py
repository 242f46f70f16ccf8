"""DefaultPreemption after the scan engine's cycle, against the reference's.

The port's `build_preemption_fn(device="cpu")` on the decision of its
`build_cycle_fn(commit_mode="scan")` must give `nominated`, `victims` and
`num_preemptors` bit-equal to the reference's `build_preemption_fn` on
the decision of its `build_cycle_fn(commit_mode="scan",
outputs="latency")` — the decisions themselves bit-equal first. The
preemption pass needs no scan-specific code: it reads the decision's
assignment, requested state and gang drops, whichever engine made them.
Fixtures: every case of test_torch_preemption (tests/test_preemption.py,
tests/test_preemption_whatif.py, config #4-shaped synthetic workloads
with and without PDBs, the prefix-sum order, the i32 wrap, crowded
nodes) and the gang case of tests/test_gang.py whose dropped members must
not preempt."""

from __future__ import annotations

import numpy as np
import pytest

import k8s_scheduler_tpu.core.cycle as ref_cycle
import k8s_scheduler_tpu.framework.runtime as ref_runtime
import k8s_scheduler_tpu.models as ref_models
from k8s_scheduler_tpu_torch.core.cycle import build_cycle_fn, build_preemption_fn
from k8s_scheduler_tpu_torch.framework.runtime import Framework
from test_torch_cycle_scan import FIXTURES as CYCLE_FIXTURES
from test_torch_cycle_scan import assert_same
from test_torch_interpod import carry
from test_torch_preemption import (_WHATIF, FIXTURES, PORT, REF, _framework_config,
                                   assert_same_result)


def run_both(name):
    if name == "gang_dropped_preempt":
        nodes, pods, existing, groups = CYCLE_FIXTURES[name]()
        ref_snap = ref_models.SnapshotEncoder().encode(nodes, pods, existing, groups)
    else:
        nodes, pods, existing, pdbs = FIXTURES[name](REF)
        enc_kw = {"pad_pods": 16, "pad_nodes": 8} if name in _WHATIF else {}
        ref_snap = ref_models.SnapshotEncoder(**enc_kw).encode(nodes, pods, existing,
                                                               pdbs=pdbs)
    ref_fw = ref_runtime.Framework.from_config(_framework_config(REF, None))
    want_dec = ref_cycle.build_cycle_fn(framework=ref_fw, commit_mode="scan",
                                        outputs="latency")(ref_snap)
    want = ref_cycle.build_preemption_fn(ref_fw)(ref_snap, want_dec)
    port_snap = carry(ref_snap)
    fw = Framework.from_config(_framework_config(PORT, None))
    got_dec = build_cycle_fn(framework=fw, commit_mode="scan", device="cpu")(port_snap)
    assert_same(got_dec, want_dec)
    got = build_preemption_fn(framework=fw, device="cpu")(port_snap, got_dec)
    return got, want, got_dec, pods


@pytest.mark.parametrize("name", list(FIXTURES) + ["gang_dropped_preempt"])
def test_preemption_after_scan_bit_equal_to_reference(name):
    got, want, dec, pods = run_both(name)
    assert_same_result(got, want)
    if name in ("cfg4_tight_pdbs", "nondyadic", "i32_wrap", "basic"):
        assert int(got.num_preemptors) > 0  # the fixture exercises preemption
    nom = got.nominated.numpy()
    # nominations only for pods the scan left unplaced and did not drop
    unplaced = dec.unschedulable.numpy() & ~dec.gang_dropped.numpy()
    assert not ((nom >= 0) & ~unplaced).any()
    if name == "gang_dropped_preempt":
        dropped = dec.gang_dropped.numpy()[: len(pods)]
        assert dropped.any() and (nom[: len(pods)][dropped] == -1).all()
