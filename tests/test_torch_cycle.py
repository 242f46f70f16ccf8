"""The port's rounds-engine latency cycle against the reference's.

`build_cycle_fn(commit_mode="rounds", outputs="latency", device="cpu")`
must give assignment, node_requested, unschedulable and gang_dropped
bit-equal to the reference on every fixture: the synthetic configs #1,
#2 and #5 (a gang that unwinds), hostPort contention that only the guard
sweep resolves, nominated pods, node sampling on clusters past the
100-node floor, and resource scores averaged over three or four
resources. The reference's own validity oracle holds the port's
placements too. `build_cycle_fn()` runs the reference's default engine,
the scan, and its default outputs, the full ones (ROADMAP C5). Engines the
port does not cover yet raise NotImplementedError; entry points never run
on the CPU unasked; the port imports nothing of JAX or the JAX package."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import k8s_scheduler_tpu.core.cycle as ref_cycle
import k8s_scheduler_tpu.models as ref_models
import k8s_scheduler_tpu.utils.synth as ref_synth
from k8s_scheduler_tpu import oracle
from k8s_scheduler_tpu_torch.core.cycle import build_cycle_fn
from k8s_scheduler_tpu_torch.models.encoding import AUX_FIELDS, snapshot_from_numpy
from test_torch_encoding import fixture

REPO = Path(__file__).resolve().parents[1]


def _hostport_contention(m):
    """20 pods want hostPort 7000 on 6 roomy nodes: capacity accepts every
    claim, so only the round-end guard sweep keeps one pod per node."""
    nodes = [m.MakeNode(f"h{i}").capacity({"cpu": "64", "memory": "64Gi"}).obj()
             for i in range(6)]
    pods = [m.MakePod(f"q{j}").req({"cpu": "1"}).host_port(7000).created(float(j)).obj()
            for j in range(20)]
    return nodes, pods, [], []


def _sampled(m):
    nodes = m.make_cluster(300, taint_fraction=0.1, cpu_choices=(4, 8, 16))
    existing = [(p, f"node-{i}") for i, p in enumerate(
        m.make_pods(300, seed=991, name_prefix="run"))]  # within capacity
    pods = m.make_pods(900, seed=7, selector_fraction=0.5, toleration_fraction=0.4)
    return nodes, pods, existing, []


def ref_objects(name):
    if name == "hostport":
        return _hostport_contention(ref_models)
    if name == "sampled":
        return _sampled(ref_synth)
    return fixture(name, ref_models, ref_synth)


CASES = {
    # name: (fixture, build_cycle_fn kwargs)
    "cfg1": ("cfg1", {}),
    "cfg2": ("cfg2", {}),
    "cfg5_gang_unwind": ("cfg5", {}),
    "mixed_ports_nominated": ("mixed", {}),
    "nominated": ("nominated", {}),
    "hostport_guard": ("hostport", {}),
    "hostport_guard_one_pass": ("hostport", {
        "max_rounds": 1, "rounds_kw": {"passes_round0": 1}}),
    "sampled_adaptive": ("sampled", {}),
    "sampled_pct30": ("sampled", {"percentage_of_nodes_to_score": 30}),
    # ROADMAP C1's seeded input under profiles that average the resource
    # scores over three or four resources
    "c1_three_resources": ("c1", {"profile": "three_resources"}),
    "c1_four_resources": ("c1", {"profile": "four_resources"}),
    # ... and the fit score over three resources as the one dynamic score:
    # a bare product the round's base add fuses (ROADMAP C3)
    "c1_fit_three_static": ("c1", {"profile": "fit_three_static"}),
}


def run_both(name, kw):
    nodes, pods, existing, groups = ref_objects(name)
    ref_snap = ref_models.SnapshotEncoder().encode(nodes, pods, existing, groups)
    ref_kw, port_kw = dict(kw), dict(kw)
    profile = kw.get("profile")
    if profile is not None:
        import k8s_scheduler_tpu.config as ref_config
        import k8s_scheduler_tpu.framework.runtime as ref_runtime
        import k8s_scheduler_tpu_torch.config as port_config
        from k8s_scheduler_tpu_torch.framework.runtime import Framework
        from test_torch_commit import _profile

        del ref_kw["profile"], port_kw["profile"]
        ref_kw["framework"] = ref_runtime.Framework.from_config(_profile(ref_config, profile))
        port_kw["framework"] = Framework.from_config(_profile(port_config, profile))
    want = ref_cycle.build_cycle_fn(commit_mode="rounds", outputs="latency", **ref_kw)(ref_snap)
    port_snap = snapshot_from_numpy(
        ref_snap.array_fields(), {k: getattr(ref_snap, k) for k in AUX_FIELDS},
        device="cpu",
    )
    got = build_cycle_fn(commit_mode="rounds", outputs="latency", device="cpu",
                         **port_kw)(port_snap)
    return (nodes, pods, existing), want, got


@pytest.mark.parametrize("case", list(CASES))
def test_cycle_bit_equal_to_reference(case):
    name, kw = CASES[case]
    (nodes, pods, existing), want, got = run_both(name, kw)
    for field in ("assignment", "node_requested", "unschedulable", "gang_dropped"):
        w = np.asarray(getattr(want, field))
        g = getattr(got, field).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)

    a = got.assignment.numpy()[: len(pods)]
    if case == "cfg5_gang_unwind":
        assert got.gang_dropped.any(), "the gang fixture must unwind a group"
    if case.startswith("hostport"):
        placed = a[a >= 0]
        assert len(placed) == len(set(placed.tolist())) > 0  # one pod per node
        if case == "hostport_guard_one_pass":
            # one pass, one round: 20 live claims on 6 nodes; the guard
            # sweep revoked all but the first claimant of each node
            assert len(placed) <= 6
    if case.startswith("sampled"):
        assert int(np.asarray(want.assignment >= 0).sum()) > 0
    # a gang unwind frees capacity the rounds handed out, so after one
    # any unplaced pod may have become feasible
    unwound = bool(got.gang_dropped.any())
    violations = oracle.validate_rounds_assignment(
        nodes, pods, a, existing,
        round_cap_hit=case == "hostport_guard_one_pass",
        allow_feasible_unplaced=np.flatnonzero(a < 0) if unwound else (),
    )
    if kw.get("percentage_of_nodes_to_score", 0) < 100 and len(nodes) >= 100:
        # sampling may leave a pod unplaced that a node outside its
        # window could take; the oracle does not model the window
        violations = [v for v in violations if "feasible" not in v]
    # running pods that overcommit a node before the cycle (C1's seeded
    # input) are the input's, reported alike with nothing placed
    before = oracle.validate_rounds_assignment(nodes, pods, np.full(len(pods), -1),
                                               existing)
    violations = [v for v in violations if not ("over capacity" in v and v in before)]
    assert violations == []


@pytest.mark.parametrize("feature", ["bound_pvc", "unbound_pvc"])
def test_cycle_raises_on_uncovered_features(feature):
    """A snapshot with a volume claim schedules through VolumeBinding in
    both engines, bit-equal to the reference's engine of the same name (the
    scan through VolumeBinding's per-pod hooks), and its full outputs
    decide alike."""
    from k8s_scheduler_tpu.models.api import (PersistentVolume,
                                              PersistentVolumeClaim, StorageClass)

    bound = feature == "bound_pvc"
    pvc = PersistentVolumeClaim("data", storage_class="fast", request=1.0,
                                volume_name="pv0" if bound else "")
    pv = PersistentVolume("pv0", capacity=2.0, storage_class="fast",
                          claim_ref="default/data" if bound else "")
    ref_snap = ref_models.SnapshotEncoder().encode(
        ref_synth.make_cluster(8),
        [ref_models.MakePod("p").req({"cpu": "1"}).volume("data").obj()],
        pvcs=[pvc], pvs=[pv], storage_classes=[StorageClass("fast")],
    )
    port_snap = snapshot_from_numpy(
        ref_snap.array_fields(), {k: getattr(ref_snap, k) for k in AUX_FIELDS},
        device="cpu",
    )
    assert port_snap.has_volumes
    want = ref_cycle.build_cycle_fn(commit_mode="rounds", outputs="latency")(ref_snap)
    got = build_cycle_fn(commit_mode="rounds", outputs="latency", device="cpu")(port_snap)
    np.testing.assert_array_equal(got.assignment.numpy(), np.asarray(want.assignment))
    # bound: placed on any node (the PV has no affinity); unbound Immediate
    # claim: unschedulable
    assert (int(got.assignment[0]) >= 0) == bound
    want_s = ref_cycle.build_cycle_fn(commit_mode="scan", outputs="latency")(ref_snap)
    got_s = build_cycle_fn(commit_mode="scan", outputs="latency", device="cpu")(port_snap)
    for f in ("assignment", "node_requested", "unschedulable", "gang_dropped"):
        np.testing.assert_array_equal(getattr(got_s, f).numpy(), np.asarray(getattr(want_s, f)),
                                      err_msg=f)
    assert (int(got_s.assignment[0]) >= 0) == bound
    full = build_cycle_fn(commit_mode="rounds", outputs="full", device="cpu")(port_snap)
    assert torch.equal(full.assignment, got.assignment)
    assert full.reject_counts.shape == (port_snap.P, 9)
    assert full.pv_claimed.shape == port_snap.pv_avail.shape


# fixtures where the scan and rounds engines place differently (the
# reference's scan and rounds assignments differ on 52 of cfg1's 60 pods,
# 3 of nominated's 11 and 7 of hostport's 20)
@pytest.mark.parametrize("name", ["cfg1", "nominated", "hostport"])
def test_default_engine_is_the_reference_default(name):
    """ROADMAP C5: `build_cycle_fn()` places as the reference's
    `build_cycle_fn()` does, the scan engine in both packages."""
    nodes, pods, existing, groups = ref_objects(name)
    ref_snap = ref_models.SnapshotEncoder().encode(nodes, pods, existing, groups)
    want = ref_cycle.build_cycle_fn(outputs="latency")(ref_snap)
    rounds = ref_cycle.build_cycle_fn(commit_mode="rounds", outputs="latency")(ref_snap)
    assert not np.array_equal(np.asarray(want.assignment), np.asarray(rounds.assignment))
    port_snap = snapshot_from_numpy(
        ref_snap.array_fields(), {k: getattr(ref_snap, k) for k in AUX_FIELDS},
        device="cpu",
    )
    got = build_cycle_fn(outputs="latency", device="cpu")(port_snap)
    for field in ("assignment", "node_requested", "unschedulable", "gang_dropped"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)


def test_build_cycle_fn_defaults_match_reference():
    """Every parameter the two `build_cycle_fn`s share has the same
    default, `outputs` ("full") included (ROADMAP C5)."""
    import inspect

    ref = inspect.signature(ref_cycle.build_cycle_fn).parameters
    port = inspect.signature(build_cycle_fn).parameters
    shared = [k for k in ref if k in port]
    assert shared == ["framework", "gang_scheduling", "commit_mode", "max_rounds",
                      "percentage_of_nodes_to_score", "rounds_kw", "outputs"]
    for k in shared:
        assert port[k].default == ref[k].default, k
    assert port["outputs"].default == "full"


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    """Without a card, an entry point called without `device` raises
    instead of running on the CPU."""
    from k8s_scheduler_tpu_torch.models import SnapshotEncoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_cycle_fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SnapshotEncoder()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_cycle_fn(device="cuda")


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module)
    return out


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "k8s_scheduler_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "k8s_scheduler_tpu"), (f, mod)


def test_chip_smoke_refuses_to_run_without_cuda():
    """No card: a non-zero exit and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
