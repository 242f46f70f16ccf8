"""The port's scenario fuzzer (`fuzz/trace.py`, `shrink.py`, `corpus.py`)
and its refusals, against the reference's `fuzz/`.

- The generator gives the reference's traces, dict for dict, over a band of
  seeds and every generator axis; traces round-trip through dicts and
  files; materialized objects encode to the reference's codec dicts.
- The shrinker reaches the reference's minimum on the synthetic checkers
  and preserves the failure class; its input is not mutated.
- The committed corpus loads to the reference's artifacts.
- The modes ported since run clean: `via_api` / `run_api_case` /
  `compare_via_api` (the gRPC shim), multi-cycle, speculative and
  multi-cycle incremental traces and `compare_speculative`.
- Every mode the port waits for raises a refusal naming its ROADMAP item:
  sharded traces (A13), tenant traces, `run_tenant_case` and the
  `tenant_row_skew` bug (A12); rounds traces are refused as in the
  reference; `engine_bug` patches and restores.
Every comparison is exact."""

from __future__ import annotations

import copy
import glob
import os

import pytest

import k8s_scheduler_tpu.fuzz as ref_fuzz
import k8s_scheduler_tpu.fuzz.trace as ref_trace
import k8s_scheduler_tpu.state.codec as ref_codec
import k8s_scheduler_tpu_torch.fuzz as fuzz
import k8s_scheduler_tpu_torch.fuzz.replay as replay
import k8s_scheduler_tpu_torch.fuzz.trace as trace_mod
import k8s_scheduler_tpu_torch.ops.kernel_build as kb
import k8s_scheduler_tpu_torch.state.codec as port_codec
from torch_one_thread import one_torch_thread  # noqa: F401

CORPUS_DIR = os.path.join(os.path.dirname(__file__), "corpus")
AXES = {
    "default": {},
    "plain": {"multi_cycle": False},
    "chaos": {"chaos": True, "multi_cycle": False},
    "multi_cycle": {"multi_cycle": True},
    "speculative": {"speculative": True},
    "incremental": {"incremental": True},
    "sharded": {"devices": 4},
}


@pytest.mark.parametrize("axis", sorted(AXES))
@pytest.mark.parametrize("seed", range(0, 40, 3))
def test_generator_gives_the_reference_traces(axis, seed):
    kw = AXES[axis]
    assert fuzz.trace_to_dict(fuzz.generate_trace(seed, **kw)) == ref_fuzz.trace_to_dict(
        ref_fuzz.generate_trace(seed, **kw))


@pytest.mark.parametrize("seed", range(6))
def test_multitenant_generator_gives_the_reference_traces(seed):
    assert fuzz.trace_to_dict(fuzz.generate_multitenant_trace(seed)) == ref_fuzz.trace_to_dict(
        ref_fuzz.generate_multitenant_trace(seed))


def test_trace_roundtrips(tmp_path):
    t = fuzz.generate_trace(11, chaos=True)
    d = fuzz.trace_to_dict(t)
    assert fuzz.trace_to_dict(fuzz.trace_from_dict(d)) == d
    p = str(tmp_path / "t.json")
    trace_mod.save_trace(p, t)
    assert fuzz.trace_to_dict(trace_mod.load_trace(p)) == d
    # the port's file reads back in the reference, and the other way round
    assert ref_fuzz.trace_to_dict(ref_trace.load_trace(p)) == d
    ref_trace.save_trace(p, ref_fuzz.generate_trace(11, chaos=True))
    assert fuzz.trace_to_dict(trace_mod.load_trace(p)) == d


@pytest.mark.parametrize("seed", [0, 1, 5, 9])
def test_materialized_objects_match_reference(seed):
    t, rt = fuzz.generate_trace(seed), ref_fuzz.generate_trace(seed)
    po, ro = trace_mod.materialize(t), ref_trace.materialize(rt)
    assert [port_codec.node_to_state(n) for n in po["nodes"]] == [
        ref_codec.node_to_state(n) for n in ro["nodes"]]
    for key in ("pvs", "pvcs", "storage_classes", "pdbs", "pod_groups"):
        assert len(po[key]) == len(ro[key]), key
        assert [repr(x) for x in po[key]] == [repr(x) for x in ro[key]], key
    for evs, revs in zip(t.cycles, rt.cycles):
        for raw, rraw in zip(evs, revs):
            ev, rev = trace_mod.materialize_event(raw), ref_trace.materialize_event(rraw)
            assert ev["op"] == rev["op"]
            if "pod" in ev:
                assert port_codec.pod_to_state(ev["pod"]) == ref_codec.pod_to_state(rev["pod"])


# ---- shrinker units (synthetic checkers: no engine) ----------------------


def _poison_check(trace):
    for ci, evs in enumerate(trace.cycles):
        for ev in evs:
            if ev.get("op") == "add_pod" and ev["pod"].get("s", {}).get("pri") == 10:
                return fuzz.Failure("synthetic/poison", ci, "poison present")
    return None


def _ref_poison_check(trace):
    f = _poison_check(trace)
    return None if f is None else ref_fuzz.Failure(f.cls, f.cycle, f.detail)


def _seeded_poisoned_trace(gen):
    for seed in range(100):
        t = gen(seed, multi_cycle=False)
        if _poison_check(t) is not None:
            return t
    raise AssertionError("no seed in range produced a priority-10 pod")


@pytest.mark.parametrize("max_evals", [50, 3000])
def test_shrinker_reaches_the_reference_minimum(max_evals):
    t = _seeded_poisoned_trace(fuzz.generate_trace)
    rt = _seeded_poisoned_trace(ref_fuzz.generate_trace)
    mint, minf = fuzz.shrink_trace(t, _poison_check(t), _poison_check, max_evals=max_evals)
    rmint, rminf = ref_fuzz.shrink_trace(rt, _ref_poison_check(rt), _ref_poison_check,
                                         max_evals=max_evals)
    assert fuzz.trace_to_dict(mint) == ref_fuzz.trace_to_dict(rmint)
    assert (minf.cls, minf.cycle) == (rminf.cls, rminf.cycle)
    if max_evals == 3000:
        assert len(mint.nodes) == 1 and len(mint.cycles) == 1
        assert sum(len(evs) for evs in mint.cycles) == 1


def test_shrinker_preserves_the_failure_class():
    t = _seeded_poisoned_trace(fuzz.generate_trace)

    def two_class_check(trace):
        base = _poison_check(trace)
        if base is None:
            return None
        if len(trace.nodes) >= 3:
            return fuzz.Failure("synthetic/big", base.cycle, "poison, >=3 nodes")
        return fuzz.Failure("synthetic/small", base.cycle, "poison, <3 nodes")

    f = two_class_check(t)
    assert f.cls == "synthetic/big"
    mint, minf = fuzz.shrink_trace(t, f, two_class_check, max_evals=3000)
    assert minf.cls == "synthetic/big" and len(mint.nodes) == 3


def test_shrinker_input_is_not_mutated():
    t = _seeded_poisoned_trace(fuzz.generate_trace)
    before = copy.deepcopy(fuzz.trace_to_dict(t))
    fuzz.shrink_trace(t, _poison_check(t), _poison_check, max_evals=500)
    assert fuzz.trace_to_dict(t) == before


# ---- corpus format --------------------------------------------------------


CORPUS = sorted(glob.glob(os.path.join(CORPUS_DIR, "*.json")))


@pytest.mark.parametrize("path", CORPUS, ids=os.path.basename)
def test_corpus_loads_as_the_reference(path):
    a, b = ref_fuzz.load_artifact(path), fuzz.load_artifact(path)
    assert fuzz.trace_to_dict(b["trace"]) == ref_fuzz.trace_to_dict(a["trace"])
    assert (b["bug"], b["note"], b["failure"].cls, b["failure"].cycle) == (
        a["bug"], a["note"], a["failure"].cls, a["failure"].cycle)


def test_saved_artifact_reloads(tmp_path):
    t = fuzz.generate_trace(1, multi_cycle=False)
    p = str(tmp_path / "a.json")
    fuzz.save_artifact(p, t, fuzz.Failure("divergence/binds", 0, "x"), bug="tiebreak",
                       note="n")
    a, b = ref_fuzz.load_artifact(p), fuzz.load_artifact(p)
    assert fuzz.trace_to_dict(b["trace"]) == ref_fuzz.trace_to_dict(a["trace"])
    assert b["bug"] == "tiebreak" and b["failure"] == fuzz.Failure("divergence/binds", 0, "x")


# ---- refusals ------------------------------------------------------------


def _refused(fn, item):
    with pytest.raises(NotImplementedError) as ei:
        fn()
    assert f"ROADMAP {item}" in str(ei.value)


def test_via_api_modes_are_refused():
    """Ported with the gRPC shim (the name is kept from when the modes were
    refused): arrivals through Submit / NodeChurn give the direct engine's
    records, cycle by cycle."""
    t = fuzz.generate_trace(1, multi_cycle=False)
    api = fuzz.replay_engine(t, via_api=True, device="cpu")
    direct = fuzz.replay_engine(t, device="cpu")
    assert api.failures == [] and replay.compare_via_api(api, direct) == []
    assert api.records == direct.records and api.binds
    assert fuzz.run_api_case(t, device="cpu") == []


@pytest.mark.parametrize("kw", [{"multi_cycle": True}, {"speculative": True},
                                {"incremental": True}])
def test_multicycle_traces_are_refused(kw):
    """Ported with multi-cycle dispatch (the name is kept from when these
    traces were refused): each variant runs clean, and the multi-cycle
    engine's flattened streams equal the oracle's."""
    t = fuzz.generate_trace(2, **kw)
    assert int(t.config["multi_cycle_k"]) == 4
    assert fuzz.run_case(t, device="cpu") == []
    eng = fuzz.replay_engine(t, device="cpu")
    assert replay.compare(t, eng, fuzz.replay_oracle(t)) == []
    assert replay.compare_speculative(eng, eng) == []


def test_sharded_traces_are_refused():
    t = fuzz.generate_trace(3, devices=4, multi_cycle=False)
    _refused(lambda: fuzz.run_case(t, device="cpu"), "A13")


def test_tenant_modes_are_refused():
    art = os.path.join(CORPUS_DIR, "tenant_row_skew_cross_leak.json")
    _refused(lambda: fuzz.replay_artifact(art, device="cpu"), "A12")
    _refused(lambda: fuzz.replay_artifact(art, with_bug=True, device="cpu"), "A12")
    t = fuzz.generate_multitenant_trace(0)
    _refused(lambda: fuzz.run_tenant_case(t), "A12")
    _refused(lambda: fuzz.run_case(t, device="cpu"), "A12")

    def bugged():
        with fuzz.engine_bug("tenant_row_skew"):
            pass

    _refused(bugged, "A12")


def test_replay_refuses_rounds_mode():
    t = fuzz.generate_trace(0, multi_cycle=False)
    t.config["commit_mode"] = "rounds"
    with pytest.raises(ValueError, match="scan"):
        fuzz.replay_engine(t, device="cpu")
    with pytest.raises(ValueError, match="scan"):
        fuzz.replay_oracle(t)


def test_engine_bug_patch_restores():
    from k8s_scheduler_tpu_torch.ops import argsel

    orig = argsel.argmax_first
    with fuzz.engine_bug("tiebreak"):
        assert argsel.argmax_first is not orig and kb.TIE_LAST
    assert argsel.argmax_first is orig and not kb.TIE_LAST
    with pytest.raises(ValueError):
        with fuzz.engine_bug("not_a_bug"):
            pass


def test_last_max_argmax_matches_the_reference_mutation():
    """The bug's argmax (last index of the maximum) against a numpy model
    of the reference's `argmax_last`."""
    import numpy as np
    import torch

    from k8s_scheduler_tpu_torch.ops import argsel

    rng = np.random.default_rng(5)
    x = rng.integers(0, 4, size=(7, 33)).astype(np.float32)
    with fuzz.engine_bug("tiebreak"):
        for dim in (0, 1, -1):
            got = argsel.argmax_first(torch.from_numpy(x), dim=dim).numpy()
            m = x.max(axis=dim, keepdims=True)
            idx = np.arange(x.shape[dim]).reshape([-1 if a == dim % 2 else 1
                                                   for a in range(2)])
            want = np.where(x == m, idx, -1).max(axis=dim)
            assert (got == want).all()
