"""The port's trace replay (`fuzz/replay.py`) and its copy of the oracle
(`oracle.py`) against the reference's.

- The port's `replay_oracle` gives the reference's `ReplayResult` (every
  per-cycle record, failure, bind and stat) on a band of seeds; the
  oracle's `schedule_cycle_trace` equals the reference's on each trace's
  first cycle.
- The port's `replay_engine` (its `Scheduler` on the CPU, the plain
  versions) gives the reference engine's records on the two clean corpus
  traces.
- Both clean corpus files replay clean; the tiebreak file, replayed with
  its bug, fails with its recorded class (`divergence/binds`).
- Seeded `run_case` traces — plain, durable (a state directory), chaos
  with a state directory, and incremental (the carry path's delta encode
  against a full encode every frame) — give zero failures, and the
  incremental sweep takes the delta path.
Every comparison is exact."""

from __future__ import annotations

import dataclasses
import os

import pytest

import k8s_scheduler_tpu.fuzz as ref_fuzz
import k8s_scheduler_tpu.fuzz.replay as ref_replay
import k8s_scheduler_tpu.oracle as ref_oracle
import k8s_scheduler_tpu_torch.fuzz as fuzz
import k8s_scheduler_tpu_torch.fuzz.replay as replay
import k8s_scheduler_tpu_torch.oracle as oracle
from k8s_scheduler_tpu_torch.fuzz.trace import materialize as port_materialize
from k8s_scheduler_tpu.fuzz.trace import materialize as ref_materialize
from torch_one_thread import one_torch_thread  # noqa: F401

CORPUS_DIR = os.path.join(os.path.dirname(__file__), "corpus")
CLEAN = ("attribution_static_dyn_split", "tiebreak_argmax_last")


@pytest.fixture(autouse=True)
def _strikes():
    """A chaos trace's device errors count in the process-wide strike
    table, which other files' Schedulers report: leave it as found."""
    from k8s_scheduler_tpu_torch.core import cycle

    before = dict(cycle.RESILIENT_STRIKES)
    yield
    cycle.RESILIENT_STRIKES.clear()
    cycle.RESILIENT_STRIKES.update(before)


def _result(r):
    return (r.records, [str(f) for f in r.failures], r.binds, r.stats)


@pytest.mark.parametrize("seed", range(12))
def test_oracle_replay_matches_reference(seed):
    t = fuzz.generate_trace(seed, multi_cycle=False)
    rt = ref_fuzz.generate_trace(seed, multi_cycle=False)
    assert _result(replay.replay_oracle(t)) == _result(ref_replay.replay_oracle(rt))


@pytest.mark.parametrize("seed", [0, 4, 7])
def test_oracle_first_cycle_matches_reference(seed):
    t = fuzz.generate_trace(seed, multi_cycle=False)
    outs = []
    for mat, orc, tr in ((port_materialize, oracle, t),
                         (ref_materialize, ref_oracle,
                          ref_fuzz.generate_trace(seed, multi_cycle=False))):
        objs = mat(tr)
        from_trace = [e for e in tr.cycles[1]]  # cycle 1: the first arrivals
        import importlib

        trace_mod = importlib.import_module(
            "k8s_scheduler_tpu_torch.fuzz.trace" if orc is oracle
            else "k8s_scheduler_tpu.fuzz.trace")
        pending = [trace_mod.materialize_event(e)["pod"] for e in from_trace
                   if e["op"] == "add_pod"]
        existing = [(ev["pod"], ev["bind_node"]) for ev in
                    (trace_mod.materialize_event(e) for e in tr.cycles[0])
                    if ev["op"] == "add_bound_pod"]
        out = orc.schedule_cycle_trace(
            objs["nodes"], pending, existing, pod_groups=objs["pod_groups"],
            pvcs=objs["pvcs"], pvs=objs["pvs"], storage_classes=objs["storage_classes"],
            pdbs=objs["pdbs"], gang_scheduling=True)
        outs.append((
            [(d.node_index,) for d in out.decisions],
            sorted(out.reasons.items()),
            [(o.pod_index, o.node_index, tuple(o.victims)) for o in out.preemptions],
            sorted(out.dropped),
        ))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("name", CLEAN)
def test_engine_replay_matches_reference_on_the_corpus(name):
    path = os.path.join(CORPUS_DIR, f"{name}.json")
    t = fuzz.load_artifact(path)["trace"]
    rt = ref_fuzz.load_artifact(path)["trace"]
    eng = replay.replay_engine(t, device="cpu")
    ref = ref_replay.replay_engine(rt)
    assert eng.records == ref.records
    assert eng.binds == ref.binds
    assert [str(f) for f in eng.failures] == [str(f) for f in ref.failures] == []


@pytest.mark.parametrize("name", CLEAN)
def test_corpus_replays_clean(name):
    fails = fuzz.replay_artifact(os.path.join(CORPUS_DIR, f"{name}.json"), device="cpu")
    assert fails == [], [str(f) for f in fails]


def test_tiebreak_bug_fails_with_its_recorded_class():
    path = os.path.join(CORPUS_DIR, "tiebreak_argmax_last.json")
    art = fuzz.load_artifact(path)
    fails = fuzz.replay_artifact(path, with_bug=True, device="cpu")
    assert [f.cls for f in fails] == [art["failure"].cls] == ["divergence/binds"]
    assert dataclasses.asdict(fails[0]) == dataclasses.asdict(art["failure"])
    # a seeded trace: the reference's own self-test, through the port
    fails = fuzz.run_case(fuzz.generate_trace(1, multi_cycle=False), bug="tiebreak",
                          device="cpu")
    assert any(f.cls == "divergence/binds" for f in fails)


@pytest.mark.parametrize("seed", range(8))
def test_seeded_plain_traces_replay_clean(seed):
    fails = fuzz.run_case(fuzz.generate_trace(seed, multi_cycle=False), device="cpu")
    assert fails == [], [str(f) for f in fails]


@pytest.mark.parametrize("seed", range(3))
def test_seeded_durable_traces_replay_clean(seed, tmp_path):
    fails = fuzz.run_case(fuzz.generate_trace(seed, multi_cycle=False),
                          state_dir=str(tmp_path / "state"), device="cpu")
    assert fails == [], [str(f) for f in fails]


@pytest.mark.parametrize("seed", [3, 30])
def test_seeded_chaos_traces_hold_the_soak_invariants(seed, tmp_path):
    t = fuzz.generate_trace(seed, chaos=True, multi_cycle=False)
    assert t.fault_spec
    fails = fuzz.run_case(t, state_dir=str(tmp_path / "state"), device="cpu")
    assert fails == [], [str(f) for f in fails]


def test_seeded_incremental_traces_replay_clean():
    deltas = 0
    for seed in range(4):
        t = fuzz.generate_trace(seed, multi_cycle=False)
        t.config["incremental_encode"] = True
        fails = fuzz.run_case(t, device="cpu")
        assert fails == [], (seed, [str(f) for f in fails])
        deltas += fuzz.replay_engine(t, carry=True, device="cpu").stats["encode"]["delta"]
    assert deltas > 0


def test_incremental_variant_catches_an_arena_difference(monkeypatch):
    """The variant's own check bites: a delta path that wrote one byte
    wrong in the arena shows as `incremental/arena`."""
    from k8s_scheduler_tpu_torch.models.encoding import SnapshotEncoder

    orig = SnapshotEncoder.encode_packed

    def skewed(self, *a, **k):
        out = orig(self, *a, **k)
        if self.incremental and self.delta_hits:
            w = out[0]
            w.view(-1)[0] += 1
        return out

    monkeypatch.setattr(SnapshotEncoder, "encode_packed", skewed)
    t = fuzz.generate_trace(0, multi_cycle=False)
    t.config["incremental_encode"] = True
    fails = fuzz.run_case(t, device="cpu")
    assert "incremental/arena" in {f.cls for f in fails}
