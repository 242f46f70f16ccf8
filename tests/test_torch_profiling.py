"""The port's profiling pass (`core/profiling.py`, `Scheduler.profile_cycle`)
against the reference's `core/profiling.py`.

- `profile_plugins` on one snapshot of each fixture: the report's keys, and
  each entry's extension point, weight, feasible fraction and score
  statistics, equal the reference's (the seconds are each device's own);
  the probes are cached on the framework.
- `overlap_stats` and `overlap_from_records` equal the reference's.
- `trace_cycle` writes a Chrome trace on the CPU.
- `profile_cycle` fills the per-plugin and per-extension-point histograms.
Every comparison is exact."""

from __future__ import annotations

import json
import os

import pytest

import k8s_scheduler_tpu.core.profiling as ref_prof
import k8s_scheduler_tpu.framework.runtime as ref_runtime
import k8s_scheduler_tpu.metrics as ref_metrics
import k8s_scheduler_tpu.models as ref_models
import k8s_scheduler_tpu.utils.synth as ref_synth
import k8s_scheduler_tpu_torch.core.profiling as prof
import k8s_scheduler_tpu_torch.framework.runtime as port_runtime
import k8s_scheduler_tpu_torch.metrics as port_metrics
import k8s_scheduler_tpu_torch.models as port_models
import k8s_scheduler_tpu_torch.utils.synth as port_synth
from k8s_scheduler_tpu_torch.config import SchedulerConfiguration
from k8s_scheduler_tpu_torch.core import Scheduler
from k8s_scheduler_tpu_torch.core.cycle import build_cycle_fn
from test_torch_encoding import fixture
from torch_one_thread import one_torch_thread  # noqa: F401

STAT_KEYS = ("extension_point", "weight", "feasible_fraction", "score_mean", "score_max")


def _reports(name):
    nodes, pods, existing, groups = fixture(name, ref_models, ref_synth)
    rsnap = ref_models.SnapshotEncoder().encode(nodes, pods, existing, groups)
    nodes, pods, existing, groups = fixture(name, port_models, port_synth)
    psnap = port_models.SnapshotEncoder(device="cpu").encode(nodes, pods, existing, groups)
    rfw = ref_runtime.Framework.from_config()
    pfw = port_runtime.Framework.from_config()
    rm, pm = ref_metrics.SchedulerMetrics(), port_metrics.SchedulerMetrics()
    ref = ref_prof.profile_plugins(rfw, rsnap, rm, repeats=1)
    port = prof.profile_plugins(pfw, psnap, pm, repeats=1)
    return ref, port, pfw, psnap, pm


@pytest.mark.parametrize("name", ["mixed", "nominated", "cfg5"])
def test_profile_report_matches_reference(name):
    ref, port, pfw, psnap, pm = _reports(name)
    assert list(port) == list(ref)
    for key, want in ref.items():
        got = port[key]
        assert set(got) == set(want), key
        for f in STAT_KEYS:
            if f in want:
                assert got[f] == want[f], (key, f, got[f], want[f])
        assert got["seconds"] > 0.0
    # the probes live on the framework and are reused
    cache = pfw.__dict__["_probe_cache"]
    assert {k[1] for k in cache} >= {k.split("/")[0] for k in port}
    before = dict(cache)
    prof.profile_plugins(pfw, psnap, None, repeats=1)
    assert all(cache[k] is before[k] for k in before)
    # one histogram sample a report entry, one a point with time spent
    n_plugin = sum(c.count for c in pm.plugin_duration._children.values())
    n_point = sum(c.count for c in pm.extension_point_duration._children.values())
    assert n_plugin == len(port)
    assert n_point == len({v["extension_point"] for v in port.values()})


OVERLAP_CASES = [(0.010, 0.020, 0.025), (0.030, 0.010, 0.031), (0.0, 0.0, 0.0),
                 (0.005, 0.005, 0.012), (1.2345, 0.0001, 1.2)]


@pytest.mark.parametrize("case", OVERLAP_CASES)
def test_overlap_stats_match_reference(case):
    assert prof.overlap_stats(*case) == ref_prof.overlap_stats(*case)


RECORDS = [
    [],
    [{"encode_ms": 12.5, "decision_wait_ms": 3.25}],
    [{"encode_ms": 12.5, "decision_wait_ms": 30.0, "diag_lag_ms": 4.0},
     {"encode_ms": 7.0, "decision_wait_ms": 1.0, "encode_hidden_ms": 2.0},
     {"encode_ms": 0.0, "decision_wait_ms": 0.0}],
    [{"decision_wait_ms": 2.0, "diag_lag_ms": 1.5}] * 5,
]


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_overlap_from_records_matches_reference(i):
    assert prof.overlap_from_records(iter(RECORDS[i])) == ref_prof.overlap_from_records(
        iter(RECORDS[i]))


def test_trace_cycle_writes_a_chrome_trace(tmp_path):
    nodes, pods, existing, groups = fixture("mixed", port_models, port_synth)
    snap = port_models.SnapshotEncoder(device="cpu").encode(nodes, pods, existing, groups)
    cycle = build_cycle_fn(device="cpu")
    out = prof.trace_cycle(cycle, snap, str(tmp_path / "trace"))
    want = cycle(snap)
    assert (out.assignment == want.assignment).all()
    path = tmp_path / "trace" / prof.TRACE_FILE
    with open(path) as f:
        trace = json.load(f)
    assert os.path.getsize(path) > 0 and trace["traceEvents"]


def test_profile_cycle_fills_both_histograms():
    s = Scheduler(SchedulerConfiguration(), device="cpu")
    assert s.profile_cycle() == {}  # nothing pending: nothing to time
    nodes, pods, existing, _ = fixture("mixed", port_models, port_synth)
    for nd in nodes:
        s.on_node_add(nd)
    for p, n in existing:
        s.on_pod_add(p, n)
    for p in pods:
        s.on_pod_add(p)
    report = s.profile_cycle(repeats=1)
    assert report and all(v["seconds"] > 0.0 for v in report.values())
    samples = {(x.name, tuple(sorted(x.labels.items()))): x.value
               for f in s.metrics.registry.collect() for x in f.samples}
    plugin = {k: v for k, v in samples.items()
              if k[0] == "scheduler_plugin_execution_duration_seconds_count"}
    point = {k: v for k, v in samples.items()
             if k[0] == "scheduler_framework_extension_point_duration_seconds_count"}
    assert sum(plugin.values()) == len(report)
    assert {dict(k[1])["extension_point"] for k in point} == {"Filter", "Score"}
    assert all(v == 1.0 for v in point.values())
    # the queue was not drained
    assert len(list(s.queue.all_pending())) == len(pods)
