"""The port's `Scheduler` against the reference's, event for event.

One seeded event sequence (informer handlers, clock ticks, cycles) goes
into `k8s_scheduler_tpu.core.Scheduler` and into the port's
`Scheduler(device="cpu")`, each with its own package's objects. Per cycle
the two must agree exactly on:
- the `CycleStats` (but the wall seconds);
- the binder's calls, in order;
- `last_nominations`, `last_evictions` and the evictor's calls;
- the events ring (Scheduled, FailedScheduling with its message,
  Preempted, AssumeExpired);
- the queue's active / backoff / unschedulable counts;
- the flight records' count fields, but the encoder's path counters
  (`full_encodes`, `delta_hits`, `fold_hits`, `ingest_hits`): the port's
  encoder folds pods the reference's bails on, and the reverse on a moved
  P pad (ROADMAP A1), with bit-equal frames either way.

Fixtures: the reference `tests/test_pipeline.py _workload()` (gang
unwind, a preemptor, an infeasible pod) over the carry path and the scan
(the packed path); four cycles of churn (binds folding in, pod deletes, a
node add, volumes) on the carry path; two profiles. HTTP extenders have
their own differential, tests/test_torch_extenders.py. Each fixture keeps
one pad regime (pad bucket 64, fixed widths), so the reference compiles
its programs once; each side runs once per fixture (cached) and the tests
compare the recorded cycles."""

from __future__ import annotations

import functools

import numpy as np
import pytest

import k8s_scheduler_tpu.config as ref_config
import k8s_scheduler_tpu.core as ref_core
import k8s_scheduler_tpu_torch.config as port_config
import k8s_scheduler_tpu_torch.core as port_core
from test_torch_volumes import PORT, REF
from torch_one_thread import one_torch_thread  # noqa: F401

GiB = 2**30
ZONE = "topology.kubernetes.io/zone"
# the encoder's path counters, which may differ (see the module docstring)
ENCODER_PATH_COUNTS = ("full_encodes", "delta_hits", "fold_hits", "ingest_hits")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class Recorder:
    """Stands in for the API server: records binds and evictions; an
    eviction echoes back as the pod's delete."""

    def __init__(self):
        self.binds: list[tuple[str, str]] = []
        self.evictions: list[tuple[str, str]] = []
        self.sched = None

    def bind(self, pod, node):
        self.binds.append((pod.name, node))

    def evict(self, pod, node):
        self.evictions.append((pod.name, node))
        self.sched.on_pod_delete(pod.uid)


# ---- event sequences: lists of (op, args...) built from one package's
# objects (`m`: test_torch_volumes.M) ------------------------------------


def _pipeline_workload(m):
    """The reference tests/test_pipeline.py `_workload()`, then a node add
    that frees the unplaced, and a second cycle."""
    ev = [("node_add", m.MakeNode(f"n{i}").capacity({"cpu": "4", "memory": "8Gi"})
           .labels({"zone": f"z{i % 2}"}).obj()) for i in range(4)]
    ev += [("pod_add", m.MakePod(f"run{i}").req({"cpu": "3"}).priority(0).obj(), f"n{i}")
           for i in range(2)]
    ev.append(("group", m.api.PodGroup("job", 3)))
    pods = ([m.MakePod(f"hi{i}").req({"cpu": "2"}).priority(100).created(float(i)).obj()
             for i in range(2)]
            + [m.MakePod("pre").req({"cpu": "4"}).priority(100).created(5.0).obj()]
            + [m.MakePod(f"g{i}").req({"cpu": "2"}).priority(10).group("job")
               .created(10.0 + i).obj() for i in range(3)]
            + [m.MakePod("huge").req({"cpu": "64"}).created(99.0).obj()])
    ev += [("pod_add", p, "") for p in pods]
    ev.append(("cycle",))
    ev.append(("tick", 30.0))
    ev.append(("node_add", m.MakeNode("n4").capacity({"cpu": "8", "memory": "16Gi"})
               .labels({"zone": "z0"}).obj()))
    ev.append(("cycle",))
    return ev


def _churn(m, seed=18):
    """Four cycles on zoned nodes with local and zonal volumes: arrivals,
    the previous cycle's binds observed bound (informer echoes), deletes
    of running pods, a node add."""
    a = m.api
    rng = np.random.default_rng(seed)
    zones = ("z0", "z1")
    ev = [("node_add", m.MakeNode(f"{z}-n{i}").capacity({"cpu": "8", "memory": "16Gi"})
           .labels({ZONE: z}).obj()) for z in zones for i in range(3)]
    ev.append(("sc", a.StorageClass("local", a.VOLUME_BINDING_WAIT, provisioner=False)))
    for v in range(4):
        ev.append(("pv", a.PersistentVolume(
            f"pv-{v}", capacity=10 * GiB, storage_class="local",
            node_affinity=(a.NodeSelectorTerm((a.NodeSelectorRequirement(
                ZONE, "In", (zones[v % 2],)),)),))))
    for v in range(3):
        ev.append(("pvc", a.PersistentVolumeClaim(f"claim-{v}", storage_class="local",
                                                  request=5 * GiB)))
    running = []
    for i in range(8):
        p = m.MakePod(f"run{i}").req({"cpu": f"{int(rng.integers(1, 4))}"}) \
            .priority(int(rng.integers(0, 3))).obj()
        node = f"{zones[i % 2]}-n{i % 3}"
        running.append(p)
        ev.append(("pod_add", p, node))
    serial = 0
    for c in range(4):
        for _ in range(int(rng.integers(5, 12))):
            b = m.MakePod(f"p{serial}").req({"cpu": f"{int(rng.integers(1, 5))}",
                                             "memory": f"{int(rng.integers(1, 6))}Gi"}) \
                .priority(int(rng.integers(0, 5))).created(float(serial))
            if serial % 7 == 3 and serial // 7 < 3:
                b = b.volume(f"claim-{serial // 7}")
            ev.append(("pod_add", b.obj(), ""))
            serial += 1
        ev.append(("cycle",))
        ev.append(("echo_binds",))  # the informer observes the binds
        ev.append(("tick", 11.0))
        ev.append(("pod_delete", running[c].uid))
        if c == 1:
            ev.append(("node_add", m.MakeNode("z1-n9").capacity({"cpu": "16", "memory": "32Gi"})
                       .labels({ZONE: "z1"}).obj()))
    return ev


def _two_profiles(m):
    """Two profiles: the default one and 'batch' (MostAllocated-like:
    without BalancedAllocation and ImageLocality, TaintToleration weight
    5), their pods interleaved, both in one cycle, twice."""
    ev = [("node_add", m.MakeNode(f"n{i}").capacity({"cpu": f"{4 + 2 * (i % 3)}",
                                                     "memory": "16Gi"}).obj())
          for i in range(6)]
    for c in range(2):
        for i in range(10):
            b = m.MakePod(f"c{c}-p{i}").req({"cpu": f"{1 + i % 3}"}).created(float(i))
            if i % 2:
                b = b.scheduler("batch")
            ev.append(("pod_add", b.obj(), ""))
        ev.append(("cycle",))
        ev.append(("echo_binds",))
        ev.append(("tick", 1.0))
    return ev


SEQUENCES = {"pipeline_workload": _pipeline_workload, "churn": _churn,
             "two_profiles": _two_profiles}


def _config(cfg_mod, name: str, commit_mode: str):
    # the existing-pod pad and the per-node depth pre-sized, as a
    # fold-heavy deployment does: binds folding in keep one regime
    pads = dict(pad_existing=64, pad_pods_per_node=16)
    if name == "two_profiles":
        batch = cfg_mod.Profile(
            scheduler_name="batch",
            plugins=cfg_mod.Plugins(score=cfg_mod.PluginSet(
                enabled=[cfg_mod.PluginEntry("TaintToleration", 5)],
                disabled=["NodeResourcesBalancedAllocation", "ImageLocality"])))
        return cfg_mod.SchedulerConfiguration(profiles=[cfg_mod.Profile(), batch],
                                              commit_mode=commit_mode, **pads)
    return cfg_mod.SchedulerConfiguration(commit_mode=commit_mode, **pads)


def _cycle_record(s, rec: Recorder, st, n_binds, n_evict, n_records) -> dict:
    counts = [
        {k: v for k, v in r.counts.items() if k not in ENCODER_PATH_COUNTS}
        for r in s.flight.snapshot()[n_records:]
    ]
    return {
        "stats": {k: v for k, v in vars(st).items() if k != "cycle_seconds"},
        "binds": rec.binds[n_binds:],
        "evictions": rec.evictions[n_evict:],
        "nominations": [(p.name, n) for p, n in s.last_nominations],
        "last_evictions": [(p.name, n) for p, n in s.last_evictions],
        "events": [(e.reason, e.pod_name, e.message) for e in s.events.drain()],
        "queue": s.queue.pending_counts(),
        "record_counts": counts,
        "profiles": [r.profile for r in s.flight.snapshot()[n_records:]],
    }


def drive(side: str, name: str, commit_mode: str = "rounds", configure=None,
          keep: list | None = None, **sched_kw) -> list[dict]:
    """Run fixture `name` through one package's Scheduler; one record a
    cycle. `configure(config module, configuration)` may return another
    configuration (the side's own config classes); `keep` receives the
    Scheduler."""
    m = REF if side == "ref" else PORT
    core, cfg_mod = (ref_core, ref_config) if side == "ref" else (port_core, port_config)
    clock, rec = FakeClock(), Recorder()
    kw = dict(sched_kw)
    if side == "port":
        kw["device"] = "cpu"
    cfg = _config(cfg_mod, name, commit_mode)
    if configure is not None:
        cfg = configure(cfg_mod, cfg)
    s = core.Scheduler(cfg, binder=rec.bind, evictor=rec.evict, now=clock, **kw)
    rec.sched = s
    if keep is not None:
        keep.append(s)
    out = []
    nb = ne = nr = 0
    last_binds: list = []
    pods_by_name: dict = {}
    for op, *args in SEQUENCES[name](m):
        if op == "node_add":
            s.on_node_add(args[0])
        elif op == "pod_add":
            pods_by_name[args[0].name] = args[0]
            s.on_pod_add(args[0], args[1])
        elif op == "pod_delete":
            s.on_pod_delete(args[0])
        elif op == "group":
            s.add_pod_group(args[0])
        elif op == "sc":
            s.on_storage_class_upsert(args[0])
        elif op == "pv":
            s.on_pv_upsert(args[0])
        elif op == "pvc":
            s.on_pvc_upsert(args[0])
        elif op == "tick":
            clock.t += args[0]
        elif op == "echo_binds":
            for pod_name, node in last_binds:
                s.on_pod_add(pods_by_name[pod_name], node)
        elif op == "cycle":
            st = s.schedule_cycle()
            out.append(_cycle_record(s, rec, st, nb, ne, nr))
            last_binds = rec.binds[nb:]
            nb, ne, nr = len(rec.binds), len(rec.evictions), len(s.flight.snapshot())
        else:
            raise ValueError(op)
    return out


@functools.cache
def _drive(side: str, name: str, commit_mode: str):
    return drive(side, name, commit_mode)


CASES = [("pipeline_workload", "rounds"), ("pipeline_workload", "scan"),
         ("churn", "rounds"), ("two_profiles", "rounds")]
FIELDS = ("stats", "binds", "evictions", "nominations", "last_evictions",
          "events", "queue", "record_counts", "profiles")


@pytest.mark.parametrize("name,commit_mode", CASES)
@pytest.mark.parametrize("field", FIELDS)
def test_scheduler_cycles_match_reference(name, commit_mode, field):
    want = _drive("ref", name, commit_mode)
    got = _drive("port", name, commit_mode)
    assert len(got) == len(want)
    for c, (g, w) in enumerate(zip(got, want)):
        assert g[field] == w[field], f"{name}/{commit_mode} cycle {c}: {field}"


@pytest.mark.parametrize("name,commit_mode", CASES)
def test_fixture_exercises_what_it_claims(name, commit_mode):
    cycles = _drive("port", name, commit_mode)
    stats = [c["stats"] for c in cycles]
    assert sum(s["scheduled"] for s in stats) > 0
    if name == "pipeline_workload":
        assert stats[0]["gang_dropped"] > 0 and stats[0]["preemptors"] > 0
        assert stats[0]["victims"] > 0 and stats[0]["unschedulable"] > 0
    if name == "churn":
        assert len(cycles) == 4
        assert any(c["events"] and c["stats"]["unschedulable"] for c in cycles)
    if name == "two_profiles":
        assert {"default-scheduler", "batch"} <= set(cycles[0]["profiles"])


@pytest.mark.parametrize("kw,item", [
    pytest.param({"multi_cycle_k": 4}, "A11", id="kw0-A11"),
    pytest.param({"shard_devices": 2}, "A13", id="kw2-A13"),
])
def test_unported_serving_features_raise(kw, item):
    """shardDevices > 1 stays refused by name (A13); multiCycleK > 1 is
    served since A11 was ported (its case keeps its id)."""
    cfg = port_config.SchedulerConfiguration(**kw)
    if item == "A11":
        assert port_core.Scheduler(cfg, device="cpu")._mc_k == 4
        return
    with pytest.raises(NotImplementedError, match=item):
        port_core.Scheduler(cfg, device="cpu")


def test_unported_entry_points_raise():
    """The entry points these refusals stood for are ported: the via-API
    fuzz case runs clean, and `dispatch_multi` without a batch program
    says which program to install."""
    from k8s_scheduler_tpu_torch import fuzz

    assert fuzz.run_api_case(fuzz.generate_trace(1, multi_cycle=False), device="cpu") == []
    with pytest.raises(RuntimeError, match="multi_fn"):
        port_core.ServingPipeline(lambda *a: None, device="cpu").dispatch_multi(
            None, None, None, 1)


def test_compile_cache_dir_and_profile_cycle_are_served(tmp_path, monkeypatch):
    """compileCacheDir opens the persistent kernel cache (no longer
    refused); profile_cycle runs the profiling pass."""
    from k8s_scheduler_tpu_torch.ops import kernel_build as kb

    monkeypatch.setattr(kb, "BUILD_DIR", kb.BUILD_DIR)
    monkeypatch.setattr(kb, "_CACHE", None)
    monkeypatch.setenv("TRITON_CACHE_DIR", str(tmp_path / "triton"))
    cfg = port_config.SchedulerConfiguration(compile_cache_dir=str(tmp_path / "kscc"))
    s = port_core.Scheduler(cfg, device="cpu")
    assert s._compile_cache.dir == str(tmp_path / "kscc") and kb._CACHE is s._compile_cache
    assert s.profile_cycle() == {}


def test_scheduler_for_the_card_raises_without_one():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_core.Scheduler()


def test_stable_memo_and_carry_hit_on_delta_and_fold_frames():
    """The stable-table memo (keyed on the encoder's stable dict and its
    fold count) and the carry (keyed on the encoder's carry key) survive
    the frames the encoder serves incrementally — a pending-only delta
    hits both, a fold of bound pods recomputes the stable tables but keeps
    the carry — and miss after a real stable change (a node add)."""
    s = port_core.Scheduler(port_config.SchedulerConfiguration(
        pad_existing=64, pad_pods_per_node=16), device="cpu")
    rec = Recorder()
    rec.sched = s
    s.binder = rec.bind
    for i in range(3):
        s.on_node_add(PORT.MakeNode(f"n{i}").capacity({"cpu": "4"}).obj())
    pods = {}

    def add(names, cpu="1"):
        for n in names:
            pods[n] = PORT.MakePod(n).req({"cpu": cpu}).created(float(len(pods))).obj()
            s.on_pod_add(pods[n])

    add(["a0", "a1", "a2"])
    s.schedule_cycle()
    entry = next(iter(s._packed.values()))
    cyc, pre, stable_fn, keeper = entry["fns"][:4]
    calls = []

    def counting(w, b):
        calls.append(1)
        return stable_fn(w, b)

    entry["fns"] = (cyc, pre, counting) + entry["fns"][3:]
    enc = s._encoder

    def cycle(expect_path, expect_stable_calls, expect_keeper):
        n0 = (enc.full_encodes, enc.delta_hits, enc.fold_hits, len(calls))
        s.schedule_cycle()
        path = ("full" if enc.full_encodes > n0[0] else
                "delta + fold" if enc.fold_hits > n0[2] else "delta")
        assert (path, len(calls) - n0[3], keeper.last) == (
            expect_path, expect_stable_calls, expect_keeper)

    # the binds observed bound (a pure append to the running list) and
    # new pending pods: the fold recomputes the stable tables, the carry
    # is updated
    for name, node in rec.binds:
        s.on_pod_add(pods[name], node)
    add(["b0", "b1"])
    cycle("delta + fold", 1, "update")
    for name, node in rec.binds[3:]:
        s.on_pod_add(pods[name], node)
    add(["c0"], cpu="64")  # fits nowhere: nothing binds in this cycle
    cycle("delta + fold", 1, "update")
    # a pending-only change: the stable memo hits, the carry is updated
    # for the changed rows
    add(["c1"], cpu="64")
    cycle("delta", 0, "update")
    # a real stable change: a node add is a full encode, a new stable
    # side and carry key
    s.on_node_add(PORT.MakeNode("n9").capacity({"cpu": "4"}).obj())
    add(["d0"])
    cycle("full", 1, "init")
