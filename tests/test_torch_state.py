"""The port's durable state (`k8s_scheduler_tpu_torch/state/`, the queue's
and cache's journaling hooks, `Scheduler(state=...)`) against the
reference's, with exact equality: codec dicts, journal records (op, clock
value and data), state digests, decisions and event streams.

- Codec: the reference's rich pod and node and `utils/synth` objects from
  a seed serialise to the same dict from both packages and round-trip
  through each.
- Queue and cache: one seeded random op trace (intake, pops, hold pops,
  assume / finish / confirm / forget, requeues, moves, sweeps, deletes,
  node churn, takeover recovery, retires), with a fake clock, through both
  packages: the digest after every op and the journal records equal; the
  trace journaled as singles and as batches restores to the same digest.
- Formats across packages: a state directory (snapshot and tail) written
  by either package's `DurableState` restores in the other's with the
  same digest.
- The journal's own rules, on the port (the reference's
  tests/test_state_journal.py): a torn final record at every byte offset,
  mid-segment corruption, future format and snapshot versions, rotation
  and cut, a restart's fresh segment, the writer's IO failure, the
  degrade to stateless, an open batch's invisibility, `status()`.
- The Scheduler with `state=`: the reference's and the port's driven by
  one event sequence and clock (tests/test_torch_scheduler.py's fixtures):
  equal digests and journals after every cycle; a standby built on the
  directory restores the exact state in its constructor, recovers the
  in-flight pods, and its decisions and events after the takeover equal
  the reference standby's; records written after a seal survive the next
  takeover; and one SIGKILLed port child process on the CPU whose last
  digest the standby restores."""

from __future__ import annotations

import contextlib
import functools
import json
import os
import random
import shutil
import signal
import struct
import subprocess
import sys
import threading
import time
import zlib

import pytest

import k8s_scheduler_tpu.config as ref_config
import k8s_scheduler_tpu.core as ref_core
import k8s_scheduler_tpu.internal.cache as ref_cache
import k8s_scheduler_tpu.internal.queue as ref_queue
import k8s_scheduler_tpu.state as ref_state
import k8s_scheduler_tpu.state.codec as ref_codec
import k8s_scheduler_tpu.state.journal as ref_journal
import k8s_scheduler_tpu.utils.synth as ref_synth
import k8s_scheduler_tpu_torch.config as port_config
import k8s_scheduler_tpu_torch.core as port_core
import k8s_scheduler_tpu_torch.internal.cache as port_cache
import k8s_scheduler_tpu_torch.internal.queue as port_queue
import k8s_scheduler_tpu_torch.state as port_state
import k8s_scheduler_tpu_torch.state.codec as port_codec
import k8s_scheduler_tpu_torch.state.journal as port_journal
import k8s_scheduler_tpu_torch.utils.synth as port_synth
from k8s_scheduler_tpu_torch.state import (DurableState, Journal, StateCorruption, StateError,
                                           StateVersionError, replay_dir, state_digest)
from k8s_scheduler_tpu_torch.state.journal import (BATCH_OP, FORMAT_VERSION,
                                                   encode_batch_payload, encode_record,
                                                   read_segment, segment_header,
                                                   segment_indices, segment_path)
from test_torch_scheduler import SEQUENCES, FakeClock, Recorder, _config, _cycle_record
from test_torch_volumes import PORT, REF
from torch_one_thread import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Pkg:
    """One package's state layer, queue and cache."""

    def __init__(self, m, queue_mod, cache_mod, state_mod, codec, journal, synth):
        self.m, self.queue_mod, self.cache_mod = m, queue_mod, cache_mod
        self.state, self.codec, self.journal, self.synth = state_mod, codec, journal, synth

    def pair(self, clock):
        q = self.queue_mod.SchedulingQueue(
            initial_backoff_seconds=0.5, max_backoff_seconds=4.0,
            unschedulable_timeout_seconds=30.0, now=clock)
        c = self.cache_mod.SchedulerCache(assumed_pod_ttl_seconds=2.0, now=clock)
        return q, c

    def restore(self, d, scheduler_defaults: bool = False):
        """A bare restore of directory `d`: the queue and cache sized as
        `pair`'s, or with the Scheduler's defaults (backoff 1 s / 10 s, TTL
        30 s) for a directory a Scheduler wrote."""
        if scheduler_defaults:
            q = self.queue_mod.SchedulingQueue(now=FakeClock())
            c = self.cache_mod.SchedulerCache(now=FakeClock())
        else:
            q, c = self.pair(FakeClock())
        st = self.state.DurableState(d, snapshot_interval_seconds=0)
        stats = st.restore_into(q, c)
        st.journal.close()
        return q, c, stats


REFP = Pkg(REF, ref_queue, ref_cache, ref_state, ref_codec, ref_journal, ref_synth)
PORTP = Pkg(PORT, port_queue, port_cache, port_state, port_codec, port_journal, port_synth)
BOTH = {"ref": REFP, "port": PORTP}


# ---- codec -----------------------------------------------------------------


def _rich_pod_dict():
    """The reference's rich pod (tests/test_state_journal.py)."""
    return {
        "metadata": {"name": "rich", "namespace": "ns1", "uid": "u-1",
                     "labels": {"app": "db", "tier": "backend"},
                     "annotations": {"k": "v"}, "creationTimestamp": 12.5},
        "spec": {
            "containers": [{"name": "main", "image": "img:1",
                            "resources": {"requests": {"cpu": "1500m", "memory": "2Gi"}},
                            "ports": [{"containerPort": 80, "hostPort": 8080}]}],
            "nodeSelector": {"disk": "ssd"},
            "affinity": {
                "nodeAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": {
                    "nodeSelectorTerms": [{"matchExpressions": [
                        {"key": "zone", "operator": "In", "values": ["a", "b"]}]}]}},
                "podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
                    {"labelSelector": {"matchLabels": {"app": "db"}},
                     "topologyKey": "kubernetes.io/hostname"}]},
            },
            "tolerations": [{"key": "gpu", "operator": "Exists", "effect": "NoSchedule"}],
            "topologySpreadConstraints": [{"maxSkew": 1, "topologyKey": "zone",
                                           "whenUnsatisfiable": "DoNotSchedule",
                                           "labelSelector": {"matchLabels": {"app": "db"}}}],
            "priority": 100, "priorityClassName": "high", "preemptionPolicy": "Never",
            "schedulerName": "tpu-scheduler", "podGroup": "g1",
        },
        "status": {"nominatedNodeName": "n7"},
    }


def _codec_objects(p: Pkg):
    """(pods, nodes) of one package: synth draws with every constraint
    kind, a tainted labelled node, and a pod with volumes and ports."""
    s, m = p.synth, p.m
    pods = s.make_pods(40, seed=5, affinity_fraction=0.3, anti_affinity_fraction=0.3,
                       selector_fraction=0.3, toleration_fraction=0.3, spread_fraction=0.3,
                       priorities=(0, 10, 100))
    pods.append(m.MakePod("vol").req({"cpu": "1"}).volume("claim-0").obj())
    pods.append(m.MakePod("ports").req({"cpu": "1"}).host_port(8080).obj())
    nodes = s.make_cluster(12, seed=3, taint_fraction=0.5)
    nodes.append(m.MakeNode("n1").labels({"zone": "a"}).capacity(
        {"cpu": "64", "memory": "128Gi"}).taint("dedicated", "db", "NoSchedule").obj())
    return pods, nodes


def test_codec_rich_pod_and_node_equal_the_reference_and_round_trip():
    from k8s_scheduler_tpu.models.api import pod_from_dict

    ref_pod = pod_from_dict(_rich_pod_dict())
    want = ref_codec.pod_to_state(ref_pod)
    port_pod = port_codec.pod_from_state(json.loads(json.dumps(want)))
    assert port_codec.pod_to_state(port_pod) == want
    assert port_codec.pod_from_state(port_codec.pod_to_state(port_pod)) == port_pod
    ref_node = REF.MakeNode("n1").labels({"zone": "a"}).capacity(
        {"cpu": "64", "memory": "128Gi"}).taint("dedicated", "db", "NoSchedule").obj()
    port_node = PORT.MakeNode("n1").labels({"zone": "a"}).capacity(
        {"cpu": "64", "memory": "128Gi"}).taint("dedicated", "db", "NoSchedule").obj()
    assert port_codec.node_to_state(port_node) == ref_codec.node_to_state(ref_node)
    assert port_codec.node_from_state(port_codec.node_to_state(port_node)) == port_node


def test_codec_synth_objects_equal_the_reference_and_round_trip():
    rp, rn = _codec_objects(REFP)
    pp, pn = _codec_objects(PORTP)
    for r, p in zip(rp, pp):
        d = port_codec.pod_to_state(p)
        assert d == ref_codec.pod_to_state(r), p.name
        assert port_codec.pod_from_state(d) == p
        assert ref_codec.pod_to_state(ref_codec.pod_from_state(d)) == d
    for r, n in zip(rn, pn):
        d = port_codec.node_to_state(n)
        assert d == ref_codec.node_to_state(r), n.name
        assert port_codec.node_from_state(d) == n


# ---- queue and cache: one random op trace through both packages ------------


def _random_op(p: Pkg, rng: random.Random, clock, q, c, i: int) -> str:
    """One step of a scheduler-shaped mutation stream (the reference's
    scripts/soak_failover.py `apply_random_op`, with hold pops, updates,
    takeover recovery and retires). Returns the step's name."""
    m = p.m
    clock.t += rng.random() * 0.05
    roll = rng.randrange(15)
    if roll <= 2:
        pod = m.MakePod(f"p{rng.randrange(max(2 * i, 1))}").req(
            {"cpu": str(1 + rng.randrange(4))}).obj()
        if rng.random() < 0.2:
            pod.spec.priority = rng.randrange(10)
        q.add(pod)
        return "add"
    if roll == 3:
        c.add_node(m.MakeNode(f"n{rng.randrange(8)}").capacity({"cpu": "64"}).obj())
        return "add_node"
    if roll in (4, 11):
        pods = q.pop_ready(hold=(roll == 11))
        for p_ in pods:
            k = rng.randrange(4)
            if k == 0:
                try:
                    c.assume(p_, f"n{rng.randrange(8)}")
                except ValueError:
                    continue
                c.finish_binding(p_.uid)
                r = rng.random()
                if r < 0.4:
                    c.confirm(p_.uid)
                elif r < 0.5:
                    c.forget(p_.uid)
            elif k == 1:
                q.requeue_backoff(p_)
            elif k == 2:
                q.requeue_unschedulable(p_, reasons=rng.choice(
                    [("NodeResourcesFit",), ("NodeAffinity",), ()]))
        return "pop"
    if roll == 5:
        q.flush_backoff()
        return "flush_backoff"
    if roll == 6:
        q.move_all_to_active_or_backoff(rng.choice(["NodeAdd", "PodDelete", "NodeUpdate"]))
        return "move"
    if roll == 7:
        q.flush_unschedulable_timeout()
        return "flush_timeout"
    if roll == 8:
        for p_, _n in c.cleanup_expired():
            q.requeue_backoff(p_, event="AssumeExpired")
        return "expire"
    if roll == 9:
        uid = f"default/p{rng.randrange(max(2 * i, 1))}"
        q.delete(uid)
        if rng.random() < 0.5:
            c.remove_pod(uid)
        return "delete"
    if roll == 10:
        pod = m.MakePod(f"p{rng.randrange(max(2 * i, 1))}").req({"cpu": "2"}).obj()
        if rng.random() < 0.5:
            q.update(pod)
        else:
            c.add_pod(pod, f"n{rng.randrange(8)}")
        return "update"
    if roll == 12:
        if rng.random() < 0.5:
            c.remove_node(f"n{rng.randrange(8)}")
        else:
            c.update_node(m.MakeNode(f"n{rng.randrange(8)}").capacity({"cpu": "32"}).obj())
        return "node_churn"
    if roll == 13:
        q.retire_in_flight([f"default/p{rng.randrange(max(2 * i, 1))}" for _ in range(3)])
        return "retire"
    clock.t += rng.random() * 3.0
    if rng.random() < 0.2:
        q.recover_in_flight()
        return "recover"
    return "tick"


def _trace(p: Pkg, seed: int, n: int, state_dir=None, batched: bool = False):
    """Drive the random trace through package `p`: (journal records of
    every op, digests after every op, the live digest, the queue/cache).
    With `state_dir` the records go through a `DurableState` too."""
    clock = FakeClock()
    clock.t = 1000.0
    q, c = p.pair(clock)
    records: list = []
    st = None
    if state_dir is not None:
        st = p.state.DurableState(state_dir, snapshot_interval_seconds=0)
        st.attach(q, c)
        emit = st._emit

        def tee(op, t, d):
            records.append((op, t, json.loads(json.dumps(d))))
            emit(op, t, d)

        q.set_journal(tee)
        c.set_journal(tee)
    else:
        sink = lambda op, t, d: records.append((op, t, json.loads(json.dumps(d))))  # noqa: E731
        q.set_journal(sink)
        c.set_journal(sink)
    rng = random.Random(seed)
    digests = []
    i = 0
    for chunk in range(n // 5):
        scope = st.batch() if (batched and st is not None) else contextlib.nullcontext()
        with scope:
            for _ in range(5):
                _random_op(p, rng, clock, q, c, i)
                i += 1
                digests.append(p.codec.state_digest(q, c))
        if st is not None and chunk in (20, 40):
            st.snapshot()  # mid-trace compactions must not perturb replay
    live = p.codec.state_digest(q, c)
    if st is not None:
        st.journal.flush()
        st.journal.close()
    return records, digests, live, (q, c)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_random_trace_digests_and_records_equal_the_reference(seed):
    want = _trace(REFP, seed, 300)
    got = _trace(PORTP, seed, 300)
    assert got[1] == want[1]  # the digest after every op
    assert got[0] == want[0]  # every record: op, clock value, data
    ops = {r[0] for r in got[0]}
    assert {"q.add", "q.pop", "c.assume", "c.finish_binding", "c.add_node"} <= ops
    assert len(ops) >= 14, sorted(ops)


@pytest.mark.parametrize("seed", [0, 7])
def test_random_trace_batches_restore_the_live_digest_in_both(tmp_path, seed):
    """The trace journaled as singles and with every chunk in
    `DurableState.batch()`: both restore the live digest, in both
    packages, and the two packages' segment files are byte-equal."""
    lives = {}
    for batched in (False, True):
        for side, p in BOTH.items():
            d = str(tmp_path / f"{side}-{batched}")
            _, _, live, _ = _trace(p, seed, 250, state_dir=d, batched=batched)
            lives[(side, batched)] = live
            for side2, p2 in BOTH.items():
                q2, c2, stats = p2.restore(d)
                assert p2.codec.state_digest(q2, c2) == live, (side, side2, batched)
                assert stats["snapshot"] is True
        ops = {op for op, _t, _d in replay_dir(str(tmp_path / f"port-{batched}"))}
        assert (BATCH_OP in ops) == batched
        for name in sorted(os.listdir(tmp_path / f"ref-{batched}")):
            if name.startswith("wal-"):
                assert (tmp_path / f"ref-{batched}" / name).read_bytes() == \
                    (tmp_path / f"port-{batched}" / name).read_bytes(), name
    assert len(set(lives.values())) == 1


def test_state_dirs_restore_across_packages(tmp_path):
    """A snapshot plus a journal tail written by each package's
    `DurableState` restores in the other's to the writer's digest."""
    for side, p in BOTH.items():
        d = str(tmp_path / side)
        clock = FakeClock()
        q, c = p.pair(clock)
        st = p.state.DurableState(d, snapshot_interval_seconds=0)
        st.attach(q, c)
        for nd in p.synth.make_cluster(6, seed=2):
            c.add_node(nd)
        pods = p.synth.make_pods(30, seed=4, affinity_fraction=0.3, spread_fraction=0.3)
        for pod in pods[:20]:
            clock.t += 0.5
            q.add(pod)
        popped = q.pop_ready()
        for k, pod in enumerate(popped):
            if k % 3 == 0:
                c.assume(pod, f"node-{k % 6}")
                c.finish_binding(pod.uid)
            elif k % 3 == 1:
                q.requeue_unschedulable(pod, reasons=("NodeResourcesFit",))
        st.snapshot()  # the snapshot, then a tail past it
        for pod in pods[20:]:
            clock.t += 0.25
            q.add(pod)
        with st.batch():
            for pod in q.pop_ready():
                q.requeue_backoff(pod)
        st.journal.flush()
        live = p.codec.state_digest(q, c)
        st.journal.close()
        for other in BOTH.values():
            q2, c2, stats = other.restore(d)
            assert stats["snapshot"] and stats["records_replayed"] == 11
            assert other.codec.state_digest(q2, c2) == live


# ---- the journal's own rules, on the port -----------------------------------


def _drain(j):
    j.flush()
    j.close()


def test_journal_round_trip_and_bytes_equal_the_reference(tmp_path):
    recs = [("q.add", 1.5, {"pod": {"m": {"n": f"p{i}"}}}) for i in range(8)]
    for side, mod in (("ref", ref_journal), ("port", port_journal)):
        j = mod.Journal(str(tmp_path / side))
        for op, t, data in recs:
            j.append(op, t, data)
        _drain(j)
        assert list(mod.replay_dir(str(tmp_path / side))) == recs
    assert (tmp_path / "ref" / "wal-00000000.seg").read_bytes() == \
        (tmp_path / "port" / "wal-00000000.seg").read_bytes()
    assert encode_record("q.pop", 2.0, {}) == ref_journal.encode_record("q.pop", 2.0, {})
    assert segment_header() == ref_journal.segment_header()


@pytest.mark.parametrize("batch", [False, True])
def test_torn_final_record_discarded_at_every_byte_offset(tmp_path, batch):
    d = str(tmp_path / "src")
    j = Journal(d)
    for i in range(4):
        j.append("q.add", float(i), {"pod": {"m": {"n": f"pod-{i}"}}})
    if batch:
        op, t, data = BATCH_OP, 6.0, encode_batch_payload(
            [("c.assume", 3.0 + k, {"uid": f"default/pod-{k}", "node": "n0"})
             for k in range(4)])
    else:
        op, t, data = "q.add", 4.0, {"pod": {"m": {"n": "pod-4"}}}
    j.append(op, t, data)
    _drain(j)
    (idx,) = segment_indices(d)
    blob = open(segment_path(d, idx), "rb").read()
    final = encode_record(op, t, data)
    start = len(blob) - len(final)
    assert blob[start:] == final
    tpath = segment_path(str(tmp_path), 0)
    for cut in range(start, len(blob)):
        with open(tpath, "wb") as f:
            f.write(blob[:cut])
        got = list(read_segment(tpath))
        assert [r[2]["pod"]["m"]["n"] for r in got] == [f"pod-{i}" for i in range(4)], cut
    with open(tpath, "wb") as f:
        f.write(blob)
    assert list(read_segment(tpath))[-1][0] == op


def test_torn_segment_header_is_empty_and_mid_segment_corruption_raises(tmp_path):
    p = segment_path(str(tmp_path), 0)
    header = segment_header()
    for cut in range(len(header)):
        with open(p, "wb") as f:
            f.write(header[:cut])
        assert list(read_segment(p)) == []
    d = str(tmp_path / "j")
    j = Journal(d)
    for i in range(5):
        j.append("q.add", float(i), {"pod": {"m": {"n": f"pod-{i}"}}})
    _drain(j)
    (idx,) = segment_indices(d)
    sp = segment_path(d, idx)
    blob = bytearray(open(sp, "rb").read())
    blob[len(header) + 8 + 2] ^= 0xFF  # a payload byte of the FIRST record
    with open(sp, "wb") as f:
        f.write(blob)
    with pytest.raises(StateCorruption, match="mid-segment"):
        list(read_segment(sp))
    with pytest.raises(ref_state.StateCorruption, match="mid-segment"):
        list(ref_journal.read_segment(sp))


def test_future_format_and_snapshot_versions_refused(tmp_path):
    from k8s_scheduler_tpu_torch.state.snapshot import (SNAPSHOT_MAGIC, read_snapshot,
                                                        snapshot_path)

    p = segment_path(str(tmp_path), 0)
    body = struct.pack("<8sI", b"TPUSWAL\x00", FORMAT_VERSION + 1)
    with open(p, "wb") as f:
        f.write(body + struct.pack("<I", zlib.crc32(body)))
        f.write(encode_record("q.pop", 0.0, {}))
    with pytest.raises(StateVersionError, match="newer than this build"):
        list(read_segment(p))
    with pytest.raises(StateVersionError):
        list(replay_dir(str(tmp_path)))
    q, c = PORTP.pair(FakeClock())
    with pytest.raises(StateVersionError):
        DurableState(str(tmp_path), snapshot_interval_seconds=0).restore_into(q, c)
    sp = snapshot_path(str(tmp_path / "s"), 0)
    os.makedirs(tmp_path / "s")
    body = b"{}"
    with open(sp, "wb") as f:
        f.write(struct.pack("<8sIII", SNAPSHOT_MAGIC, FORMAT_VERSION + 1,
                            zlib.crc32(body), len(body)))
        f.write(body)
    with pytest.raises(StateVersionError):
        read_snapshot(sp)


def test_segment_rotation_cut_and_prune(tmp_path):
    d = str(tmp_path)
    j = Journal(d, max_segment_bytes=256)
    for i in range(20):
        j.append("q.add", float(i), {"pod": {"m": {"n": f"p{i:02d}"}}})
        if i % 5 == 4:
            j.flush()  # size rotation takes effect at group-commit granularity
    assert len(segment_indices(d)) > 1
    cut = j.cut()
    for i in range(20, 25):
        j.append("q.add", float(i), {"pod": {"m": {"n": f"p{i:02d}"}}})
    _drain(j)
    assert [r[2]["pod"]["m"]["n"] for r in replay_dir(d)] == [f"p{i:02d}" for i in range(25)]
    tail = [r[2]["pod"]["m"]["n"] for r in replay_dir(d, from_index=cut)]
    assert tail == [f"p{i:02d}" for i in range(20, 25)]
    j2 = Journal(d)
    j2.prune(cut)
    j2.close()
    assert [r[2]["pod"]["m"]["n"] for r in replay_dir(d)] == tail


def test_restart_never_appends_into_an_old_segment(tmp_path):
    d = str(tmp_path)
    j1 = Journal(d)
    j1.append("q.add", 0.0, {"pod": {"m": {"n": "a"}}})
    _drain(j1)
    j2 = Journal(d)
    j2.append("q.add", 1.0, {"pod": {"m": {"n": "b"}}})
    _drain(j2)
    assert len(segment_indices(d)) == 2
    assert [r[2]["pod"]["m"]["n"] for r in replay_dir(d)] == ["a", "b"]


def test_append_path_never_fsyncs_on_the_caller_thread(tmp_path, monkeypatch):
    names = []
    real = os.fsync

    def spy(fd):
        names.append(threading.current_thread().name)
        return real(fd)

    monkeypatch.setattr(os, "fsync", spy)
    q, c = PORTP.pair(FakeClock())
    st = DurableState(str(tmp_path), snapshot_interval_seconds=0)
    st.attach(q, c)
    for i in range(50):
        q.add(PORT.MakePod(f"p{i}").req({"cpu": "1"}).obj())
        c.add_node(PORT.MakeNode(f"n{i}").capacity({"cpu": "8"}).obj())
    for p in q.pop_ready()[:10]:
        c.assume(p, "n0")
        c.finish_binding(p.uid)
    st.journal.flush()
    assert names and set(names) == {"journal-writer"}
    st.journal.close()


def test_writer_io_failure_fails_loudly(tmp_path):
    d = str(tmp_path / "j")
    j = Journal(d)
    shutil.rmtree(d)  # the writer's segment open() fails
    j.append("q.pop", 0.0, {})
    with pytest.raises(StateError, match="writer failed"):
        j.flush()
    assert j.failed is not None and j.status()["failed"] is not None
    with pytest.raises(StateError, match="writer failed"):
        j.append("q.pop", 1.0, {})
    j.close()


def test_manager_degrades_to_stateless_on_journal_failure(tmp_path):
    d = str(tmp_path / "state")
    q, c = PORTP.pair(FakeClock())
    st = DurableState(d, snapshot_interval_seconds=0)
    st.attach(q, c)
    q.add(PORT.MakePod("before").obj())
    st.journal.flush()
    shutil.rmtree(d)
    st.journal.cut()  # the next record opens a segment in the gone dir
    q.add(PORT.MakePod("buffered").obj())
    deadline = time.monotonic() + 10
    while st.journal.failed is None:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    q.add(PORT.MakePod("after-failure").obj())  # detaches, does not raise
    assert q._journal is None and c._journal is None
    assert st.status()["sealed"]
    q.add(PORT.MakePod("still-serving").obj())
    assert q.pending_counts()["active"] == 4
    st.journal.close()


def test_open_batch_is_invisible_until_its_scope_exits(tmp_path):
    d = str(tmp_path / "live")
    q, c = PORTP.pair(FakeClock())
    st = DurableState(d, snapshot_interval_seconds=0)
    st.attach(q, c)
    q.add(PORT.MakePod("before").req({"cpu": "1"}).obj())
    st.journal.flush()
    pre = state_digest(q, c)
    (idx,) = segment_indices(d)
    mid, post = str(tmp_path / "mid"), str(tmp_path / "post")
    with st.batch():
        q.add(PORT.MakePod("in-batch-1").req({"cpu": "1"}).obj())
        q.add(PORT.MakePod("in-batch-2").req({"cpu": "1"}).obj())
        st.journal.flush()  # the crash point: nothing of the batch on disk
        os.makedirs(mid)
        shutil.copy(segment_path(d, idx), segment_path(mid, idx))
    st.journal.flush()
    os.makedirs(post)
    shutil.copy(segment_path(d, idx), segment_path(post, idx))
    st.journal.close()
    for side, p in BOTH.items():
        q2, c2, _ = p.restore(mid)
        assert p.codec.state_digest(q2, c2) == pre, side
        q3, c3, _ = p.restore(post)
        assert p.codec.state_digest(q3, c3) == state_digest(q, c), side


def test_debug_state_status_shape_equals_the_reference(tmp_path):
    shapes = {}
    for side, p in BOTH.items():
        q, c = p.pair(FakeClock())
        st = p.state.DurableState(str(tmp_path / side), snapshot_interval_seconds=0)
        st.attach(q, c)
        q.add(p.m.MakePod("p").obj())
        st.journal.flush()
        s = st.status()
        assert s["journal"]["appended"] == s["journal"]["durable"] == 1
        assert s["journal"]["segments"] == 1 and s["last_restore"]["records_replayed"] == 0
        st.snapshot()
        s = st.status()
        assert s["last_snapshot"]["bytes"] > 0
        st.seal()
        s = st.status()
        assert s["sealed"]
        shapes[side] = {k: sorted(v) if isinstance(v, dict) else type(v).__name__
                        for k, v in s.items() if k != "state_dir"}
    assert shapes["port"] == shapes["ref"]


def test_config_state_fields_load_as_the_reference():
    src = ("stateDir: /var/lib/sched\nsnapshotInterval: 90s\nadmissionQueueDepth: 12\n"
           "admissionRetryAfterMs: 40\ntraceSampleRate: 0.5\nblackboxRetention: 3\n"
           "faultSpec: fetch_delay@cycle=2:ms=5\n")
    names = ("state_dir", "snapshot_interval_seconds", "admission_queue_depth",
             "admission_retry_after_ms", "trace_sample_rate", "blackbox_retention", "fault_spec")
    for text in (src, "{}"):
        want = ref_config.load_config(text)
        got = port_config.load_config(text)
        assert {n: getattr(got, n) for n in names} == {n: getattr(want, n) for n in names}


# ---- the Scheduler with state= ---------------------------------------------


def _sched(side, name, clock, rec, state, commit_mode="rounds"):
    core, cfg_mod = (ref_core, ref_config) if side == "ref" else (port_core, port_config)
    kw = {"device": "cpu"} if side == "port" else {}
    s = core.Scheduler(_config(cfg_mod, name, commit_mode), binder=rec.bind,
                       evictor=rec.evict, now=clock, state=state, **kw)
    rec.sched = s
    return s


class Drive:
    """One package's Scheduler with durable state over a fixture's events,
    resumable on a standby built on the same directory."""

    def __init__(self, side, name, state_dir, commit_mode="rounds"):
        self.side, self.name, self.dir, self.mode = side, name, state_dir, commit_mode
        self.m = REF if side == "ref" else PORT
        self.pkg = BOTH[side]
        self.events = SEQUENCES[name](self.m)
        self.pos = 0
        self.clock, self.rec = FakeClock(), Recorder()
        self.s = _sched(side, name, self.clock, self.rec, self._state())
        self.pods_by_name: dict = {}
        self.last_binds: list = []
        self.cycles: list = []
        self.digests: list = []

    def _state(self):
        return self.pkg.state.DurableState(self.dir, snapshot_interval_seconds=0)

    def run(self, max_cycles=None):
        """Apply events up to `max_cycles` more cycles (None = to the end);
        after each cycle the journal is flushed and the digest recorded."""
        done = 0
        s = self.s
        while self.pos < len(self.events):
            if max_cycles is not None and done >= max_cycles:
                break
            op, *args = self.events[self.pos]
            self.pos += 1
            if op == "node_add":
                s.on_node_add(args[0])
            elif op == "pod_add":
                self.pods_by_name[args[0].name] = args[0]
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
                self.clock.t += args[0]
            elif op == "echo_binds":
                for pod_name, node in self.last_binds:
                    s.on_pod_add(self.pods_by_name[pod_name], node)
            elif op == "cycle":
                nb, ne = len(self.rec.binds), len(self.rec.evictions)
                nr = len(s.flight.snapshot())
                st = s.schedule_cycle()
                self.cycles.append(_cycle_record(s, self.rec, st, nb, ne, nr))
                self.last_binds = self.rec.binds[nb:]
                s.state.journal.flush()
                self.digests.append(state_digest_of(s))
                done += 1
            else:
                raise ValueError(op)

    def crash(self):
        """The active dies with its journal flushed (nothing sealed)."""
        self.s.state.journal.flush()
        self.s.state.journal.close()

    def takeover(self, state_dir=None):
        """A standby Scheduler on the directory continues the events."""
        self.rec = Recorder()
        self.s = _sched(self.side, self.name, self.clock, self.rec,
                        self.pkg.state.DurableState(state_dir or self.dir,
                                                    snapshot_interval_seconds=0))
        return self.s


def state_digest_of(s):
    return port_codec.state_digest(s.queue, s.cache)


def _journal(d):
    return list(replay_dir(d))


@functools.cache
def _takeover(tmp_root: str, name: str, commit_mode: str):
    """Both packages over fixture `name`: the active runs two cycles and
    crashes, a standby built on its directory runs the rest. Returns
    {side: (per-cycle digests, per-cycle records, standby digest at
    construction, bare-restore digest, its recover-applied digest,
    standby records after takeover, journal)}."""
    out = {}
    for side in ("ref", "port"):
        d = os.path.join(tmp_root, f"{name}-{commit_mode}-{side}")
        dr = Drive(side, name, d, commit_mode)
        # the active crashes after its second cycle, or before its last
        n_crash = min(2, sum(1 for e in dr.events if e[0] == "cycle") - 1)
        dr.run(max_cycles=n_crash)
        pre_cycles, pre_digests = list(dr.cycles), list(dr.digests)
        dr.crash()
        q, c, _ = dr.pkg.restore(d, scheduler_defaults=True)
        bare = dr.pkg.codec.state_digest(q, c)
        in_flight = len(q._in_flight)
        q._now = lambda: dr.clock.t  # the standby's clock
        q.recover_in_flight()
        recovered = dr.pkg.codec.state_digest(q, c)
        standby = dr.takeover()
        at_ctor = state_digest_of(standby)
        dr.run()
        dr.s.state.journal.flush()
        dr.s.state.journal.close()
        out[side] = {"pre_digests": pre_digests, "pre_cycles": pre_cycles, "bare": bare,
                     "in_flight": in_flight, "recovered": recovered, "at_ctor": at_ctor,
                     "post_cycles": dr.cycles[n_crash:], "post_digests": dr.digests[n_crash:],
                     "journal": _journal(d)}
    return out


TAKEOVER_CASES = [("pipeline_workload", "rounds"), ("churn", "rounds"),
                  ("pipeline_workload", "scan")]


@pytest.fixture(scope="module")
def state_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("sched-state"))


@pytest.mark.parametrize("name,commit_mode", TAKEOVER_CASES)
def test_scheduler_digests_and_journal_equal_the_reference(state_root, name, commit_mode):
    r = _takeover(state_root, name, commit_mode)
    assert r["port"]["pre_digests"] == r["ref"]["pre_digests"]
    assert r["port"]["pre_cycles"] == r["ref"]["pre_cycles"]
    assert r["port"]["journal"] == r["ref"]["journal"]
    ops = {op for op, _t, _d in r["port"]["journal"]}
    assert {"q.add", "q.pop", "c.add_node", BATCH_OP} <= ops


@pytest.mark.parametrize("name,commit_mode", TAKEOVER_CASES)
def test_standby_restores_exact_state_and_recovers_in_flight(state_root, name, commit_mode):
    """The standby's constructor restores the crashed active's last
    flushed digest and then requeues its in-flight pods (journaled): its
    digest is the bare restore's with `recover_in_flight` applied, in
    both packages alike."""
    r = _takeover(state_root, name, commit_mode)
    for side in ("ref", "port"):
        x = r[side]
        assert x["bare"] == x["pre_digests"][-1], side
        assert x["at_ctor"] == x["recovered"], side
        assert x["in_flight"] > 0, side
    assert r["port"]["at_ctor"] == r["ref"]["at_ctor"]


@pytest.mark.parametrize("name,commit_mode", TAKEOVER_CASES)
def test_decisions_and_events_after_takeover_equal_the_reference(state_root, name,
                                                                  commit_mode):
    r = _takeover(state_root, name, commit_mode)
    assert r["port"]["post_cycles"] == r["ref"]["post_cycles"]
    assert r["port"]["post_digests"] == r["ref"]["post_digests"]
    assert len(r["port"]["post_cycles"]) >= 1 and sum(
        len(c["binds"]) for c in r["port"]["post_cycles"]) + sum(
        len(c["binds"]) for c in r["port"]["pre_cycles"]) > 0


def test_port_standby_restores_a_reference_directory(state_root):
    """A port Scheduler built on the reference active's directory restores
    the reference standby's exact state."""
    r = _takeover(state_root, "churn", "rounds")
    d = os.path.join(state_root, "churn-rounds-ref")
    copy = os.path.join(state_root, "churn-rounds-ref-copy")
    shutil.copytree(d, copy)
    s = port_core.Scheduler(_config(port_config, "churn", "rounds"), now=FakeClock(),
                            state=DurableState(copy, snapshot_interval_seconds=0),
                            device="cpu")
    q, c, _ = REFP.restore(d, scheduler_defaults=True)
    want = ref_codec.state_digest(q, c)  # the reference's final state
    s.queue.recover_in_flight()  # idempotent: the ctor already recovered
    q.recover_in_flight()
    assert state_digest_of(s) == ref_codec.state_digest(q, c)
    assert want and r["ref"]["journal"]
    s.state.journal.close()


def test_scheduler_ctor_attaches_and_standby_restores(tmp_path):
    """The reference's case on the port: informer-driven mutations are
    journaled, and a standby built on the directory restores them in its
    constructor, before any cycle."""
    digests = {}
    for side, p in BOTH.items():
        d = str(tmp_path / side)
        clock = FakeClock()
        rec = Recorder()
        active = _sched(side, "churn", clock, rec, p.state.DurableState(
            d, snapshot_interval_seconds=0))
        active.on_node_add(p.m.MakeNode("n0").capacity({"cpu": "8"}).obj())
        for i in range(5):
            clock.t += 0.5
            active.on_pod_add(p.m.MakePod(f"p{i}").req({"cpu": "1"}).obj())
        active.on_pod_add(p.m.MakePod("bound").req({"cpu": "1"}).obj(), node_name="n0")
        active.on_pod_delete("default/p3")
        active.state.journal.flush()
        live = p.codec.state_digest(active.queue, active.cache)
        active.state.journal.close()
        standby = _sched(side, "churn", FakeClock(), Recorder(), p.state.DurableState(
            d, snapshot_interval_seconds=0))
        assert p.codec.state_digest(standby.queue, standby.cache) == live
        assert standby.queue.pending_counts()["active"] == 4
        assert standby.cache.counts() == {"nodes": 1, "bound": 1, "assumed": 0}
        digests[side] = live
        standby.state.journal.close()
    assert digests["port"] == digests["ref"]


def test_records_after_seal_survive_the_next_takeover(tmp_path):
    d = str(tmp_path)
    q, c = PORTP.pair(FakeClock())
    st = DurableState(d, snapshot_interval_seconds=0)
    st.attach(q, c)
    q.add(PORT.MakePod("a").req({"cpu": "1"}).obj())
    st.seal()
    clock2 = FakeClock()
    clock2.t = 2000.0
    q2, c2 = PORTP.pair(clock2)
    st2 = DurableState(d, snapshot_interval_seconds=0)
    st2.attach(q2, c2)
    q2.add(PORT.MakePod("b").req({"cpu": "1"}).obj())
    st2.journal.flush()
    for p in BOTH.values():  # process B died; either package takes over
        q3, c3, stats = p.restore(d)
        assert stats["records_replayed"] == 1
        assert q3.pending_counts()["active"] == 2
        assert p.codec.state_digest(q3, c3) == state_digest(q2, c2)
    st2.journal.close()


def test_seal_then_takeover_replays_nothing(tmp_path):
    d = str(tmp_path)
    q, c = PORTP.pair(FakeClock())
    st = DurableState(d, snapshot_interval_seconds=0)
    st.attach(q, c)
    for i in range(10):
        q.add(PORT.MakePod(f"p{i}").req({"cpu": "1"}).obj())
    st.seal()
    for p in BOTH.values():
        q2, c2, stats = p.restore(d)
        assert stats["clean_shutdown"] is True and stats["records_replayed"] == 0
        assert p.codec.state_digest(q2, c2) == state_digest(q, c)


# ---- SIGKILL failover: a port child process on the CPU ----------------------

_CHILD = r"""
import json, sys, time
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[2])
from k8s_scheduler_tpu_torch.config import SchedulerConfiguration
from k8s_scheduler_tpu_torch.core import Scheduler
from k8s_scheduler_tpu_torch.state import DurableState, state_digest
from k8s_scheduler_tpu_torch.utils.synth import make_cluster, make_pods

d = sys.argv[1]
t = [0.0]
binds = []
s = Scheduler(SchedulerConfiguration(pad_existing=64, pad_pods_per_node=16),
              binder=lambda p, n: binds.append((p.uid, n)), now=lambda: t[0],
              state=DurableState(d, snapshot_interval_seconds=0), device="cpu")
for nd in make_cluster(6, seed=1, cpu_choices=(4, 8)):
    s.on_node_add(nd)
log = open(d + "/digests.txt", "a")
for c in range(3):
    for p in make_pods(12, seed=40 + c, name_prefix=f"k{c}-"):
        s.on_pod_add(p)
    t[0] += 1.0
    st = s.schedule_cycle()
    s.state.journal.flush()
    log.write(json.dumps({"cycle": c, "digest": state_digest(s.queue, s.cache),
                          "binds": len(binds)}) + "\n")
    log.flush()
    if c == 1:
        log.write("done\n")
        log.flush()
        while True:
            time.sleep(1)
"""


def test_sigkill_failover_standby_restores_the_last_digest(tmp_path):
    d = str(tmp_path / "state")
    os.makedirs(d)
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    child = subprocess.Popen([sys.executable, "-c", _CHILD, d, REPO], env=env)
    log = os.path.join(d, "digests.txt")
    try:
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            if os.path.exists(log) and "done" in open(log).read().split():
                break
            assert child.poll() is None, "the child died early"
            time.sleep(0.05)
        else:
            pytest.fail("the child never reached its second flush")
    finally:
        child.send_signal(signal.SIGKILL)
        child.wait()
    lines = [json.loads(x) for x in open(log).read().split("\n") if x.startswith("{")]
    assert [x["cycle"] for x in lines] == [0, 1] and lines[-1]["binds"] > 0
    for p in BOTH.values():
        q, c, stats = p.restore(d, scheduler_defaults=True)
        assert p.codec.state_digest(q, c) == lines[-1]["digest"]
        assert stats["records_replayed"] > 0
    standby = port_core.Scheduler(port_config.SchedulerConfiguration(
        pad_existing=64, pad_pods_per_node=16), now=FakeClock(),
        state=DurableState(d, snapshot_interval_seconds=0), device="cpu")
    q, c, _ = PORTP.restore(d, scheduler_defaults=True)
    q.recover_in_flight()
    assert state_digest_of(standby) == state_digest(q, c)
    standby.state.journal.close()
