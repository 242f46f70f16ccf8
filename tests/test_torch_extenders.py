"""HTTP extenders and their verdicts: the port against the reference.

A deterministic webhook on `http.server` in a thread (the reference's
`tests/test_host_extensions.py` style) serves both packages' extenders.
Its mode is the first part of the path: `h` filters out the nodes where a
hash of (pod uid, node name) is 0 mod 8 and prioritizes each node with
that hash mod 11; `err` answers every verb with an Error (which the
prioritize verb ignores, as the reference's client does); `down` answers
503; `deny-<node>` filters out that node; `bind` verbs are recorded in
order.

- The `Scheduler` event for event (`test_torch_scheduler.drive`) with
  `carryVerdicts` true (the carry path, `ExtenderVerdictKeeper`) and false
  (the packed path: the prepass's planes in the snapshot), an ignorable
  extender that fails beside a working one, a non-ignorable one that fails
  (BindError, backoff), and a bind-verb extender (its calls in order).
- The static base with the verdicts against the reference's compiled
  base: every combination of the three static score terms at weights 0, 1
  and 3, with and without the extender's score, in the rounds engine's
  and the scan's arithmetic (standalone programs that compile the same
  fusions), and the base the reference's cycles actually compute (read
  off inside the running program) for the default profile, the lone
  products and an extender weight that crosses K1's 1e6 clip.
- `build_cycle_fn` in both engines (full and latency outputs) and
  `build_packed_cycle_fn` on a snapshot with verdicts, the carry cycle and
  the diagnosis program with `extender_args`, node sampling on.
- `ExtenderVerdictKeeper`'s planes and errors over a dirty sequence with
  an errored slot that recovers and a regime change.
- K18's and K16's plain versions against the reference's compositions.
- The reference's packed preemption nominates onto a node the pod's
  extender filtered out (its gate reads no verdict); the port does the same
  (ROADMAP C, a reference-side observation).

Every comparison is exact: integers and bools equal, floats by their bits."""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import itertools
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k8s_scheduler_tpu.config as ref_config
import k8s_scheduler_tpu.config.types as ref_types
import k8s_scheduler_tpu.core as ref_core
import k8s_scheduler_tpu.core.cycle as ref_cycle
import k8s_scheduler_tpu.framework.interfaces as ref_if
import k8s_scheduler_tpu.framework.runtime as ref_rt
import k8s_scheduler_tpu.models as ref_models
import k8s_scheduler_tpu.models.packing as ref_packing
import k8s_scheduler_tpu.ops.commit as ref_commit
import k8s_scheduler_tpu.ops.rounds as ref_rounds
import k8s_scheduler_tpu.utils.synth as ref_synth
import k8s_scheduler_tpu_torch.config as port_config
import k8s_scheduler_tpu_torch.core as port_core
import k8s_scheduler_tpu_torch.models as port_models
import k8s_scheduler_tpu_torch.utils.synth as port_synth
from k8s_scheduler_tpu_torch.core import cycle as port_cycle
from k8s_scheduler_tpu_torch.framework.interfaces import CycleContext
from k8s_scheduler_tpu_torch.framework.runtime import Framework
from k8s_scheduler_tpu_torch.models import packing
from k8s_scheduler_tpu_torch.models.encoding import AUX_FIELDS, snapshot_from_numpy
from k8s_scheduler_tpu.framework.host import HTTPExtender as RefExt
from k8s_scheduler_tpu_torch.framework.host import HTTPExtender as PortExt
from k8s_scheduler_tpu_torch.ops import extender_merge, static_base
from k8s_scheduler_tpu_torch.ops import rounds as port_rounds
from test_torch_carry import RESULT, _bits, _same
from test_torch_scheduler import FIELDS, drive
from torch_one_thread import one_torch_thread  # noqa: F401

NEG_INF = -1e9


def _h(uid: str, node: str) -> int:
    return int.from_bytes(hashlib.sha256(f"{uid}|{node}".encode()).digest()[:4], "little")


class _Webhook(BaseHTTPRequestHandler):
    binds: list = []
    calls: list = []

    def do_POST(self):  # noqa: N802
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        _, mode, verb = self.path.split("/")
        type(self).calls.append((mode, verb, body.get("Pod", {}).get("metadata", {})
                                 .get("name", body.get("PodName"))))
        if mode == "down":
            self.send_error(503)
            return
        if mode == "err":
            out = {"Error": f"{verb} refused"}
        elif verb == "bind":
            type(self).binds.append((body["PodName"], body["Node"]))
            out = {}
        elif verb == "filter":
            uid = body["Pod"]["metadata"]["uid"]
            keep = ((lambda n: _h(uid, n) % 8 != 0) if mode == "h"
                    else (lambda n: n != mode[len("deny-"):]))
            out = {"NodeNames": [n for n in body["NodeNames"] if keep(n)]}
        else:
            uid = body["Pod"]["metadata"]["uid"]
            out = {"Items": [{"Host": n, "Score": _h(uid, n) % 11 if mode == "h" else 0}
                             for n in body["NodeNames"]]}
        data = json.dumps(out).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


class _Server(ThreadingHTTPServer):
    # the prepass's 16 workers connect at once: a deeper listen queue than
    # socketserver's 5, which resets the connections past it
    request_queue_size = 128
    daemon_threads = True


@pytest.fixture(scope="module")
def webhook():
    srv = _Server(("127.0.0.1", 0), _Webhook)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join(5)


def _ext_config(cfg_mod):
    """The side's `Extender` configuration class."""
    return ref_types.Extender if cfg_mod is ref_config else port_config.Extender


def _extenders(url: str, specs) -> "callable":
    """configure() for `drive`: the extenders `specs` [(mode, kwargs)]."""
    def configure(cfg_mod, cfg):
        return dataclasses.replace(cfg, extenders=[
            _ext_config(cfg_mod)(f"{url}/{mode}", **kw) for mode, kw in specs])
    return configure


HASH = ("h", dict(filter_verb="filter", prioritize_verb="prioritize", weight=3))


def _hash_ext(carry: bool):
    mode, kw = HASH
    return [(mode, dict(kw, carry_verdicts=carry))]


# ---- the Scheduler, event for event ------------------------------------------

SCHED_CASES = {
    # name: (fixture, commit mode, extender specs)
    "workload_carry": ("pipeline_workload", "rounds", _hash_ext(True)),
    "workload_packed": ("pipeline_workload", "rounds", _hash_ext(False)),
    "churn_carry": ("churn", "rounds", _hash_ext(True)),
    "workload_scan": ("pipeline_workload", "scan", _hash_ext(False)),
    "ignorable_failure": ("pipeline_workload", "rounds", _hash_ext(True) + [
        ("err", dict(filter_verb="filter", prioritize_verb="prioritize", ignorable=True,
                     carry_verdicts=True))]),
    "nonignorable_failure_carry": ("pipeline_workload", "rounds", [
        ("err", dict(filter_verb="filter", carry_verdicts=True))]),
    "nonignorable_failure_packed": ("pipeline_workload", "rounds", [
        ("down", dict(prioritize_verb="prioritize"))]),
}


@functools.cache
def _sched(side: str, case: str, url: str):
    name, commit_mode, specs = SCHED_CASES[case]
    return drive(side, name, commit_mode, configure=_extenders(url, specs))


@pytest.mark.parametrize("case", list(SCHED_CASES))
@pytest.mark.parametrize("field", FIELDS)
def test_scheduler_with_extenders_matches_reference(webhook, case, field):
    want = _sched("ref", case, webhook)
    got = _sched("port", case, webhook)
    assert len(got) == len(want)
    for c, (g, w) in enumerate(zip(got, want)):
        assert g[field] == w[field], f"{case} cycle {c}: {field}"


@pytest.mark.parametrize("case", list(SCHED_CASES))
def test_extender_fixtures_exercise_what_they_claim(webhook, case):
    cycles = _sched("port", case, webhook)
    stats = [c["stats"] for c in cycles]
    if case.startswith("nonignorable"):
        assert sum(s["scheduled"] for s in stats) == 0
        assert stats[0]["bind_errors"] == stats[0]["attempted"] > 0
        assert cycles[0]["queue"].get("backoff", 0) > 0
    else:
        assert sum(s["scheduled"] for s in stats) > 0
    if case == "workload_carry":
        assert stats[0]["preemptors"] > 0 and stats[0]["gang_dropped"] > 0


def test_carry_verdicts_choose_the_program_chain(webhook):
    on = port_config.SchedulerConfiguration(extenders=[
        port_config.Extender(f"{webhook}/h", filter_verb="filter", carry_verdicts=True)])
    mixed = dataclasses.replace(on, extenders=on.extenders + [
        port_config.Extender(f"{webhook}/h", prioritize_verb="prioritize")])
    assert port_core.Scheduler(on, device="cpu")._use_carry
    assert not port_core.Scheduler(mixed, device="cpu")._use_carry
    assert not port_core.Scheduler(dataclasses.replace(on, commit_mode="scan"),
                                   device="cpu")._use_carry


@functools.cache
def _bind_run(side: str, url: str):
    """Three nodes, four pods, a bind-verb extender beside the hash one:
    the extender's bind calls in order, and the injected binder's."""
    _Webhook.binds = []
    m = ref_models if side == "ref" else port_models
    core, cfg_mod = (ref_core, ref_config) if side == "ref" else (port_core, port_config)
    cfg = cfg_mod.SchedulerConfiguration(extenders=[
        _ext_config(cfg_mod)(f"{url}/h", filter_verb="filter", prioritize_verb="prioritize",
                             bind_verb="bind", weight=2, carry_verdicts=True)])
    bound = []
    kw = {"device": "cpu"} if side == "port" else {}
    s = core.Scheduler(cfg, binder=lambda p, n: bound.append((p.name, n)),
                       now=lambda: 0.0, **kw)
    for i in range(3):
        s.on_node_add(m.MakeNode(f"n{i}").capacity({"cpu": "4"}).obj())
    for j in range(4):
        s.on_pod_add(m.MakePod(f"p{j}").req({"cpu": "1"}).created(float(j)).obj())
    st = s.schedule_cycle()
    return list(_Webhook.binds), bound, st.scheduled


def test_bind_verb_extender_binds_in_place_of_the_binder(webhook):
    want = _bind_run("ref", webhook)
    got = _bind_run("port", webhook)
    assert got == want
    assert got[2] == 4 and len(got[0]) == 4 and got[1] == []


# ---- the verdicts' arithmetic in the static base -----------------------------


def _objects(m, n_nodes=24, n_pods=40):
    """Static scores with inexact products: nodes with 0-3 PreferNoSchedule
    taints (TaintToleration's fractions), preferred node affinity of
    several weights, images of odd sizes."""
    nodes = []
    for i in range(n_nodes):
        b = m.MakeNode(f"n{i}").capacity({"cpu": "8", "memory": "16Gi"}).labels(
            {"zone": f"z{i % 3}", "rack": f"r{i % 5}"})
        for t in range(i % 4):
            b.taint(f"soft{t}", "x", "PreferNoSchedule")
        if i % 3 == 0:
            b.image("img-a", 500 * 2**20 + i * 7919)
        nodes.append(b.obj())
    pods = []
    for j in range(n_pods):
        b = m.MakePod(f"p{j}").req({"cpu": "500m"}, image=["img-a", ""][j % 2]).created(float(j))
        b.node_affinity_preferred(7 + j % 5, "zone", [f"z{j % 3}"])
        b.node_affinity_preferred(13, "rack", [f"r{j % 5}", f"r{(j + 2) % 5}"])
        if j % 3 == 0:
            b.toleration("soft0", "x", "PreferNoSchedule")
        pods.append(b.obj())
    return nodes, pods


def _planes(snap, nodes, pods, weight: float):
    """The hash webhook's verdicts as the packed path carries them: mask
    True and score 0 on the pads."""
    P, N = snap.P, snap.N
    em = np.ones((P, N), bool)
    es = np.zeros((P, N), np.float32)
    for p, pod in enumerate(pods):
        for n, node in enumerate(nodes):
            h = _h(pod.uid, node.name)
            em[p, n] = h % 8 != 0
            es[p, n] = np.float32(float(h % 11) * weight)
    return em, es


@functools.cache
def _snapshots(weight: float = 3.0):
    """(reference snapshot with verdicts, port twin, the plain one, its twin)."""
    nodes, pods = _objects(ref_models)
    snap = ref_models.SnapshotEncoder().encode(nodes, pods, [], [])
    em, es = _planes(snap, nodes, pods, weight)
    esnap = dataclasses.replace(snap, has_extender=True, pod_extender_mask=em,
                                pod_extender_score=es)
    return tuple((s, snapshot_from_numpy(s.array_fields(), {k: getattr(s, k) for k in AUX_FIELDS},
                                         device="cpu")) for s in (esnap, snap))


def _profile(cfg, ws):
    """A profile whose static scores are ImageLocality, NodeAffinity and
    TaintToleration at weights `ws` (0: off), in that order."""
    E = cfg.PluginEntry
    names = ["ImageLocality", "NodeAffinity", "TaintToleration"]
    return cfg.SchedulerConfiguration(profiles=[cfg.Profile(plugins=cfg.Plugins(
        score=cfg.PluginSet(disabled=names, enabled=[E(n, w) for n, w in zip(names, ws) if w])))])


def _ref_static_jit(rfw, clip: bool):
    """The reference's static base with the verdicts as the engines'
    compiled programs compute it: the rounds engine's in a fusion ending in
    the where and the clip, the scan's static score (its input, a fusion
    ending in the add) with its mask."""
    def base(s):
        m, sc = rfw.static_lean(ref_if.CycleContext(s))
        if s.has_extender:
            m = m & s.pod_extender_mask
            sc = sc + s.pod_extender_score
        if clip:
            return jnp.where(m, jnp.clip(sc, -1e6, 1e6), ref_rounds.NEG_INF)
        return m, sc
    return jax.jit(base)


def _masked(m, sc):
    return np.where(np.asarray(m), np.asarray(sc), np.float32(NEG_INF)).astype(np.float32)


@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("clip", [True, False], ids=["rounds", "scan"])
def test_static_base_arithmetic_matches_reference(ext, clip):
    """K1's plain version against the reference's compiled base for every
    combination of the three terms at weights 0, 1 and 3: the rounds
    engine rounds each product and adds them in order, the scan fuses
    products as `static_base.scan_sum_steps` says."""
    (rs, ps), (rs0, ps0) = _snapshots()
    rsnap, psnap = (rs, ps) if ext else (rs0, ps0)
    bad = {}
    for ws in itertools.product((0, 1, 3), repeat=3):
        out = _ref_static_jit(ref_rt.Framework.from_config(_profile(ref_config, ws)), clip)(rsnap)
        want = np.asarray(out) if clip else _masked(*out)
        fw = Framework.from_config(_profile(port_config, ws))
        got = static_base.static_base_plain(static_base.static_base_inputs(
            fw, CycleContext(psnap), clip=clip)).numpy()
        n = int((got.view(np.int32) != want.view(np.int32)).sum())
        if n:
            bad[ws] = n
    assert not bad


@pytest.fixture
def captured_base(monkeypatch):
    """The static base inside the reference's running cycle: its rounds
    base (materialized for the round loop) and its scan inputs, read by a
    debug callback that changes no fusion."""
    seen = {}
    rounds_commit, greedy_commit = ref_rounds.rounds_commit, ref_commit.greedy_commit

    def rounds_spy(*, snap, static_mask=None, static_score=None, sbase=None, **kw):
        if sbase is None:
            sbase = jnp.where(static_mask, jnp.clip(static_score, -1e6, 1e6), ref_rounds.NEG_INF)
        jax.debug.callback(lambda b: seen.__setitem__("rounds", np.asarray(b)), sbase)
        return rounds_commit(snap=snap, sbase=sbase, **kw)

    def scan_spy(*, static_mask, static_score, **kw):
        jax.debug.callback(lambda m, s: seen.__setitem__("scan", _masked(m, s)),
                           static_mask, static_score)
        return greedy_commit(static_mask=static_mask, static_score=static_score, **kw)

    monkeypatch.setattr(ref_rounds, "rounds_commit", rounds_spy)
    monkeypatch.setattr(ref_commit, "greedy_commit", scan_spy)
    return seen


CYCLE_PROFILES = {"default": None, "lone_taint3": (0, 0, 3), "lone_pref3": (0, 3, 0),
                  "img_pref3": (1, 3, 0)}


def _fws(name):
    ws = CYCLE_PROFILES[name]
    if ws is None:
        return ref_rt.Framework.from_config(), Framework.from_config()
    return (ref_rt.Framework.from_config(_profile(ref_config, ws)),
            Framework.from_config(_profile(port_config, ws)))


@pytest.mark.parametrize("weight", [3.0, 200000.0], ids=["w3", "w200000"])
@pytest.mark.parametrize("profile", list(CYCLE_PROFILES))
@pytest.mark.parametrize("engine", ["rounds", "scan"])
def test_cycle_with_verdicts_matches_reference(captured_base, engine, profile, weight):
    """`build_cycle_fn` on a snapshot with verdicts, full outputs: every
    field bit-equal, and the static base the reference's cycle computed
    equal to K1's plain version (the extender weight 200000 puts scores
    past the 1e6 clip)."""
    (rsnap, psnap), _ = _snapshots(weight)
    rfw, fw = _fws(profile)
    want = ref_cycle.build_cycle_fn(rfw, commit_mode=engine)(rsnap)
    got = port_cycle.build_cycle_fn(fw, commit_mode=engine, device="cpu")(psnap)
    _same(got, want, RESULT)
    x = static_base.static_base_inputs(fw, CycleContext(psnap), clip=engine == "rounds",
                                       sampling=port_cycle.sampling_window(psnap, 0))
    base = static_base.static_base_plain(x).numpy()
    assert np.array_equal(_bits(base), _bits(captured_base[engine]))
    assert (got.assignment >= 0).any()
    if weight > 1e5:
        assert float(np.abs(rsnap.pod_extender_score).max()) > 1e6
    # every placement on a node the filter passed
    a = got.assignment.numpy()
    placed = np.flatnonzero(a >= 0)
    assert np.asarray(rsnap.pod_extender_mask)[placed, a[placed]].all()


@pytest.mark.parametrize("engine", ["rounds", "scan"])
def test_latency_and_packed_cycles_with_verdicts_match_reference(engine):
    (rsnap, psnap), _ = _snapshots()
    want = ref_cycle.build_cycle_fn(commit_mode=engine, outputs="latency")(rsnap)
    got = port_cycle.build_cycle_fn(commit_mode=engine, outputs="latency", device="cpu")(psnap)
    _same(got, want, ("assignment", "node_requested", "unschedulable", "gang_dropped"))
    rspec = ref_packing.make_spec(rsnap)
    want = ref_cycle.build_packed_cycle_fn(rspec, commit_mode=engine)(
        *ref_packing.pack(rsnap, rspec))
    spec = packing.make_spec(psnap)
    w, b = packing.pack(psnap, spec)
    got = port_cycle.build_packed_cycle_fn(spec, commit_mode=engine, device="cpu")(
        torch.from_numpy(w.view(np.int32)), torch.from_numpy(b))
    _same(got, want, RESULT)
    assert packing.respec(spec, {"P": 2 * psnap.P}) is None


# ---- the carry cycle, the diagnosis and the verdict keeper -------------------


def _sampled_objects(m, synth):
    """150 nodes (past the sampling floor of 100), 90 pods and 6 that no
    node fits."""
    nodes = synth.make_cluster(150, taint_fraction=0.2, cpu_choices=(2, 4))
    pods = synth.make_pods(90, seed=11, selector_fraction=0.3, toleration_fraction=0.3)
    pods += [m.MakePod(f"huge{i}").req({"cpu": "64"}).created(100.0 + i).obj()
             for i in range(6)]
    return nodes, pods


@pytest.mark.parametrize("pct", [100, 30])
def test_carry_cycle_and_diagnosis_with_verdicts_match_reference(pct):
    """The carry cycle with `extender_args` (K18 over the carried base,
    node sampling at `pct`) and the diagnosis with `extender_args` (K16 from
    node_valid & emask[ids]), bit-equal to the reference's on one frame."""
    outs = {}
    for side, m, synth in (("ref", ref_models, ref_synth), ("port", port_models, port_synth)):
        nodes, pods = _sampled_objects(m, synth)
        if side == "ref":
            w, b, spec, snap, dirty = m.SnapshotEncoder().encode_packed(nodes, pods, [])
            em, es = _planes(snap, nodes, pods, 3.0)
            stable = ref_cycle.build_stable_state_fn(spec)(w, b)
            carry = ref_cycle.CarryKeeper(spec).state(w, b, stable, dirty, None)
            cyc = ref_cycle.build_packed_cycle_carry_fn(
                spec, extender_args=True, percentage_of_nodes_to_score=pct)
            res = cyc(w, b, stable, carry, jnp.asarray(em), jnp.asarray(es))
            diag = ref_cycle.build_diagnosis_fn(spec, extender_args=True)(
                w, b, stable, res.assignment, res.node_requested, res.pv_claimed,
                jnp.asarray(em))
        else:
            frame = m.SnapshotEncoder(device="cpu").encode_packed(nodes, pods, [])
            w, b, spec = frame.wbuf, frame.bbuf, frame.spec
            em, es = _planes(frame.snap, nodes, pods, 3.0)
            stable = port_cycle.build_stable_state_fn(spec, device="cpu")(w, b)
            carry = port_cycle.CarryKeeper(spec, device="cpu").state(w, b, stable, None, None)
            cyc = port_cycle.build_packed_cycle_carry_fn(
                spec, extender_args=True, percentage_of_nodes_to_score=pct, device="cpu")
            res = cyc(w, b, stable, carry, torch.from_numpy(em), torch.from_numpy(es))
            diag = port_cycle.build_diagnosis_fn(spec, extender_args=True, device="cpu")(
                w, b, stable, res.assignment, res.node_requested, res.pv_claimed,
                torch.from_numpy(em))
        outs[side] = (res, diag, em)
    (want, wdiag, em), (got, gdiag, _) = outs["ref"], outs["port"]
    _same(got, want, RESULT)
    assert np.array_equal(gdiag.numpy(), np.asarray(wdiag))
    a = got.assignment.numpy()
    placed = np.flatnonzero(a >= 0)
    assert len(placed) and em[placed, a[placed]].all()
    assert int((gdiag.numpy() > 0).sum()) > 0


def test_verdict_keeper_matches_reference(webhook):
    """Both keepers over one frame sequence: a full sweep, an update of
    changed slots, an errored slot carried and retried until its webhook
    recovers, a regime change; the planes and errors equal after each."""
    nodes_r, pods_r = _objects(ref_models, 12, 30)
    nodes_p, pods_p = _objects(port_models, 12, 30)
    spec_r = ref_models.SnapshotEncoder().encode_packed(nodes_r, pods_r, [])[2]
    spec_p = port_models.SnapshotEncoder(device="cpu").encode_packed(nodes_p, pods_p, [])[2]
    kr, kp = ref_cycle.ExtenderVerdictKeeper(spec_r), port_cycle.ExtenderVerdictKeeper(
        spec_p, device="cpu")
    assert kp.bucket == kr.bucket and (kp.P, kp.N) == (kr.P, kr.N)

    def ext(cls, cfg_mod, mode):
        return [cls(_ext_config(cfg_mod)(f"{webhook}/{mode}", filter_verb="filter",
                                         prioritize_verb="prioritize", weight=3))]

    # (webhook mode of the extender, dirty slots, regime key)
    steps = [("h", None, "a"), ("h", [3, 7], "a"), ("err", [5], "a"), ("h", [], "a"),
             ("h", [1], "b"), ("h", list(range(kp.bucket + 1)), "b")]
    for mode, dirty, key in steps:
        mr, sr = kr.state(ext(RefExt, ref_config, mode), pods_r, nodes_r, dirty, key)
        mp, sp = kp.state(ext(PortExt, port_config, mode), pods_p, nodes_p, dirty, key)
        assert np.array_equal(mp.numpy(), np.asarray(mr)), (mode, dirty, key)
        assert np.array_equal(_bits(sp), _bits(np.asarray(sr))), (mode, dirty, key)
        assert kp.errors == kr.errors, (mode, dirty, key)
    assert kp.last == "sweep"


# ---- K18 and K16's per-pod base against the reference's compositions --------


@pytest.mark.parametrize("pct", [100, 0, 30])
def test_extender_merge_plain_matches_reference(pct):
    nodes, pods = _sampled_objects(ref_models, ref_synth)
    snap = ref_models.SnapshotEncoder().encode(nodes, pods, [], [])
    em, es = _planes(snap, nodes, pods, 3.0)
    rng = np.random.default_rng(19)
    sbase = np.where(rng.random(em.shape) < 0.8, rng.normal(0, 40, em.shape),
                     NEG_INF).astype(np.float32)

    def ref(s, sb_, m, e):
        out = jnp.where(m, sb_ + e, ref_rounds.NEG_INF)
        if pct < 100:
            out = jnp.where(ref_cycle.sampling_mask(s, pct), out, ref_rounds.NEG_INF)
        return out
    want = np.asarray(jax.jit(ref)(snap, sbase, em, es))
    port = snapshot_from_numpy(snap.array_fields(), {k: getattr(snap, k) for k in AUX_FIELDS},
                               device="cpu")
    t = torch.from_numpy
    got = extender_merge.extender_merge(t(sbase), t(em), t(es),
                                        port_cycle.sampling_params(port, pct))
    assert np.array_equal(_bits(got), _bits(want))
    if pct < 100:  # the window alone, the main path's carry cycle
        alone = extender_merge.extender_merge(t(sbase), None, None,
                                              port_cycle.sampling_params(port, pct))
        mask = np.asarray(ref_cycle.sampling_mask(snap, pct))
        assert np.array_equal(_bits(alone), _bits(np.where(mask, sbase, np.float32(NEG_INF))))


def test_static_rejects_per_pod_base_matches_reference():
    """K16's plain version with `base=(emask, ids)` against the reference
    diagnosis window's composition: attribution from node_valid &
    emask[ids], and the survivors plane."""
    nodes, pods = _sampled_objects(ref_models, ref_synth)
    rsnap = ref_models.SnapshotEncoder().encode(nodes, pods, [], [])
    em, _ = _planes(rsnap, nodes, pods, 3.0)
    psnap = snapshot_from_numpy(rsnap.array_fields(), {k: getattr(rsnap, k) for k in AUX_FIELDS},
                                device="cpu")
    ids = np.random.default_rng(5).permutation(rsnap.P)[:24].astype(np.int32)
    rows = np.arange(24) % 3 != 0
    rfw = ref_rt.Framework.from_config()

    def ref(s, ids_, rows_, em_):
        vs = ref_rounds._pod_view(s, ids_)
        ctx = ref_if.CycleContext(vs)
        base = jnp.broadcast_to(s.node_valid[None, :], (ids_.shape[0], s.N)) & em_[ids_]
        per = [f.static_mask(ctx) for f in rfw.filters]
        srej = rfw.attribute_rejects(base, per, rows=rows_)
        surv = base
        for m in per:
            if m is not None:
                surv = surv & m
        return srej, surv
    want = jax.jit(ref)(rsnap, ids, rows, em)
    fw = Framework.from_config()
    vctx = CycleContext(port_rounds._pod_view(psnap, torch.from_numpy(ids)))
    x = static_base.reject_inputs(static_base.static_base_inputs(fw, vctx))
    got = static_base.static_rejects(x, torch.from_numpy(rows), True,
                                     base=(torch.from_numpy(em), torch.from_numpy(ids)))
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[0].sum()) > 0


# ---- packed preemption and the verdicts (a reference-side observation) -------


@functools.cache
def _preempt_run(side: str, url: str):
    """Two full nodes of low-priority pods; an urgent pod that fits only by
    preemption; its extender filters out n0, where the victims are cheaper
    (priority 0 there, 5 on n1)."""
    m = ref_models if side == "ref" else port_models
    core, cfg_mod = (ref_core, ref_config) if side == "ref" else (port_core, port_config)
    cfg = cfg_mod.SchedulerConfiguration(extenders=[_ext_config(cfg_mod)(
        f"{url}/deny-n0", filter_verb="filter", carry_verdicts=True)])
    kw = {"device": "cpu"} if side == "port" else {}
    s = core.Scheduler(cfg, now=lambda: 0.0, **kw)
    for i in range(2):
        s.on_node_add(m.MakeNode(f"n{i}").capacity({"cpu": "4"}).obj())
    for i in range(2):
        s.on_pod_add(m.MakePod(f"low{i}").req({"cpu": "4"}).priority(5 * i).obj(), f"n{i}")
    s.on_pod_add(m.MakePod("urgent").req({"cpu": "2"}).priority(100).obj())
    st = s.schedule_cycle()
    return ([(p.name, n) for p, n in s.last_nominations],
            [(p.name, n) for p, n in s.last_evictions], st.scheduled)


def test_packed_preemption_reads_no_verdict_as_the_reference(webhook):
    want = _preempt_run("ref", webhook)
    got = _preempt_run("port", webhook)
    assert got == want
    # the reference's gate reads no verdict: the nomination lands on the
    # node the extender filtered out
    assert got[0] == [("urgent", "n0")] and got[2] == 0
