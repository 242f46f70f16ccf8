"""The port's gRPC shim and CLI (`k8s_scheduler_tpu_torch/service/`,
`cmd/main.py`, `__main__.py`) against the reference's.

- `scheduler_pb2.py` registers the reference's serialized descriptor byte
  for byte: both modules give the same message classes.
- `convert.py`: each object, built by both packages' builders, serializes
  to the same bytes, and the reference's bytes decode in the port to the
  reference's object (compared through the state codec's dicts).
- The port's server answers the reference's client and the reference's
  server answers the port's client on a localhost channel: one seeded
  trace through `Update`, `Cycle`, `Health`, `Inspect`, `Submit` and
  `NodeChurn` gives every pairing the reference pair's answers and bind
  stream.
- `load_config` reads every field the reference's reads; every CLI flag
  parses, and `main()`'s overrides give the reference's configuration.
- `python -m k8s_scheduler_tpu_torch` with neither jax nor
  `k8s_scheduler_tpu` importable: `--help` imports neither, and the CLI
  serves on the CPU in a child process (gRPC, the front door, /healthz)
  and exits 0 on SIGTERM, leaving its black-box bundle."""

from __future__ import annotations

import dataclasses
import functools
import importlib
import os
import random
import re
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

import k8s_scheduler_tpu.config.types as ref_config
import k8s_scheduler_tpu.models as ref_models
import k8s_scheduler_tpu.models.api as ref_api
import k8s_scheduler_tpu.service.client as ref_client
import k8s_scheduler_tpu.service.convert as ref_convert
import k8s_scheduler_tpu.service.scheduler_pb2 as ref_pb
import k8s_scheduler_tpu.service.server as ref_server
import k8s_scheduler_tpu.state.codec as ref_codec
import k8s_scheduler_tpu_torch.config.types as port_config
import k8s_scheduler_tpu_torch.models as port_models
import k8s_scheduler_tpu_torch.models.api as port_api
import k8s_scheduler_tpu_torch.service.client as port_client
import k8s_scheduler_tpu_torch.service.convert as port_convert
import k8s_scheduler_tpu_torch.service.scheduler_pb2 as port_pb
import k8s_scheduler_tpu_torch.service.server as port_server
import k8s_scheduler_tpu_torch.state.codec as port_codec
from torch_one_thread import one_torch_thread  # noqa: F401

# the modules (each `cmd` package exports its `main` function under that name)
ref_main = importlib.import_module("k8s_scheduler_tpu.cmd.main")
port_main = importlib.import_module("k8s_scheduler_tpu_torch.cmd.main")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- the wire format --------------------------------------------------------


def test_pb2_registers_the_reference_descriptor():
    assert port_pb.DESCRIPTOR.serialized_pb == ref_pb.DESCRIPTOR.serialized_pb
    assert port_pb.Pod is ref_pb.Pod and port_pb.CycleResponse is ref_pb.CycleResponse
    with open(os.path.join(REPO, "k8s_scheduler_tpu", "service", "scheduler.proto")) as a, \
            open(os.path.join(REPO, "k8s_scheduler_tpu_torch", "service",
                              "scheduler.proto")) as b:
        assert a.read() == b.read()


def _pod(m):
    return (m.MakePod("web-1", namespace="prod").req({"cpu": "500u", "memory": "1Gi"})
            .labels({"app": "web"}).priority(7).node_selector({"disk": "ssd"})
            .toleration("dedicated", "gpu", "NoSchedule")
            .pod_affinity("topology.kubernetes.io/zone", {"app": "cache"})
            .pod_affinity("kubernetes.io/hostname", {"app": "web"}, anti=True)
            .spread(2, "topology.kubernetes.io/zone", {"app": "web"})
            .host_port(8080).group("gang-a").volume("data").nominated("n3")
            .node_affinity_in("tier", ["gold", "silver"])
            .node_affinity_preferred(5, "zone", ["z1"]).obj())


def _node(m):
    return (m.MakeNode("n1").capacity({"cpu": "16", "memory": "32Gi", "pods": "110"})
            .labels({"topology.kubernetes.io/zone": "zone-a"}).taint("dedicated", "gpu")
            .obj())


def _volumes(api):
    term = api.NodeSelectorTerm((api.NodeSelectorRequirement("zone", "In", ("z1",)),))
    return {
        "pvc": (api.PersistentVolumeClaim("data", storage_class="local", request=1.0),
                "pvc_to", "pvc_from"),
        "pv": (api.PersistentVolume("pv-z1", capacity=10.0, storage_class="local",
                                    node_affinity=(term,)), "pv_to", "pv_from"),
        "storage_class": (api.StorageClass("local", api.VOLUME_BINDING_WAIT,
                                           provisioner=False),
                          "storage_class_to", "storage_class_from"),
        "pdb": (api.PodDisruptionBudget("budget", namespace="prod",
                                        selector=api.LabelSelector({"app": "web"}),
                                        disruptions_allowed=1), "pdb_to", "pdb_from"),
    }


@pytest.mark.parametrize("kind", ["pod", "node", "pvc", "pv", "storage_class", "pdb"])
def test_convert_round_trips_as_the_reference(kind):
    if kind in ("pod", "node"):
        build = _pod if kind == "pod" else _node
        a, b = build(ref_models), build(port_models)
        to, frm = f"{kind}_to", f"{kind}_from"
    else:
        a, to, frm = _volumes(ref_api)[kind]
        b = _volumes(port_api)[kind][0]
    wire = getattr(ref_convert, to)(a).SerializeToString()
    assert getattr(port_convert, to)(b).SerializeToString() == wire
    back_ref = getattr(ref_convert, frm)(ref_pb.__dict__[type(getattr(ref_convert, to)(a))
                                                        .__name__].FromString(wire))
    back = getattr(port_convert, frm)(port_pb.__dict__[type(getattr(port_convert, to)(b))
                                                       .__name__].FromString(wire))
    if kind in ("pod", "node"):
        state = f"{kind}_to_state"
        assert getattr(port_codec, state)(back) == getattr(ref_codec, state)(back_ref)
    else:
        assert dataclasses.asdict(back) == dataclasses.asdict(back_ref)


# ---- interoperation over a localhost channel --------------------------------


def _trace(m, api):
    """One seeded trace: nodes, a gang group, three batches of pending pods
    (config #2's label / toleration mix at a small width), a submission
    through the front door and node churn."""
    rng = random.Random(22)
    nodes = []
    for i in range(8):
        nb = m.MakeNode(f"n{i}").capacity({"cpu": "8", "memory": "16Gi", "pods": "20"})
        nb = nb.labels({"zone": f"z{i % 3}", "tier": ("gold", "silver")[i % 2]})
        if i % 4 == 3:
            nb = nb.taint("dedicated", "batch")
        nodes.append(nb.obj())
    batches = []
    uid = 0
    for _b in range(3):
        pods = []
        for _ in range(rng.randint(4, 9)):
            pb = m.MakePod(f"p{uid}").req({"cpu": rng.choice(["500m", "1", "2", "3"]),
                                            "memory": "1Gi"})
            if rng.random() < 0.4:
                pb = pb.node_selector({"tier": rng.choice(["gold", "silver"])})
            if rng.random() < 0.3:
                pb = pb.toleration("dedicated", "batch", "NoSchedule")
            pods.append(pb.obj())
            uid += 1
        batches.append(pods)
    gang = [m.MakePod(f"g{i}").req({"cpu": "2"}).group("gang").obj() for i in range(3)]
    submitted = [m.MakePod(f"s{i}").req({"cpu": "1"}).obj() for i in range(4)]
    churn = m.MakeNode("n-new").capacity({"cpu": "16", "memory": "32Gi", "pods": "20"}).obj()
    return nodes, batches, api.PodGroup("gang", 3), gang, submitted, churn


def _drive(server_pkg: str, client_pkg: str) -> dict:
    """Serve with `server_pkg`'s shim, feed it with `client_pkg`'s agent and
    client; returns every answer, without the fields a wall clock writes."""
    srv = port_server if server_pkg == "port" else ref_server
    cmod, m, api = ((port_client, port_models, port_api) if client_pkg == "port"
                    else (ref_client, ref_models, ref_api))
    kw = {"device": "cpu"} if server_pkg == "port" else {}
    cfg = (port_config if server_pkg == "port" else ref_config).SchedulerConfiguration(
        flight_recorder_size=64)
    server, service, port = srv.serve("127.0.0.1:0", config=cfg, **kw)
    service.enable_front_door(queue_depth=0)
    client = cmod.SchedulerClient(f"127.0.0.1:{port}")
    bound: list = []
    events: list = []
    agent = cmod.SchedulerAgent(client, lambda uid, name, ns, node: bound.append((uid, node)),
                                event_applier=lambda ev: events.append((ev.type, ev.reason,
                                                                        ev.pod_uid)))
    nodes, batches, group, gang, submitted, churn = _trace(m, api)
    out: dict = {"cycles": []}
    try:
        with agent.batched():
            for nd in nodes:
                agent.upsert_node(nd)
            agent.add_pod_group(group)
        for i, pods in enumerate(batches):
            with agent.batched():
                for p in pods:
                    agent.upsert_pod(p)
                if i == 1:
                    for p in gang:
                        agent.upsert_pod(p)
            resp = agent.run_cycle()
            out["cycles"].append((
                [(b.pod_uid, b.node_name) for b in resp.bindings],
                (resp.stats.attempted, resp.stats.scheduled, resp.stats.unschedulable,
                 resp.stats.gang_dropped),
                [(n.pod_uid, n.node_name) for n in resp.nominations]))
        h = client.health()
        out["health"] = (h.ok, h.status, bool(h.boot_id))
        ack = client.submit(submitted)
        out["submit"] = (ack.accepted, ack.durable, ack.queue_depth)
        out["churn"] = client.node_churn(adds=[churn]).durable
        resp = client.cycle()
        out["after_submit"] = sorted((b.pod_uid, b.node_name) for b in resp.bindings)
        fr = client.inspect("flightrecorder", last=16)
        out["inspect"] = [(c["counts"]["pods"], c["counts"]["scheduled"])
                          for c in fr["cycles"]]
        out["pod"] = client.inspect("pod", pod_uid=batches[0][0].uid)["uid"]
        out["metrics"] = b"scheduler_schedule_attempts_total" in client.metrics_text()
    finally:
        client.close()
        server.stop(grace=None)
    out["bound"] = bound
    out["events"] = events
    return out


@functools.lru_cache(maxsize=None)
def _answers(server_pkg: str, client_pkg: str) -> dict:
    return _drive(server_pkg, client_pkg)


@pytest.mark.parametrize("server_pkg,client_pkg", [("port", "ref"), ("ref", "port"),
                                                   ("port", "port")])
def test_servers_and_clients_interoperate(server_pkg, client_pkg):
    want = _answers("ref", "ref")
    got = _answers(server_pkg, client_pkg)
    assert want["bound"] and want["after_submit"] and want["health"] == (True, "ok", True)
    assert want["submit"][0] == 4 and want["churn"] is False
    assert got == want


# ---- configuration and flags -----------------------------------------------


FULL_YAML = """
profiles:
  - schedulerName: default-scheduler
    plugins:
      queueSort: {enabled: [{name: PrioritySort}]}
      preFilter: {enabled: [{name: NodeResourcesFit}]}
      filter: {disabled: [{name: NodePorts}]}
      postFilter: {disabled: ["*"]}
      preScore: {enabled: [{name: InterPodAffinity}]}
      score: {enabled: [{name: NodeResourcesBalancedAllocation, weight: 3}]}
      reserve: {enabled: [{name: VolumeBinding}]}
      permit: {enabled: [{name: Coscheduling}]}
      bind: {enabled: [{name: DefaultBinder}]}
    pluginConfig:
      - name: NodeResourcesFit
        args: {scoringStrategy: {type: MostAllocated}}
  - schedulerName: batch
percentageOfNodesToScore: 40
podInitialBackoffSeconds: 2
podMaxBackoffSeconds: 20
gangScheduling: false
commitMode: scan
padExisting: 64
padPodsPerNode: 8
padMa: 4
padMc: 2
forcedSync: true
flightRecorderSize: 128
healthMaxCycleAge: 1m30s
sloP99Ms: 250
sloWindowCycles: 512
multiCycleK: 4
multiCycleMaxWaitMs: 7.5
padHysteresisPct: 12.5
compileCacheDir: /var/cache/kscc
shardDevices: 1
speculativeCompile: false
speculativeDispatch: false
incrementalEncode: true
dispatchDeadlineMs: 900
degradePromoteCycles: 3
faultSpec: "seed=7;device_error@cycle=2:kind=transport:n=1"
admissionQueueDepth: 1000
admissionRetryAfterMs: 125
traceSampleRate: 0.5
stateDir: /var/lib/sched
snapshotInterval: 30s
metricsHistorySamples: 128
metricsTickerSeconds: 0.5
alertRulesFile: /etc/rules.yaml
blackboxRetention: 3
debugDashboard: false
extenders:
  - urlPrefix: http://127.0.0.1:8888/
    filterVerb: filter
    prioritizeVerb: prioritize
    bindVerb: bind
    weight: 2
    httpTimeout: 500ms
    ignorable: true
    carryVerdicts: true
"""


def test_load_config_reads_every_reference_field(tmp_path):
    path = tmp_path / "scheduler.yaml"
    path.write_text(FULL_YAML)
    for src in (str(path), FULL_YAML):
        a, b = ref_config.load_config(src), port_config.load_config(src)
        assert ref_config.to_dict(a) == port_config.to_dict(b)
    assert {f.name for f in dataclasses.fields(ref_config.SchedulerConfiguration)} == \
        {f.name for f in dataclasses.fields(port_config.SchedulerConfiguration)}
    assert port_config.load_config(FULL_YAML).health_max_cycle_age_seconds == 90.0


class _Served(Exception):
    def __init__(self, config):
        self.config = config


def _config_of(main_mod, serve_mod, argv, monkeypatch):
    """The configuration `main(argv)` hands to `serve`, without serving."""
    def serve(address, config=None, **kw):
        raise _Served(config)

    monkeypatch.setattr(serve_mod, "serve", serve)
    with pytest.raises(_Served) as ei:
        main_mod.main(argv)
    return ei.value.config


FLAG_SETS = {
    "defaults": [],
    "every_override": [
        "--pad-ma", "6", "--pad-mc", "3", "--forced-sync", "--flight-record-n", "32",
        "--health-max-cycle-age", "12.5", "--slo-p99-ms", "40", "--multi-cycle-k", "4",
        "--multi-cycle-max-wait-ms", "3", "--pad-hysteresis-pct", "10",
        "--compile-cache-dir", "off", "--shard-devices", "1", "--speculative-compile", "0",
        "--speculative-dispatch", "1", "--incremental-encode", "1",
        "--dispatch-deadline-ms", "500", "--degrade-promote-cycles", "5",
        "--fault-spec", "seed=3", "--admission-queue-depth", "99",
        "--snapshot-interval", "0", "--trace-sample-rate", "0.25",
        "--metrics-history-samples", "0", "--alert-rules-file", "/x/rules.yaml",
        "--blackbox-retention", "0",
    ],
    "zeros": ["--multi-cycle-k", "0", "--flight-record-n", "0", "--slo-p99-ms", "0",
              "--health-max-cycle-age", "0", "--speculative-dispatch", "0",
              "--metrics-history-samples", "0"],
}


@pytest.mark.parametrize("name", sorted(FLAG_SETS))
def test_cli_flags_parse_to_the_reference_configuration(name, tmp_path, monkeypatch):
    path = tmp_path / "scheduler.yaml"
    path.write_text(FULL_YAML.replace("stateDir: /var/lib/sched", "stateDir: ''"))
    argv = FLAG_SETS[name] + ["--config", str(path), "--http-port", "-1",
                              "--address", "127.0.0.1:0"]
    monkeypatch.setattr("k8s_scheduler_tpu.utils.compilation_cache.enable_compilation_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr("k8s_scheduler_tpu.parallel.mesh.initialize_distributed",
                        lambda *a, **k: None)
    a = _config_of(ref_main, ref_server, argv, monkeypatch)
    b = _config_of(port_main, port_server, argv, monkeypatch)
    assert ref_config.to_dict(a) == port_config.to_dict(b)
    ra = vars(ref_main.new_scheduler_command().parse_args(argv))
    pa = vars(port_main.new_scheduler_command().parse_args(argv))
    assert pa.pop("device") is None and pa == ra


def test_every_reference_flag_has_the_reference_default():
    ref = {a.dest: (a.default, a.option_strings) for a in
           ref_main.new_scheduler_command()._actions}
    port = {a.dest: (a.default, a.option_strings) for a in
            port_main.new_scheduler_command()._actions}
    assert set(port) - set(ref) == {"device"}
    assert {k: port[k] for k in ref} == ref


def test_contradictory_health_deadline_exits_as_the_reference():
    argv = ["--health-max-cycle-age", "5", "--flight-record-n", "0"]
    with pytest.raises(SystemExit) as a:
        ref_main.main(argv)
    with pytest.raises(SystemExit) as b:
        port_main.main(argv)
    assert str(a.value) == str(b.value) and "flight recorder" in str(b.value)


# ---- the process: python -m k8s_scheduler_tpu_torch ------------------------

# a child interpreter in which neither jax nor the reference package imports
_BLOCKED = r"""
import importlib.abc, runpy, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "k8s_scheduler_tpu"):
            raise ImportError(f"{name} is blocked in this process")
        return None
sys.meta_path.insert(0, _Block())
try:
    runpy.run_module("k8s_scheduler_tpu_torch", run_name="__main__", alter_sys=True)
finally:
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "k8s_scheduler_tpu"))
    print("FOREIGN_MODULES", bad, flush=True)
"""


def _child(args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1")
    env.pop("SCHED_FAULTS", None)
    return subprocess.Popen([sys.executable, "-c", _BLOCKED, *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, **kw)


def test_help_imports_neither_jax_nor_the_reference():
    p = _child(["--help"])
    out, _ = p.communicate(timeout=120)
    assert p.returncode == 0, out
    assert "--multi-cycle-k" in out and "--device" in out and "--submit-addr" in out
    assert "FOREIGN_MODULES []" in out


def test_main_serves_on_the_cpu_and_stops_on_sigterm(tmp_path):
    state = tmp_path / "state"
    p = _child(["--device", "cpu", "--address", "127.0.0.1:0", "--http-port", "0",
                "--submit-addr", "127.0.0.1:0", "--state-dir", str(state),
                "--multi-cycle-k", "2", "--metrics-history-samples", "16"])
    lines: list[str] = []
    ports: dict = {}
    deadline = time.time() + 120
    try:
        while time.time() < deadline:
            line = p.stdout.readline()
            if not line:
                break
            lines.append(line)
            for key, pat in (("grpc", r"listening on port (\d+)"),
                             ("submit", r"submissions on port (\d+)"),
                             ("http", r"serving /healthz /metrics on port (\d+)")):
                hit = re.search(pat, line)
                if hit:
                    ports[key] = int(hit.group(1))
            if "http" in ports:
                break
        assert set(ports) == {"grpc", "submit", "http"}, "".join(lines)
        # the node through the agent channel; the pods through the front door,
        # whose own serve loop (coalescing K = 2) schedules and binds them
        client = port_client.SchedulerClient(f"127.0.0.1:{ports['grpc']}")
        agent = port_client.SchedulerAgent(client, lambda *a: None)
        agent.upsert_node(port_models.MakeNode("a").capacity({"cpu": "4"}).obj())
        sub = port_client.SchedulerClient(f"127.0.0.1:{ports['submit']}")
        pods = [port_models.MakePod(f"q{i}").req({"cpu": "1"}).obj() for i in range(3)]
        assert sub.submit(pods).durable
        sub.close()
        bound = set()
        t_end = time.time() + 60
        while len(bound) < 3 and time.time() < t_end:
            for p_ in pods:
                try:
                    tl = client.inspect("pod", pod_uid=p_.uid)
                except RuntimeError:  # not seen yet
                    continue
                if tl["state"] in ("Bound", "BoundObserved"):
                    bound.add(p_.uid)
            time.sleep(0.1)
        assert len(bound) == 3, bound
        client.close()
        with urllib.request.urlopen(f"http://127.0.0.1:{ports['http']}/healthz",
                                    timeout=10) as r:
            assert r.status == 200
        p.send_signal(signal.SIGTERM)
        out, _ = p.communicate(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    out = "".join(lines) + out
    assert p.returncode == 0, out
    assert "black box dumped" in out and "durable state sealed" in out, out
    assert "FOREIGN_MODULES []" in out
    assert any(n.startswith("blackbox-") for n in os.listdir(state / "blackbox"))


@pytest.mark.parametrize("name", ["attribution_static_dyn_split", "tiebreak_argmax_last"])
def test_via_api_replays_the_corpus(name):
    """The committed corpus traces (without their bugs) through the gRPC
    Submit / NodeChurn path give the direct engine's records."""
    from k8s_scheduler_tpu_torch import fuzz

    art = fuzz.load_artifact(os.path.join(REPO, "tests", "corpus", f"{name}.json"))
    assert fuzz.run_api_case(art["trace"], device="cpu") == []
