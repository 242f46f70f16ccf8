"""Client agent for the gRPC shim (the port's copy of
`k8s_scheduler_tpu/service/client.py`; it drives either package's server).

`SchedulerClient` is the raw stub (hand-written; no grpc_python_plugin in
the image). `SchedulerAgent` is the cluster-side logic the reference keeps
in-process: it mirrors the informer stream to the shim, carries bindings
back, and — because the shim is stateless like upstream's scheduler
(SURVEY.md §5.3) — recovers from a shim restart by re-listing everything it
knows. A binding the agent fails to apply is reported as a bind_failure so
the shim forgets the assumption and backs the pod off.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator

import grpc

from ..models.api import Node, Pod, PodGroup
from . import convert
from . import scheduler_pb2 as pb
from .server import SERVICE_NAME


class SchedulerClient:
    """Thin typed stub over a grpc channel."""

    def __init__(self, target: str, channel: grpc.Channel | None = None) -> None:
        self.channel = channel or grpc.insecure_channel(target)
        # effective W3C traceparent from the last submit's trailing
        # metadata ("" until a traced submit acks)
        self.last_traceparent = ""
        mk = self.channel.unary_unary
        self._update = mk(
            f"/{SERVICE_NAME}/Update",
            request_serializer=pb.UpdateRequest.SerializeToString,
            response_deserializer=pb.UpdateResponse.FromString,
        )
        self._cycle = mk(
            f"/{SERVICE_NAME}/Cycle",
            request_serializer=pb.CycleRequest.SerializeToString,
            response_deserializer=pb.CycleResponse.FromString,
        )
        self._health = mk(
            f"/{SERVICE_NAME}/Health",
            request_serializer=pb.HealthRequest.SerializeToString,
            response_deserializer=pb.HealthResponse.FromString,
        )
        self._metrics = mk(
            f"/{SERVICE_NAME}/Metrics",
            request_serializer=pb.MetricsRequest.SerializeToString,
            response_deserializer=pb.MetricsResponse.FromString,
        )
        self._inspect = mk(
            f"/{SERVICE_NAME}/Inspect",
            request_serializer=pb.InspectRequest.SerializeToString,
            response_deserializer=pb.InspectResponse.FromString,
        )
        self._submit = mk(
            f"/{SERVICE_NAME}/Submit",
            request_serializer=pb.SubmitRequest.SerializeToString,
            response_deserializer=pb.SubmitResponse.FromString,
        )
        self._node_churn = mk(
            f"/{SERVICE_NAME}/NodeChurn",
            request_serializer=pb.NodeChurnRequest.SerializeToString,
            response_deserializer=pb.NodeChurnResponse.FromString,
        )

    def update(self, request: pb.UpdateRequest, timeout: float = 10.0):
        return self._update(request, timeout=timeout)

    def cycle(self, timeout: float = 120.0) -> pb.CycleResponse:
        return self._cycle(pb.CycleRequest(), timeout=timeout)

    def health(self, timeout: float = 5.0) -> pb.HealthResponse:
        return self._health(pb.HealthRequest(), timeout=timeout)

    def metrics_text(self, timeout: float = 10.0) -> bytes:
        return self._metrics(pb.MetricsRequest(), timeout=timeout).prometheus_text

    def inspect(
        self,
        kind: str = "flightrecorder",
        last: int = 0,
        pod_uid: str = "",
        timeout: float = 10.0,
    ) -> dict:
        """Pull flight-recorder data (cycle records / Perfetto trace /
        per-pod timeline) decoded from the JSON payload; raises
        RuntimeError when the server reports an inspection error."""
        import json

        resp = self._inspect(
            pb.InspectRequest(kind=kind, last=last, pod_uid=pod_uid),
            timeout=timeout,
        )
        if not resp.ok:
            raise RuntimeError(f"Inspect({kind!r}): {resp.error}")
        return json.loads(resp.json.decode())

    def submit(
        self, pods, timeout: float = 30.0, traceparent: str = "",
    ) -> pb.SubmitResponse:
        """Submit pending pods through the admission front door.
        `pods` are models.api.Pod objects. Raises grpc.RpcError with
        RESOURCE_EXHAUSTED on shed (retry-after hint in the trailing
        metadata key "retry-after-ms"), INVALID_ARGUMENT on malformed
        pods, UNAVAILABLE while the server drains.

        `traceparent` (W3C) joins the submission's trace spans to the
        caller's trace; either way the server's effective traceparent
        (the caller's, or a head-sampled root it minted) comes back in
        the trailing metadata and lands in `self.last_traceparent`
        ("" when tracing is unarmed or the pod was not sampled)."""
        request = pb.SubmitRequest(
            pods=[convert.pod_to(p) for p in pods]
        )
        metadata = (
            (("traceparent", traceparent),) if traceparent else None
        )
        resp, call = self._submit.with_call(
            request, timeout=timeout, metadata=metadata
        )
        self.last_traceparent = ""
        for key, value in call.trailing_metadata() or ():
            if key == "traceparent":
                self.last_traceparent = value
                break
        return resp

    def node_churn(
        self, adds=(), updates=(), deletes=(), timeout: float = 30.0
    ) -> pb.NodeChurnResponse:
        """Node churn through the front door (journaled before ack;
        never shed)."""
        return self._node_churn(
            pb.NodeChurnRequest(
                adds=[convert.node_to(n) for n in adds],
                updates=[convert.node_to(n) for n in updates],
                deletes=list(deletes),
            ),
            timeout=timeout,
        )

    def close(self) -> None:
        self.channel.close()


# bind_applier(pod_uid, pod_name, namespace, node_name) -> None; raise = failed
BindApplier = Callable[[str, str, str, str], None]


class SchedulerAgent:
    """Mirrors cluster objects into the shim and applies its decisions.

    Keeps a local store of every live object so a full re-list can be
    replayed after the shim restarts (same recovery the reference gets from
    client-go informers re-listing into a fresh scheduler process)."""

    def __init__(self, client: SchedulerClient, bind_applier: BindApplier,
                 evict_applier: Callable[[str, str], None] | None = None,
                 event_applier: Callable[["pb.Event"], None] | None = None) -> None:
        self.client = client
        self.bind_applier = bind_applier
        self.evict_applier = evict_applier or (lambda uid, node: None)
        # posts each drained scheduler event as a Kubernetes Event
        self.event_applier = event_applier or (lambda ev: None)
        # informer-side mirror of the cluster view, NOT WAL-tracked
        # state (the server's cache._nodes is the durable copy)
        self._node_mirror: dict[str, Node] = {}
        self._pods: dict[str, tuple[Pod, str]] = {}  # uid -> (pod, bound_node)
        self._groups: dict[str, PodGroup] = {}
        self._pvcs: dict[str, object] = {}
        self._pvs: dict[str, object] = {}
        self._classes: dict[str, object] = {}
        self._pdbs: dict[str, object] = {}
        self._pending_failures: list[str] = []
        self._boot_id: str | None = None  # shim incarnation last fed state
        self._batch: pb.UpdateRequest | None = None  # open batched() request

    # ---- informer-side entry points -------------------------------------

    def upsert_node(self, node: Node) -> None:
        known = node.name in self._node_mirror
        self._node_mirror[node.name] = node
        self._send(
            pb.UpdateRequest(
                **{
                    ("node_updates" if known else "node_adds"): [
                        convert.node_to(node)
                    ]
                }
            )
        )

    def delete_node(self, name: str) -> None:
        self._node_mirror.pop(name, None)
        self._send(pb.UpdateRequest(node_deletes=[name]))

    def upsert_pod(self, pod: Pod, bound_node: str = "") -> None:
        known = pod.uid in self._pods
        self._pods[pod.uid] = (pod, bound_node)
        ev = pb.PodEvent(pod=convert.pod_to(pod), bound_node=bound_node)
        self._send(
            pb.UpdateRequest(
                **{("pod_updates" if known else "pod_adds"): [ev]}
            )
        )

    def delete_pod(self, uid: str) -> None:
        self._pods.pop(uid, None)
        self._send(pb.UpdateRequest(pod_deletes=[uid]))

    def add_pod_group(self, group: PodGroup) -> None:
        self._groups[group.name] = group
        self._send(
            pb.UpdateRequest(
                pod_groups=[pb.PodGroup(name=group.name,
                                        min_member=group.min_member)]
            )
        )

    # ---- volume objects (VolumeBinding inputs) ---------------------------

    def upsert_pvc(self, pvc) -> None:
        self._pvcs[pvc.key] = pvc
        self._send(pb.UpdateRequest(pvc_upserts=[convert.pvc_to(pvc)]))

    def delete_pvc(self, key: str) -> None:
        self._pvcs.pop(key, None)
        self._send(pb.UpdateRequest(pvc_deletes=[key]))

    def upsert_pv(self, pv) -> None:
        self._pvs[pv.name] = pv
        self._send(pb.UpdateRequest(pv_upserts=[convert.pv_to(pv)]))

    def delete_pv(self, name: str) -> None:
        self._pvs.pop(name, None)
        self._send(pb.UpdateRequest(pv_deletes=[name]))

    def upsert_storage_class(self, sc) -> None:
        self._classes[sc.name] = sc
        self._send(
            pb.UpdateRequest(storage_class_upserts=[convert.storage_class_to(sc)])
        )

    def delete_storage_class(self, name: str) -> None:
        self._classes.pop(name, None)
        self._send(pb.UpdateRequest(storage_class_deletes=[name]))

    def upsert_pdb(self, pdb) -> None:
        self._pdbs[pdb.key] = pdb
        self._send(pb.UpdateRequest(pdb_upserts=[convert.pdb_to(pdb)]))

    def delete_pdb(self, key: str) -> None:
        self._pdbs.pop(key, None)
        self._send(pb.UpdateRequest(pdb_deletes=[key]))

    # ---- the cycle -------------------------------------------------------

    def run_cycle(self) -> pb.CycleResponse:
        """Flush failures, run one cycle, apply bindings/evictions."""
        if self._pending_failures:
            self._send(pb.UpdateRequest(bind_failures=self._pending_failures))
            self._pending_failures = []
        resp = self._with_recovery(self.client.cycle)
        if self._boot_changed(resp.boot_id):
            # the shim restarted since we fed it state and the cycle ran
            # against an empty cache — replay everything and re-run
            self.relist()
            resp = self._with_recovery(self.client.cycle)
        confirmed = pb.UpdateRequest()
        for b in resp.bindings:
            try:
                self.bind_applier(
                    b.pod_uid, b.pod_name, b.pod_namespace, b.node_name
                )
            except Exception:
                self._pending_failures.append(b.pod_uid)
                continue
            pod, _ = self._pods.get(b.pod_uid, (None, ""))
            if pod is not None:
                self._pods[b.pod_uid] = (pod, b.node_name)
                confirmed.pod_updates.append(
                    pb.PodEvent(pod=convert.pod_to(pod), bound_node=b.node_name)
                )
        for ev in resp.evictions:
            self.evict_applier(ev.pod_uid, ev.node_name)
        for ev in resp.events:
            self.event_applier(ev)
        if confirmed.pod_updates:
            self._send(confirmed)
        return resp

    # ---- transport + recovery -------------------------------------------

    def _boot_changed(self, boot_id: str) -> bool:
        """Track the shim incarnation; True when a restart was detected
        (a restarted shim at the same address answers RPCs normally but
        holds empty state — the boot_id is the only tell)."""
        if self._boot_id == boot_id:
            return False
        first = self._boot_id is None
        self._boot_id = boot_id
        return not first

    @contextlib.contextmanager
    def batched(self) -> Iterator[None]:
        """Coalesce every upsert/delete inside the block into ONE Update
        RPC — the informer re-list path would otherwise pay one round-trip
        per object (10k pods = 10k RPCs). Nesting reuses the open batch."""
        if self._batch is not None:
            yield
            return
        self._batch = pb.UpdateRequest()
        try:
            yield
            batch, self._batch = self._batch, None
            if batch.SerializeToString():
                self._send(batch)
        finally:
            self._batch = None

    def _send(self, request: pb.UpdateRequest) -> None:
        if self._batch is not None:
            self._batch.MergeFrom(request)
            return
        resp = self._with_recovery(lambda: self.client.update(request))
        if self._boot_changed(resp.boot_id):
            # state before this delta is gone: replay everything (the delta
            # itself was applied to the fresh shim, and relist re-sends the
            # full store including it, which is idempotent)
            self.relist()

    def _with_recovery(self, call):
        try:
            return call()
        except grpc.RpcError as e:
            if e.code() not in (
                grpc.StatusCode.UNAVAILABLE,
                grpc.StatusCode.DEADLINE_EXCEEDED,
            ):
                raise
            # shim restarted (or hiccuped): replay the full state, retry once
            self.relist()
            return call()

    def relist(self) -> None:
        """Replay everything we know into a (possibly fresh) shim."""
        req = pb.UpdateRequest()
        for node in self._node_mirror.values():
            req.node_adds.append(convert.node_to(node))
        for g in self._groups.values():
            req.pod_groups.append(
                pb.PodGroup(name=g.name, min_member=g.min_member)
            )
        for pod, bound in self._pods.values():
            req.pod_adds.append(
                pb.PodEvent(pod=convert.pod_to(pod), bound_node=bound)
            )
        for pvc in self._pvcs.values():
            req.pvc_upserts.append(convert.pvc_to(pvc))
        for pv in self._pvs.values():
            req.pv_upserts.append(convert.pv_to(pv))
        for sc in self._classes.values():
            req.storage_class_upserts.append(convert.storage_class_to(sc))
        for pdb in self._pdbs.values():
            req.pdb_upserts.append(convert.pdb_to(pdb))
        resp = self.client.update(req)
        self._boot_id = resp.boot_id
