"""gRPC shim server: snapshot deltas in, bindings out. The port's copy of
`k8s_scheduler_tpu/service/server.py`, speaking the same wire format
(`scheduler_pb2.py` registers the same serialized descriptor), so either
package's client drives either package's server. The `Scheduler` it builds
runs on the card unless the caller passes `device="cpu"`. The CLI
(`cmd/main.py`) imports this module only when it serves, so `--help` needs
no grpc.

The cluster-integration boundary from SURVEY.md §7 step 7 / §5.8: where the
reference talks HTTPS watch/Binding-POST to the API server itself, the TPU
scheduler runs behind this service and a thin agent (client.py) owns the
cluster store conversation. Per the north star, one `Cycle` RPC returns
pod->node bindings for the WHOLE pending set.

Bind dispatch is optimistic (upstream assume-then-bind-async): a binding
returned from `Cycle` is assumed in the cache; the agent reports failed
Binding POSTs in its next `Update(bind_failures=[...])`, which forgets the
assumption and requeues with backoff. If the confirmation never arrives the
assumed-pod TTL expires and the pod is requeued (no double-bind either way
— fault tests in tests/test_service.py).

The scheduler underneath runs the split-phase serving pipeline
(core/pipeline.py): inside `Cycle`, the response's `bindings` are
collected from the winner bind loop, which blocks only on the slimmed
decision fetch — preemption nominations, evictions, and FailedScheduling
events ride the deferred programs that resolve while winners bind, so a
mostly-schedulable cycle's bindings are never gated on diagnostics.
`forced_sync` (config `forcedSync` or the serve() argument) restores
strictly sequential execution for tests and latency measurement.

The grpc servicer/stub glue is hand-written (the image has protoc for
messages but no grpc_python_plugin); method handler wiring mirrors what
grpc_tools would generate.
"""

from __future__ import annotations

import threading
import uuid
from concurrent import futures

import grpc

from ..config import SchedulerConfiguration
from ..core.scheduler import Scheduler
from ..metrics import SchedulerMetrics
from ..models.api import PodGroup
from . import convert
from . import scheduler_pb2 as pb

SERVICE_NAME = "k8sschedtpu.Scheduler"


class SchedulerService:
    """Implements the four RPCs against one host-side Scheduler."""

    def __init__(self, config: SchedulerConfiguration | None = None,
                 scheduler: Scheduler | None = None,
                 profile_every: int = 0,
                 metrics: SchedulerMetrics | None = None,
                 forced_sync: bool | None = None,
                 state=None, device=None) -> None:
        # the injectable binder collects into the in-progress response;
        # one cycle at a time (serialized by _cycle_lock)
        self._bindings: list[pb.Binding] = []
        self.scheduler = scheduler or Scheduler(
            config=config, binder=self._collect_binding, metrics=metrics,
            forced_sync=forced_sync, state=state, device=device,
        )
        if scheduler is not None:
            scheduler.binder = self._collect_binding
            if metrics is not None:
                # rebind like the binder above: an injected scheduler must
                # still report into the registry the caller will serve
                scheduler.metrics = metrics
        self._cycle_lock = threading.Lock()
        self._uid_index: dict[str, object] = {}  # uid -> last seen Pod
        # incarnation id: a restarted shim at the same address must be
        # distinguishable from the one the agent fed state to (§5.3)
        self.boot_id = uuid.uuid4().hex
        # every N Cycle RPCs, run the per-plugin profiling pass so the
        # plugin-latency histograms stay populated in steady serving
        self.profile_every = int(profile_every)
        self._cycle_count = 0
        # submission front door (service/admission.py): None until
        # enable_front_door() — the Submit/NodeChurn RPCs answer
        # FAILED_PRECONDITION while disabled
        self.admission = None

    def enable_front_door(self, **kwargs):
        """Attach an AdmissionController (idempotent) so the Submit /
        NodeChurn RPCs serve; returns the controller. The CLI calls
        this when --submit-addr is given."""
        if self.admission is None:
            from .admission import AdmissionController

            self.admission = AdmissionController(
                self.scheduler, **kwargs
            )
        return self.admission

    def run_local_cycle(self):
        """One scheduling cycle on the FRONT-DOOR serve loop,
        serialized against agent-driven Cycle RPCs by the same lock.
        Bindings are applied host-side (assume + events) exactly as in
        Cycle; the response-collection list is discarded — there is no
        RPC response to carry it."""
        with self._cycle_lock:
            self._bindings = []
            stats = self.scheduler.schedule_cycle()
            self._bindings = []
            return stats

    def _collect_binding(self, pod, node_name: str) -> None:
        self._bindings.append(
            pb.Binding(
                pod_uid=pod.uid,
                pod_name=pod.name,
                pod_namespace=pod.namespace,
                node_name=node_name,
            )
        )

    # ---- RPCs ------------------------------------------------------------

    def Update(self, request: pb.UpdateRequest, context) -> pb.UpdateResponse:
        s = self.scheduler
        for n in request.node_adds:
            s.on_node_add(convert.node_from(n))
        for n in request.node_updates:
            s.on_node_update(convert.node_from(n))
        for name in request.node_deletes:
            s.on_node_delete(name)
        for g in request.pod_groups:
            s.add_pod_group(PodGroup(g.name, g.min_member))
        for ev in request.pod_adds:
            pod = convert.pod_from(ev.pod)
            self._uid_index[pod.uid] = pod
            s.on_pod_add(pod, node_name=ev.bound_node)
        for ev in request.pod_updates:
            pod = convert.pod_from(ev.pod)
            self._uid_index[pod.uid] = pod
            s.on_pod_update(pod, node_name=ev.bound_node)
        for uid in request.pod_deletes:
            self._uid_index.pop(uid, None)
            s.on_pod_delete(uid)
        for uid in request.bind_failures:
            # agent's Binding POST failed: forget + backoff (upstream
            # handleBindingCycleError)
            s.cache.forget(uid)
            pod = self._uid_index.get(uid)
            if pod is not None:
                s.queue.requeue_backoff(pod)
        for c in request.pvc_upserts:
            s.on_pvc_upsert(convert.pvc_from(c))
        for key in request.pvc_deletes:
            s.on_pvc_delete(key)
        for v in request.pv_upserts:
            s.on_pv_upsert(convert.pv_from(v))
        for name in request.pv_deletes:
            s.on_pv_delete(name)
        for sc in request.storage_class_upserts:
            s.on_storage_class_upsert(convert.storage_class_from(sc))
        for name in request.storage_class_deletes:
            s.on_storage_class_delete(name)
        for pdb in request.pdb_upserts:
            s.on_pdb_upsert(convert.pdb_from(pdb))
        for key in request.pdb_deletes:
            s.on_pdb_delete(key)
        return pb.UpdateResponse(boot_id=self.boot_id)

    def Cycle(self, request: pb.CycleRequest, context) -> pb.CycleResponse:
        with self._cycle_lock:
            self._bindings = []
            s = self.scheduler
            stats = s.schedule_cycle()
            self._cycle_count += 1
            if self.profile_every and self._cycle_count % self.profile_every == 0:
                s.profile_cycle()
            resp = pb.CycleResponse(
                boot_id=self.boot_id,
                bindings=list(self._bindings),
                stats=pb.CycleStats(
                    attempted=stats.attempted,
                    scheduled=stats.scheduled,
                    unschedulable=stats.unschedulable,
                    bind_errors=stats.bind_errors,
                    preemptors=stats.preemptors,
                    victims=stats.victims,
                    gang_dropped=stats.gang_dropped,
                    cycle_seconds=stats.cycle_seconds,
                ),
            )
            # nominations + evictions were applied to host state by the
            # scheduler; surface them from its per-cycle decision log
            for pod, node in s.last_nominations:
                resp.nominations.append(
                    pb.Nomination(pod_uid=pod.uid, node_name=node)
                )
            for pod, node in s.last_evictions:
                resp.evictions.append(
                    pb.Eviction(
                        pod_uid=pod.uid, pod_name=pod.name, node_name=node
                    )
                )
            # drain Scheduled/FailedScheduling/Preempted events so the
            # agent can post them as real Kubernetes Events
            for ev in s.events.drain():
                resp.events.append(
                    pb.Event(
                        type=ev.type,
                        reason=ev.reason,
                        pod_uid=ev.pod_uid,
                        pod_name=ev.pod_name,
                        message=ev.message,
                    )
                )
            return resp

    def Health(self, request: pb.HealthRequest, context) -> pb.HealthResponse:
        return pb.HealthResponse(ok=True, status="ok", boot_id=self.boot_id)

    def Metrics(self, request: pb.MetricsRequest, context) -> pb.MetricsResponse:
        return pb.MetricsResponse(
            prometheus_text=self.scheduler.metrics.expose()
        )

    def Inspect(self, request: pb.InspectRequest, context) -> pb.InspectResponse:
        """Flight-recorder introspection over the agent's channel: the
        same payloads the /debug HTTP endpoints serve (cycle records,
        Perfetto trace, per-pod timeline), JSON-encoded."""
        import json

        fr = self.scheduler.flight
        kind = request.kind or "flightrecorder"
        last = request.last if request.last > 0 else 128
        # kind="pod" stays available with the recorder disabled — the
        # timeline join degrades to the events-ring half, exactly like
        # the /debug/pods HTTP endpoint
        if fr is None and kind in ("flightrecorder", "trace"):
            return pb.InspectResponse(
                ok=False, error="flight recorder disabled "
                "(flightRecorderSize: 0)",
            )
        if kind == "flightrecorder":
            payload = {
                "cycles": fr.to_dicts(last=last),
                "derived": fr.derived(last=last),
            }
        elif kind == "trace":
            from ..core.flight_recorder import to_chrome_trace

            payload = to_chrome_trace(
                fr.snapshot(last=last), epoch=fr.epoch
            )
        elif kind == "pod":
            payload = self.scheduler.pod_timeline(request.pod_uid)
            if payload is None:
                return pb.InspectResponse(
                    ok=False,
                    error=f"pod {request.pod_uid!r} not seen",
                )
        else:
            return pb.InspectResponse(
                ok=False,
                error=f"unknown kind {kind!r} "
                "(flightrecorder | trace | pod)",
            )
        return pb.InspectResponse(
            ok=True, json=json.dumps(payload).encode()
        )

    # ---- the submission front door (service/admission.py) ---------------

    def Submit(self, request: pb.SubmitRequest, context) -> pb.SubmitResponse:
        """Admission-controlled pod intake: whole-request accept or
        reject. Shed answers RESOURCE_EXHAUSTED with a retry-after-ms
        trailing-metadata hint; an OK ack means every pod was journaled
        through the WAL (group fsync) first — `durable` reports
        whether that barrier actually held (no state dir = false).

        Trace context (core/spans) rides gRPC metadata, not the proto:
        a W3C `traceparent` invocation-metadata entry joins the
        submission's spans to the caller's trace, and the ack's
        trailing metadata echoes the effective traceparent back (the
        caller's own, or the head-sampled root the scheduler minted)."""
        adm = self.admission
        if adm is None:
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                "front door disabled (start with --submit-addr or "
                "enable_front_door())",
            )
        try:
            pods = [convert.pod_from(p) for p in request.pods]
        except (ValueError, KeyError, TypeError) as e:
            # the proto contract: malformed pods answer
            # INVALID_ARGUMENT (an unparseable quantity here would
            # otherwise surface as UNKNOWN, which retrying clients
            # treat as transient and hammer forever)
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"unparseable pod in submission: {e}",
            )
        traceparent = ""
        for key, value in context.invocation_metadata() or ():
            if key == "traceparent":
                traceparent = value
                break
        res = adm.submit(pods, traceparent=traceparent)
        if res.invalid:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT, res.reason
            )
        if res.reason == "draining":
            context.abort(
                grpc.StatusCode.UNAVAILABLE,
                "front door draining (shutdown in progress)",
            )
        if res.shed:
            context.set_trailing_metadata(
                (("retry-after-ms", f"{res.retry_after_ms:g}"),)
            )
            context.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED,
                f"admission shed: {res.reason}",
            )
        if res.traceparent:
            context.set_trailing_metadata(
                (("traceparent", res.traceparent),)
            )
        return pb.SubmitResponse(
            boot_id=self.boot_id,
            accepted=res.accepted,
            durable=res.durable,
            queue_depth=res.queue_depth,
        )

    def NodeChurn(
        self, request: pb.NodeChurnRequest, context
    ) -> pb.NodeChurnResponse:
        adm = self.admission
        if adm is None:
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                "front door disabled (start with --submit-addr or "
                "enable_front_door())",
            )
        from .admission import AdmissionClosed

        try:
            adds = [convert.node_from(n) for n in request.adds]
            updates = [convert.node_from(n) for n in request.updates]
        except (ValueError, KeyError, TypeError) as e:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"unparseable node in churn request: {e}",
            )
        try:
            durable = adm.node_churn(
                adds=adds,
                updates=updates,
                deletes=list(request.deletes),
            )
        except AdmissionClosed:
            context.abort(
                grpc.StatusCode.UNAVAILABLE,
                "front door draining (shutdown in progress)",
            )
        return pb.NodeChurnResponse(
            boot_id=self.boot_id, durable=durable
        )


_RPCS = {
    "Update": (pb.UpdateRequest, pb.UpdateResponse),
    "Cycle": (pb.CycleRequest, pb.CycleResponse),
    "Health": (pb.HealthRequest, pb.HealthResponse),
    "Metrics": (pb.MetricsRequest, pb.MetricsResponse),
    "Inspect": (pb.InspectRequest, pb.InspectResponse),
    "Submit": (pb.SubmitRequest, pb.SubmitResponse),
    "NodeChurn": (pb.NodeChurnRequest, pb.NodeChurnResponse),
}


def add_to_server(servicer: SchedulerService, server: grpc.Server) -> None:
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            getattr(servicer, name),
            request_deserializer=req.FromString,
            response_serializer=resp.SerializeToString,
        )
        for name, (req, resp) in _RPCS.items()
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),)
    )


def serve(
    address: str = "127.0.0.1:50051",
    config: SchedulerConfiguration | None = None,
    max_workers: int = 4,
    profile_every: int = 0,
    metrics: SchedulerMetrics | None = None,
    forced_sync: bool | None = None,
    state=None,  # state.DurableState | None (restore-then-journal)
    device=None,  # None = the card; "cpu" runs the plain versions
) -> tuple[grpc.Server, SchedulerService, int]:
    """Start the shim; returns (server, servicer, bound_port)."""
    service = SchedulerService(
        config=config, profile_every=profile_every, metrics=metrics,
        forced_sync=forced_sync, state=state, device=device,
    )
    # no SO_REUSEPORT: a second shim on the same address must fail loudly,
    # not silently split the accept queue with the first
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=(("grpc.so_reuseport", 0),),
    )
    add_to_server(service, server)
    port = server.add_insecure_port(address)
    if port == 0 and not address.rstrip().endswith(":0"):
        # grpc signals bind failure by returning port 0; only an explicit
        # ":0" (ephemeral) request may legitimately come back remapped
        server.stop(grace=0)
        raise OSError(f"failed to bind gRPC address {address!r}")
    server.start()
    return server, service, port


def main() -> None:  # pragma: no cover - exercised via the CLI
    import argparse

    ap = argparse.ArgumentParser(description="TPU scheduler gRPC shim")
    ap.add_argument("--address", default="127.0.0.1:50051")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu for the plain versions")
    args = ap.parse_args()
    server, _, port = serve(args.address, device=args.device)
    print(f"scheduler shim listening on port {port}", flush=True)
    server.wait_for_termination()


if __name__ == "__main__":  # pragma: no cover
    main()
