"""The host side of `k8s_scheduler_tpu/framework/host.py` (pure Python,
the reference's names and structure): the Reserve / Permit / PreBind /
PostBind extension points and the HTTP scheduler-extender client
(`HTTPExtender`, `run_extender_prepass`).

The device program owns the batched Filter/Score/commit; everything that
upstream runs BETWEEN selecting a host and posting the Binding — Reserve,
Permit, PreBind, Bind, PostBind — is host-side control flow around
assume/bind, so the extension surface lives here as plain Python hooks the
`Scheduler` invokes per scheduled pod (core/scheduler.py apply loop).
Out-of-tree code registers a `HostPlugin`; any hook returning a rejection
string vetoes the placement (Reserve/Permit reject -> unreserve + requeue
unschedulable with the plugin as the reason; PreBind error -> unreserve +
backoff retry, upstream RunPreBindPlugins semantics).

`HTTPExtender` speaks the upstream SchedulerExtender webhook protocol
(ExtenderArgs/ExtenderFilterResult/HostPriorityList JSON): Filter and
Prioritize run host-side BEFORE the device cycle (their verdicts ride into
the device program as an extra [P, N] mask / score table), and a bind-verb
extender replaces the default binder for pods it manages.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Sequence

from ..config.types import Extender
from ..models.api import Node, Pod


class HostPlugin:
    """Base class for host-side plugins; override any subset."""

    name: str = ""

    def reserve(self, pod: Pod, node_name: str) -> str | None:
        """Claim host-side resources for a tentative placement. A string
        return rejects the placement (the reason)."""
        return None

    def unreserve(self, pod: Pod, node_name: str) -> None:
        """Roll back reserve() — called on any later rejection/failure."""

    def permit(self, pod: Pod, node_name: str) -> str | None:
        """Final veto before binding (upstream Permit; the batched gang
        unwind already handles Coscheduling on-device)."""
        return None

    def pre_bind(self, pod: Pod, node_name: str) -> str | None:
        """Pre-bind work (e.g. volume attach). A string return fails the
        bind; the pod retries with backoff."""
        return None

    def post_bind(self, pod: Pod, node_name: str) -> None:
        """Informational; runs after a successful bind."""


class HostPluginRejection(Exception):
    def __init__(self, plugin: str, point: str, reason: str):
        super().__init__(f"{plugin}/{point}: {reason}")
        self.plugin = plugin
        self.point = point
        self.reason = reason


def run_reserve_permit_prebind(
    plugins: Sequence[HostPlugin], pod: Pod, node_name: str
) -> None:
    """Reserve -> Permit -> PreBind across `plugins`, unreserving already-
    reserved plugins (reverse order) on any rejection. Raises
    HostPluginRejection; the caller maps the point to requeue semantics."""
    reserved: list[HostPlugin] = []

    def unwind() -> None:
        for p in reversed(reserved):
            p.unreserve(pod, node_name)

    for p in plugins:
        r = p.reserve(pod, node_name)
        if r is not None:
            unwind()
            raise HostPluginRejection(p.name, "Reserve", r)
        reserved.append(p)
    for p in plugins:
        r = p.permit(pod, node_name)
        if r is not None:
            unwind()
            raise HostPluginRejection(p.name, "Permit", r)
    for p in plugins:
        r = p.pre_bind(pod, node_name)
        if r is not None:
            unwind()
            raise HostPluginRejection(p.name, "PreBind", r)


def run_post_bind(
    plugins: Sequence[HostPlugin], pod: Pod, node_name: str
) -> None:
    for p in plugins:
        p.post_bind(pod, node_name)


def run_unreserve(
    plugins: Sequence[HostPlugin], pod: Pod, node_name: str
) -> None:
    for p in reversed(list(plugins)):
        p.unreserve(pod, node_name)


# ---------------------------------------------------------------------------
# HTTP extenders
# ---------------------------------------------------------------------------


class ExtenderError(Exception):
    pass


def _pod_json(pod: Pod) -> dict:
    return {
        "metadata": {
            "name": pod.name,
            "namespace": pod.namespace,
            "uid": pod.uid,
            "labels": dict(pod.metadata.labels),
        },
    }


class HTTPExtender:
    """Upstream SchedulerExtender webhook client (JSON over HTTP)."""

    def __init__(self, config: Extender):
        self.config = config

    def _post(self, verb: str, payload: dict) -> dict:
        req = urllib.request.Request(
            f"{self.config.url_prefix.rstrip('/')}/{verb}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(
                req, timeout=self.config.http_timeout_seconds
            ) as resp:
                return json.loads(resp.read() or b"{}")
        except (urllib.error.URLError, OSError, json.JSONDecodeError) as e:
            raise ExtenderError(str(e)) from e

    def filter(self, pod: Pod, node_names: list[str]) -> list[str]:
        """Feasible subset of `node_names` for `pod` (ExtenderFilterResult;
        raises ExtenderError on webhook failure or Error payload)."""
        out = self._post(
            self.config.filter_verb,
            {"Pod": _pod_json(pod), "NodeNames": node_names},
        )
        if out.get("Error"):
            raise ExtenderError(out["Error"])
        names = out.get("NodeNames")
        return list(names) if names is not None else list(node_names)

    def prioritize(self, pod: Pod, node_names: list[str]) -> dict[str, float]:
        """node name -> weighted score (HostPriorityList x weight)."""
        out = self._post(
            self.config.prioritize_verb,
            {"Pod": _pod_json(pod), "NodeNames": node_names},
        )
        if isinstance(out, dict):
            items = out.get("Items") or out.get("items") or []
        else:
            items = out
        return {
            h["Host"]: float(h["Score"]) * self.config.weight for h in items
        }

    def bind(self, pod: Pod, node_name: str) -> None:
        out = self._post(
            self.config.bind_verb,
            {
                "PodName": pod.name,
                "PodNamespace": pod.namespace,
                "PodUID": pod.uid,
                "Node": node_name,
            },
        )
        if out.get("Error"):
            raise ExtenderError(out["Error"])

    @property
    def is_filter(self) -> bool:
        return bool(self.config.filter_verb)

    @property
    def is_prioritizer(self) -> bool:
        return bool(self.config.prioritize_verb)

    @property
    def is_binder(self) -> bool:
        return bool(self.config.bind_verb)


def run_extender_prepass(
    extenders: Sequence[HTTPExtender],
    pending: Sequence[Pod],
    nodes: Sequence[Node],
):
    """Filter+Prioritize every pending pod through every configured
    extender. Returns (mask [P, N] bool, score [P, N] f32, errors
    dict pod-index -> message) as numpy arrays, or (None, None, {}) when
    no extender filters or prioritizes. A pod's score row is the sum, in
    f32 and extender order, of the weighted scores of the nodes its
    filters passed."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    flt = [e for e in extenders if e.is_filter]
    pri = [e for e in extenders if e.is_prioritizer]
    if not flt and not pri:
        return None, None, {}
    names = [n.name for n in nodes]
    index = {nm: i for i, nm in enumerate(names)}
    P, N = len(pending), len(nodes)
    mask = np.ones((P, N), bool)
    score = np.zeros((P, N), np.float32)
    errors: dict[int, str] = {}

    def one_pod(pi_pod):
        pi, pod = pi_pod
        feasible = names
        err_msg = None
        for e in flt:
            try:
                feasible = e.filter(pod, list(feasible))
            except ExtenderError as err:
                if e.config.ignorable:
                    continue
                err_msg = str(err)
                feasible = []
                break
        row = np.zeros(N, bool)
        for nm in feasible:
            i = index.get(nm)
            if i is not None:
                row[i] = True
        srow = np.zeros(N, np.float32)
        if err_msg is None:
            for e in pri:
                try:
                    for nm, s in e.prioritize(pod, list(feasible)).items():
                        i = index.get(nm)
                        if i is not None:
                            srow[i] += s
                except ExtenderError as err:
                    if e.config.ignorable:
                        continue  # consult the remaining extenders
                    err_msg = str(err)
                    row[:] = False
                    break
        return pi, row, srow, err_msg

    # webhook round-trips are independent per pod; a bounded pool keeps a
    # slow or down extender from serializing the whole pending set behind
    # per-pod timeouts
    with ThreadPoolExecutor(max_workers=16) as pool:
        for pi, row, srow, err_msg in pool.map(one_pod, enumerate(pending)):
            mask[pi] = row
            score[pi] = srow
            if err_msg is not None:
                errors[pi] = err_msg
    return mask, score, errors
