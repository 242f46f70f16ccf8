"""The host plugins of `k8s_scheduler_tpu/framework/host.py` (pure Python,
the reference's names and structure): the Reserve / Permit / PreBind /
PostBind extension points. Its HTTP scheduler-extender client
(`HTTPExtender`, `run_extender_prepass`) is ROADMAP A10b.

The device program owns the batched Filter/Score/commit; everything that
upstream runs BETWEEN selecting a host and posting the Binding — Reserve,
Permit, PreBind, Bind, PostBind — is host-side control flow around
assume/bind, so the extension surface lives here as plain Python hooks the
`Scheduler` invokes per scheduled pod (core/scheduler.py apply loop).
Out-of-tree code registers a `HostPlugin`; any hook returning a rejection
string vetoes the placement (Reserve/Permit reject -> unreserve + requeue
unschedulable with the plugin as the reason; PreBind error -> unreserve +
backoff retry, upstream RunPreBindPlugins semantics).
"""

from __future__ import annotations

from typing import Sequence

from ..models.api import Pod


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
