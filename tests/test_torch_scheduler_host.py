"""The host-side runtime tests of tests/test_scheduler_host.py against the
port: the SchedulingQueue and SchedulerCache cases run against both
implementations (the reference's `internal/` and the port's copies,
parametrised), and the Scheduler end-to-end cases against the port's
`Scheduler(device="cpu")` on a fake cluster."""

import pytest

import k8s_scheduler_tpu.internal.cache as ref_cache
import k8s_scheduler_tpu.internal.queue as ref_queue
import k8s_scheduler_tpu.models as ref_models
import k8s_scheduler_tpu_torch.internal.cache as port_cache
import k8s_scheduler_tpu_torch.internal.queue as port_queue
import k8s_scheduler_tpu_torch.models as port_models
from k8s_scheduler_tpu_torch.core import Scheduler as PortScheduler
from k8s_scheduler_tpu_torch.models import MakeNode, MakePod
from k8s_scheduler_tpu_torch.models.api import PodGroup
from torch_one_thread import one_torch_thread  # noqa: F401


def _impl(q, c, m):
    return (q.SchedulingQueue, c.SchedulerCache, m.MakeNode, m.MakePod,
            q.EVENT_NODE_ADD, q.EVENT_POD_DELETE)


IMPLS = pytest.mark.parametrize("impl", [
    pytest.param(_impl(ref_queue, ref_cache, ref_models), id="reference"),
    pytest.param(_impl(port_queue, port_cache, port_models), id="port"),
])


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt


class FakeCluster:
    """Stands in for the API server: records binds/evictions and feeds
    confirmation events back, like the informer would."""

    def __init__(self, sched=None):
        self.bound = {}
        self.evicted = []
        self.fail_next_binds = 0
        self.sched = sched

    def bind(self, pod, node_name):
        if self.fail_next_binds > 0:
            self.fail_next_binds -= 1
            raise RuntimeError("bind failed")
        self.bound[pod.name] = node_name
        if self.sched is not None:  # informer echo: pod now bound
            self.sched.cache.confirm(pod.uid)

    def evict(self, pod, node_name):
        self.evicted.append(pod.name)
        if self.sched is not None:
            self.sched.on_pod_delete(pod.uid)


def make_scheduler(clock=None):
    clock = clock or FakeClock()
    cluster = FakeCluster()
    sched = PortScheduler(binder=cluster.bind, evictor=cluster.evict, now=clock,
                          pad_bucket=8, device="cpu")
    cluster.sched = sched
    return sched, cluster, clock


# ---- queue unit tests ------------------------------------------------------


@IMPLS
def test_queue_update_honors_backoff_window(impl):
    SchedulingQueue, SchedulerCache, MakeNode, MakePod, EVENT_NODE_ADD, EVENT_POD_DELETE = impl
    clock = FakeClock()
    q = SchedulingQueue(initial_backoff_seconds=10.0, now=clock)
    pod = MakePod("p").obj()
    q.add(pod)
    q.pop_ready()
    q.requeue_unschedulable(pod, reasons="NodeResourcesFit")
    # a spec update can cure the failure but must not skip the 10s backoff
    q.update(pod)
    assert q.pop_ready() == []
    clock.tick(10.1)
    assert [p.name for p in q.pop_ready()] == ["p"]


def test_port_observed_bind_drops_stale_queue_entry():
    sched, cluster, clock = make_scheduler()
    sched.on_node_add(MakeNode("n0").capacity({"cpu": "4"}).obj())
    pod = MakePod("p").req({"cpu": "1"}).obj()
    sched.on_pod_add(pod)
    # late informer echo: the pod is observed bound before the cycle runs
    sched.on_pod_add(pod, node_name="n0")
    stats = sched.schedule_cycle()
    # must not double-schedule (pod would be both pending and existing)
    assert stats.attempted == 0
    assert sched.cache.counts()["bound"] == 1


@IMPLS
def test_queue_backoff_grows_and_expires(impl):
    SchedulingQueue, SchedulerCache, MakeNode, MakePod, EVENT_NODE_ADD, EVENT_POD_DELETE = impl
    clock = FakeClock()
    q = SchedulingQueue(initial_backoff_seconds=1.0, max_backoff_seconds=4.0,
                        now=clock)
    pod = MakePod("p").obj()
    q.add(pod)
    assert [p.name for p in q.pop_ready()] == ["p"]
    q.requeue_backoff(pod)
    assert q.pop_ready() == []  # still backing off
    clock.tick(1.1)
    assert [p.name for p in q.pop_ready()] == ["p"]  # attempt 2
    q.requeue_backoff(pod)
    clock.tick(1.1)
    assert q.pop_ready() == []  # backoff doubled to 2s
    clock.tick(1.0)
    assert [p.name for p in q.pop_ready()] == ["p"]


@IMPLS
def test_queue_unschedulable_waits_for_matching_event(impl):
    SchedulingQueue, SchedulerCache, MakeNode, MakePod, EVENT_NODE_ADD, EVENT_POD_DELETE = impl
    clock = FakeClock()
    q = SchedulingQueue(now=clock)
    pod = MakePod("p").obj()
    q.add(pod)
    q.pop_ready()
    q.requeue_unschedulable(pod, reasons="NodeResourcesFit")
    # PodDelete can cure NodeResourcesFit; backoff already expired?
    assert q.pending_counts()["unschedulable"] == 1
    q.move_all_to_active_or_backoff(EVENT_POD_DELETE)
    counts = q.pending_counts()
    assert counts["unschedulable"] == 0
    assert counts["active"] + counts["backoff"] == 1


@IMPLS
def test_queue_hint_filters_irrelevant_events(impl):
    SchedulingQueue, SchedulerCache, MakeNode, MakePod, EVENT_NODE_ADD, EVENT_POD_DELETE = impl
    clock = FakeClock()
    q = SchedulingQueue(now=clock)
    pod = MakePod("p").obj()
    q.add(pod)
    q.pop_ready()
    q.requeue_unschedulable(pod, reasons="NodeAffinity")
    # PodDelete cannot cure a NodeAffinity rejection
    q.move_all_to_active_or_backoff(EVENT_POD_DELETE)
    assert q.pending_counts()["unschedulable"] == 1
    q.move_all_to_active_or_backoff(EVENT_NODE_ADD)
    assert q.pending_counts()["unschedulable"] == 0


@IMPLS
def test_queue_unschedulable_timeout_flush(impl):
    SchedulingQueue, SchedulerCache, MakeNode, MakePod, EVENT_NODE_ADD, EVENT_POD_DELETE = impl
    clock = FakeClock()
    q = SchedulingQueue(unschedulable_timeout_seconds=300.0, now=clock)
    pod = MakePod("p").obj()
    q.add(pod)
    q.pop_ready()
    q.requeue_unschedulable(pod, reasons="NodeAffinity")
    clock.tick(301.0)
    q.flush_unschedulable_timeout()
    assert q.pending_counts()["unschedulable"] == 0


# ---- cache unit tests ------------------------------------------------------


@IMPLS
def test_cache_assume_confirm_lifecycle(impl):
    SchedulingQueue, SchedulerCache, MakeNode, MakePod, EVENT_NODE_ADD, EVENT_POD_DELETE = impl
    clock = FakeClock()
    c = SchedulerCache(assumed_pod_ttl_seconds=30.0, now=clock)
    c.add_node(MakeNode("n0").capacity({"cpu": "4"}).obj())
    pod = MakePod("p").obj()
    c.assume(pod, "n0")
    assert c.is_assumed(pod.uid)
    assert len(c.existing_pods()) == 1  # assumed counts as existing
    c.finish_binding(pod.uid)
    c.confirm(pod.uid)
    assert not c.is_assumed(pod.uid)
    assert c.counts()["bound"] == 1


@IMPLS
def test_cache_assumed_ttl_expiry(impl):
    SchedulingQueue, SchedulerCache, MakeNode, MakePod, EVENT_NODE_ADD, EVENT_POD_DELETE = impl
    clock = FakeClock()
    c = SchedulerCache(assumed_pod_ttl_seconds=30.0, now=clock)
    pod = MakePod("p").obj()
    c.assume(pod, "n0")
    c.finish_binding(pod.uid)
    clock.tick(31.0)
    expired = c.cleanup_expired()
    assert [(p.name, n) for p, n in expired] == [("p", "n0")]
    assert c.counts()["assumed"] == 0


@IMPLS
def test_cache_forget_on_bind_failure(impl):
    SchedulingQueue, SchedulerCache, MakeNode, MakePod, EVENT_NODE_ADD, EVENT_POD_DELETE = impl
    c = SchedulerCache()
    pod = MakePod("p").obj()
    c.assume(pod, "n0")
    c.forget(pod.uid)
    assert c.existing_pods() == []


# ---- scheduler end-to-end --------------------------------------------------


def test_port_scheduler_end_to_end_bind():
    sched, cluster, _ = make_scheduler()
    sched.on_node_add(MakeNode("n0").capacity({"cpu": "4"}).obj())
    sched.on_node_add(MakeNode("n1").capacity({"cpu": "4"}).obj())
    for i in range(4):
        sched.on_pod_add(MakePod(f"p{i}").req({"cpu": "1"}).obj())
    stats = sched.schedule_cycle()
    assert stats.attempted == 4
    assert stats.scheduled == 4
    assert len(cluster.bound) == 4
    assert sched.cache.counts()["bound"] == 4  # confirmations arrived
    # second cycle: nothing pending
    assert sched.schedule_cycle().attempted == 0


def test_port_scheduler_sequential_cycles_respect_capacity():
    sched, cluster, _ = make_scheduler()
    sched.on_node_add(MakeNode("n0").capacity({"cpu": "2"}).obj())
    sched.on_pod_add(MakePod("a").req({"cpu": "2"}).obj())
    sched.schedule_cycle()
    sched.on_pod_add(MakePod("b").req({"cpu": "2"}).obj())
    stats = sched.schedule_cycle()
    assert stats.unschedulable == 1  # n0 is full with a bound pod
    assert cluster.bound == {"a": "n0"}


def test_port_scheduler_bind_failure_backs_off_and_retries():
    sched, cluster, clock = make_scheduler()
    sched.on_node_add(MakeNode("n0").capacity({"cpu": "4"}).obj())
    pod = MakePod("p").req({"cpu": "1"}).obj()
    sched.on_pod_add(pod)
    cluster.fail_next_binds = 1
    stats = sched.schedule_cycle()
    assert stats.bind_errors == 1 and stats.scheduled == 0
    assert not sched.cache.is_assumed(pod.uid)  # assumption forgotten
    clock.tick(2.0)  # past initial backoff
    stats = sched.schedule_cycle()
    assert stats.scheduled == 1
    assert cluster.bound == {"p": "n0"}


def test_port_scheduler_preemption_flow():
    sched, cluster, clock = make_scheduler()
    sched.on_node_add(MakeNode("n0").capacity({"cpu": "2"}).obj())
    victim = MakePod("victim").req({"cpu": "2"}).priority(1).obj()
    sched.on_pod_add(victim, node_name="n0")  # already bound
    sched.on_pod_add(MakePod("urgent").req({"cpu": "2"}).priority(10).obj())
    stats = sched.schedule_cycle()
    assert stats.unschedulable == 1
    assert stats.preemptors == 1
    assert stats.victims == 1
    assert cluster.evicted == ["victim"]
    # eviction event moved the preemptor out of the unschedulable tier;
    # next cycle it lands on its nominated node
    clock.tick(2.0)
    stats = sched.schedule_cycle()
    assert stats.scheduled == 1
    assert cluster.bound == {"urgent": "n0"}


def test_port_scheduler_gang_requeue():
    sched, cluster, clock = make_scheduler()
    sched.on_node_add(MakeNode("n0").capacity({"cpu": "4"}).obj())
    sched.add_pod_group(PodGroup("job", 3))
    for i in range(3):
        sched.on_pod_add(
            MakePod(f"g{i}").req({"cpu": "2"}).group("job").created(i).obj()
        )
    stats = sched.schedule_cycle()
    assert stats.scheduled == 0
    assert stats.gang_dropped == 2
    assert stats.unschedulable == 3
    assert cluster.bound == {}
    # more capacity arrives -> the whole gang lands
    sched.on_node_add(MakeNode("n1").capacity({"cpu": "4"}).obj())
    clock.tick(2.0)
    stats = sched.schedule_cycle()
    assert stats.scheduled == 3
    assert len(cluster.bound) == 3


def test_port_scheduler_node_delete_requeues():
    sched, cluster, clock = make_scheduler()
    sched.on_node_add(MakeNode("n0").capacity({"cpu": "1"}).obj())
    sched.on_pod_add(MakePod("p").req({"cpu": "2"}).obj())
    stats = sched.schedule_cycle()
    assert stats.unschedulable == 1
    sched.on_node_add(MakeNode("big").capacity({"cpu": "8"}).obj())
    clock.tick(2.0)
    stats = sched.schedule_cycle()
    assert stats.scheduled == 1
    assert cluster.bound == {"p": "big"}


def test_port_metrics_keep_the_reference_names_and_labels():
    """Every metric of the port's registry has the reference metric of the
    same attribute, name and label set (prometheus_client stores a
    counter's name without `_total`); the build info's labels name torch,
    CUDA and the device where the reference's name jax and its backend."""
    from k8s_scheduler_tpu.metrics import SchedulerMetrics as RefMetrics
    from k8s_scheduler_tpu_torch.metrics import SchedulerMetrics

    ref, port = RefMetrics(), SchedulerMetrics()
    for attr, m in vars(port).items():
        if attr == "registry":
            continue
        r = getattr(ref, attr)
        name = m.name[: -len("_total")] if m.kind == "counter" else m.name
        assert (name, type(r).__name__.lower()) == (r._name, m.kind), attr
        if attr == "build_info":
            assert m.labelnames == ("python", "torch", "cuda", "device", "git")
        else:
            assert m.labelnames == tuple(r._labelnames), attr
    assert len(port.registry.metrics) == len(vars(port)) - 1
    port.observe_attempts("scheduled", 0.003, "p", 4)
    assert port.schedule_attempts.labels(result="scheduled", profile="p").get() == 4
    assert port.attempt_duration.labels(result="scheduled", profile="p").count == 4
    port.last_cycle_age.set_function(lambda: 2.5)
    assert port.last_cycle_age.get() == 2.5
