"""Oracle: a straightforward per-pod Python reimplementation of the
reference scheduler's semantics — the port's own copy of
`k8s_scheduler_tpu/oracle.py`, line for line, over the port's
`models/api.py` and its `config/types.py` filter order — used as the
differential-test ground truth for the port's kernels (`fuzz/replay.py`).

It deliberately mirrors the reference's shape — one pod at a time in
priority order, Filter plugins then Score plugins then selectHost, state
updated between pods (SURVEY.md §3.2) — NOT the batched design, so that
agreement between the two is meaningful evidence of parity.

Tie-breaking: lowest node index on equal score (the deterministic stand-in
for upstream's random reservoir tie-break; both implementations use it so
differential tests are exact).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from .config.types import _DEFAULT_FILTERS as _FILTER_ORDER
from .models import api
from .models.api import (
    Affinity,
    LabelSelector,
    Node,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    Pod,
    PodAffinityTerm,
)

MAX_NODE_SCORE = 100.0


def _match_expression(labels: dict[str, str], req: NodeSelectorRequirement,
                      name: str | None = None) -> bool:
    """labels.Requirement semantics: NotIn/DoesNotExist match on absent key."""
    op = req.operator
    if name is not None:  # matchFields metadata.name
        if op == api.OP_IN:
            return name in req.values
        if op == api.OP_NOT_IN:
            return name not in req.values
        return False
    present = req.key in labels
    val = labels.get(req.key)
    if op == api.OP_IN:
        return present and val in req.values
    if op == api.OP_NOT_IN:
        return not present or val not in req.values
    if op == api.OP_EXISTS:
        return present
    if op == api.OP_DOES_NOT_EXIST:
        return not present
    if op == api.OP_GT:
        try:
            return present and float(val) > float(req.values[0])
        except (ValueError, IndexError):
            return False
    if op == api.OP_LT:
        try:
            return present and float(val) < float(req.values[0])
        except (ValueError, IndexError):
            return False
    raise ValueError(f"unknown operator {op}")


def _match_term(node: Node, term: NodeSelectorTerm) -> bool:
    labels = _node_labels(node)
    return all(
        _match_expression(labels, e) for e in term.match_expressions
    ) and all(
        _match_expression({}, e, name=node.name) for e in term.match_fields
    )


def _node_labels(node: Node) -> dict[str, str]:
    labels = dict(node.metadata.labels)
    labels.setdefault("kubernetes.io/hostname", node.name)
    return labels


def match_label_selector(sel: LabelSelector, labels: dict[str, str]) -> bool:
    for k, v in sel.match_labels.items():
        if labels.get(k) != v:
            return False
    return all(_match_expression(labels, e) for e in sel.match_expressions)


def tolerates(pod: Pod, taint: api.Taint) -> bool:
    for t in pod.spec.tolerations:
        if t.effect and t.effect != taint.effect:
            continue
        if t.operator == "Exists":
            if t.key == "" or t.key == taint.key:
                return True
        else:  # Equal
            if t.key == taint.key and t.value == taint.value:
                return True
    return False


@dataclasses.dataclass
class OracleState:
    """Mutable per-node state mirroring NodeInfo aggregation."""

    nodes: list[Node]
    requested: list[dict[str, float]]  # per node
    pods_on_node: list[list[Pod]]  # per node (existing + committed this run)

    # memoized per-pod / per-image quantities that scoring would otherwise
    # recompute once per candidate node (O(P*N^2) without these)
    _taint_max: dict[str, int] = dataclasses.field(default_factory=dict)
    _image_spread: dict[str, float] = dataclasses.field(default_factory=dict)
    # bootstrap any_match is node-independent; cache per (pod, term) and
    # invalidate via a version bumped on every add/remove
    _version: int = 0
    _bootstrap: dict = dataclasses.field(default_factory=dict)
    # volumes (VolumeBinding): keyed maps, empty = no volume constraints
    pvcs: dict = dataclasses.field(default_factory=dict)  # "ns/name" -> PVC
    pvs: dict = dataclasses.field(default_factory=dict)  # name -> PV
    storage_classes: dict = dataclasses.field(default_factory=dict)
    # derived volume indexes (built once; volume state is per-cycle input)
    pvs_by_class: dict = dataclasses.field(default_factory=dict)
    claimed_pv_names: set = dataclasses.field(default_factory=set)
    # in-cycle static-PV claims (VERDICT r2 item 8): a committed pod with
    # an unbound WaitForFirstConsumer claim takes the lowest-index
    # compatible PV (the kernels' deterministic binder choice); later
    # pods in the same cycle see it as unavailable
    pv_list: list = dataclasses.field(default_factory=list)
    claimed_static: set = dataclasses.field(default_factory=set)
    pod_claims: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def build(
        nodes: Sequence[Node],
        existing: Sequence[tuple[Pod, str]],
        pvcs: Sequence = (),
        pvs: Sequence = (),
        storage_classes: Sequence = (),
    ) -> "OracleState":
        idx = {n.name: i for i, n in enumerate(nodes)}
        by_class: dict = {}
        for v in pvs:
            by_class.setdefault(v.storage_class, []).append(v)
        st = OracleState(
            nodes=list(nodes),
            requested=[{} for _ in nodes],
            pods_on_node=[[] for _ in nodes],
            pvcs={c.key: c for c in pvcs},
            pvs={v.name: v for v in pvs},
            storage_classes={s.name: s for s in storage_classes},
            pvs_by_class=by_class,
            claimed_pv_names={
                c.volume_name for c in pvcs if c.volume_name
            },
            pv_list=list(pvs),
        )
        for pod, node_name in existing:
            i = idx.get(node_name)
            if i is None:
                continue
            # existing pods' volume usage is already reflected through
            # their PVCs' volume_name (claimed_pv_names); no in-cycle
            # claim (mirrors the encoder's pv_avail)
            st.add(i, pod, claim_volumes=False)
        return st

    def add(self, node_idx: int, pod: Pod,
            claim_volumes: bool = True) -> None:
        for r, v in pod.resource_requests().items():
            self.requested[node_idx][r] = self.requested[node_idx].get(r, 0.0) + v
        self.pods_on_node[node_idx].append(pod)
        self._version += 1
        self._bootstrap.clear()  # keys embed _version; old entries are dead
        if claim_volumes and pod.spec.volumes:
            self._claim_static_pvs(node_idx, pod)

    def _claim_static_pvs(self, node_idx: int, pod: Pod) -> None:
        """Mirror of ops/volumes.chosen_pv_sdr + fold_pv_claims: slots
        claim in spec order; each claims the LOWEST-INDEX compatible
        available unclaimed PV whose removal keeps Hall's condition over
        the pod's remaining static-needy slots (the SDR-safe choice —
        exact: it always extends to a full distinct assignment when one
        exists). A dynamic-capable slot with no safe candidate rides
        dynamic instead of stealing; a needy slot with no safe candidate
        falls back to the lowest candidate (beyond Hall's guarantee)."""
        import itertools

        claims = []
        node = self.nodes[node_idx]
        slots = []  # (pvc, dyn_capable) in spec order
        for claim in pod.spec.volumes:
            pvc = self.pvcs.get(f"{pod.namespace}/{claim}")
            if pvc is None or pvc.volume_name:
                continue
            cls = self.storage_classes.get(pvc.storage_class)
            if cls is None or cls.volume_binding_mode != api.VOLUME_BINDING_WAIT:
                continue
            dyn = bool(cls.provisioner) and (
                not cls.allowed_topologies
                or any(_match_term(node, t) for t in cls.allowed_topologies)
            )
            slots.append((pvc, dyn))

        def cand_of(pvc):  # current claimable PVs, pv_list order
            return [
                pv
                for pv in self.pv_list
                if pv.storage_class == pvc.storage_class
                and _pv_usable(self, pv, pvc, node)
            ]

        def other_subsets(needy_cands):
            """Mirror of ops/volumes._sdr_other_subsets plus the
            capped-regime dominance groups of _sdr_safe_choice."""
            others = sorted(needy_cands)
            if len(others) <= 6:
                return [
                    s
                    for r in range(1, len(others) + 1)
                    for s in itertools.combinations(others, r)
                ]
            subs = [
                *itertools.combinations(others, 1),
                *itertools.combinations(others, 2),
                tuple(others),
            ]
            for a in others:  # dominance groups (needy down-sets)
                subs.append(tuple(
                    t for t in others
                    if needy_cands[t] <= needy_cands[a]
                ))
            return subs

        for j, (pvc, dyn) in enumerate(slots):
            cand = cand_of(pvc)
            # needy = later unresolved slots that REQUIRE a static PV
            needy = [
                (t, slots[t][0])
                for t in range(j + 1, len(slots))
                if not slots[t][1]
            ]
            needy_cands = {t: {pv.name for pv in cand_of(p)} for t, p in needy}
            # tight unions are PV-independent: compute once per slot, not
            # per candidate — a PV is unsafe iff it lies in any of them
            unsafe = set()
            for s in other_subsets(needy_cands):
                union = set().union(*(needy_cands[t] for t in s))
                if len(union) - 1 < len(s):
                    unsafe |= union
            chosen = None
            for pv in cand:
                if pv.name not in unsafe:
                    chosen = pv
                    break
            if chosen is None and not dyn and cand:
                chosen = cand[0]
            if chosen is not None:
                self.claimed_static.add(chosen.name)
                claims.append(chosen.name)
        if claims:
            self.pod_claims[id(pod)] = claims

    def remove(self, node_idx: int, pod: Pod) -> None:
        for r, v in pod.resource_requests().items():
            self.requested[node_idx][r] = self.requested[node_idx].get(r, 0.0) - v
        self.pods_on_node[node_idx].remove(pod)
        self._version += 1
        self._bootstrap.clear()
        for name in self.pod_claims.pop(id(pod), ()):
            self.claimed_static.discard(name)

    def any_pod_matches(self, term: PodAffinityTerm, own_ns: str) -> bool:
        key = (self._version, id(term), own_ns)
        hit = self._bootstrap.get(key)
        if hit is None:
            hit = any(
                _term_matches_pod(term, own_ns, other)
                for pods in self.pods_on_node
                for other in pods
            )
            self._bootstrap[key] = hit
        return hit

    def free(self, node_idx: int) -> dict[str, float]:
        alloc = self.nodes[node_idx].status.allocatable
        return {
            r: alloc.get(r, 0.0) - self.requested[node_idx].get(r, 0.0)
            for r in set(alloc) | set(self.requested[node_idx])
        }


# --------------------------------------------------------------------------
# Filter plugins (feasibility predicates)
# --------------------------------------------------------------------------


def filter_node_resources_fit(pod: Pod, state: OracleState, i: int) -> bool:
    alloc = state.nodes[i].status.allocatable
    used = state.requested[i]
    for r, v in pod.resource_requests().items():
        if used.get(r, 0.0) + v > alloc.get(r, 0.0) * (1 + 1e-5) + 1e-5:
            return False
    return True


def filter_node_name(pod: Pod, state: OracleState, i: int) -> bool:
    return not pod.spec.node_name or pod.spec.node_name == state.nodes[i].name


def filter_node_unschedulable(pod: Pod, state: OracleState, i: int) -> bool:
    return not state.nodes[i].spec.unschedulable


def filter_node_affinity(pod: Pod, state: OracleState, i: int) -> bool:
    node = state.nodes[i]
    labels = _node_labels(node)
    for k, v in pod.spec.node_selector.items():
        if labels.get(k) != v:
            return False
    aff = pod.spec.affinity
    if aff and aff.node_affinity and aff.node_affinity.required:
        if not any(_match_term(node, t) for t in aff.node_affinity.required):
            return False
    return True


def filter_taint_toleration(pod: Pod, state: OracleState, i: int) -> bool:
    for taint in state.nodes[i].spec.taints:
        if taint.effect in (api.NO_SCHEDULE, api.NO_EXECUTE) and not tolerates(pod, taint):
            return False
    return True


def filter_node_ports(pod: Pod, state: OracleState, i: int) -> bool:
    wanted = {(p, proto) for (p, proto, _ip) in pod.host_ports()}
    if not wanted:
        return True
    used = set()
    for other in state.pods_on_node[i]:
        for (p, proto, _ip) in other.host_ports():
            used.add((p, proto))
    return not (wanted & used)


def _domain(node: Node, topology_key: str) -> str | None:
    return _node_labels(node).get(topology_key)


def _term_matches_pod(term: PodAffinityTerm, own_ns: str, other: Pod) -> bool:
    namespaces = term.namespaces or (own_ns,)
    if other.namespace not in namespaces:
        return False
    return match_label_selector(term.label_selector, other.metadata.labels)


def filter_inter_pod_affinity(pod: Pod, state: OracleState, i: int) -> bool:
    node = state.nodes[i]
    aff = pod.spec.affinity or Affinity()
    # required pod affinity: each term needs >=1 matching pod in the domain
    if aff.pod_affinity:
        for term in aff.pod_affinity.required:
            # upstream bootstrap rule: when NO pod anywhere matches the
            # selector and the incoming pod matches its own selector, the
            # term is ignored (lets the first pod of a self-affine group in)
            if not state.any_pod_matches(term, pod.namespace) and _term_matches_pod(
                term, pod.namespace, pod
            ):
                continue
            dom = _domain(node, term.topology_key)
            if dom is None:
                return False
            found = False
            for j, nd in enumerate(state.nodes):
                if _domain(nd, term.topology_key) != dom:
                    continue
                for other in state.pods_on_node[j]:
                    if _term_matches_pod(term, pod.namespace, other):
                        found = True
                        break
                if found:
                    break
            if not found:
                return False
    # required anti-affinity: no matching pod in the domain
    if aff.pod_anti_affinity:
        for term in aff.pod_anti_affinity.required:
            dom = _domain(node, term.topology_key)
            if dom is None:
                continue  # upstream: absent key -> term can't be violated
            for j, nd in enumerate(state.nodes):
                if _domain(nd, term.topology_key) != dom:
                    continue
                for other in state.pods_on_node[j]:
                    if _term_matches_pod(term, pod.namespace, other):
                        return False
    # symmetry: existing pods' required anti-affinity must not be violated
    for j, nd in enumerate(state.nodes):
        for other in state.pods_on_node[j]:
            oa = other.spec.affinity
            if not oa or not oa.pod_anti_affinity:
                continue
            for term in oa.pod_anti_affinity.required:
                dom_other = _domain(nd, term.topology_key)
                dom_new = _domain(node, term.topology_key)
                if dom_other is None or dom_new != dom_other:
                    continue
                if _term_matches_pod(term, other.namespace, pod):
                    return False
    return True


def _pv_usable(state: OracleState, pv, pvc, node) -> bool:
    """ONE eligibility rule shared by the VolumeBinding filter (any-fit)
    and the claim step (first-fit over pv_list): available, unclaimed
    (pre-cycle AND in-cycle), big enough, admissible on the node."""
    if (
        pv.claim_ref
        or pv.name in state.claimed_pv_names
        or pv.name in state.claimed_static
    ):
        return False
    if pv.capacity + 1e-3 < pvc.request:
        return False
    if pv.node_affinity and not any(
        _match_term(node, t) for t in pv.node_affinity
    ):
        return False
    return True


def filter_volume_binding(pod: Pod, state: OracleState, i: int) -> bool:
    """Mirror of ops/volumes.py: bound-PV node affinity; unbound
    WaitForFirstConsumer claims need a static candidate PV or dynamic
    provisioning whose allowedTopologies admit the node; missing PVCs and
    unbound Immediate claims are unschedulable."""
    if not pod.spec.volumes:
        return True
    node = state.nodes[i]
    static_required: list[set] = []
    for claim in pod.spec.volumes:
        pvc = state.pvcs.get(f"{pod.namespace}/{claim}")
        if pvc is None:
            return False
        if pvc.volume_name:
            pv = state.pvs.get(pvc.volume_name)
            if pv is None:
                return False
            if pv.node_affinity and not any(
                _match_term(node, t) for t in pv.node_affinity
            ):
                return False
            continue
        cls = state.storage_classes.get(pvc.storage_class)
        if cls is None or cls.volume_binding_mode != api.VOLUME_BINDING_WAIT:
            return False
        cand = {
            pv.name
            for pv in state.pvs_by_class.get(pvc.storage_class, ())
            if _pv_usable(state, pv, pvc, node)
        }
        dyn = bool(cls.provisioner) and (
            not cls.allowed_topologies
            or any(_match_term(node, t) for t in cls.allowed_topologies)
        )
        if not cand and not dyn:
            return False
        if not dyn:
            static_required.append(cand)
    # Hall's condition across the pod's static-required slots (PARITY #8
    # closure, mirrors ops/volumes._hall_ok): DISTINCT PVs must exist —
    # a pod whose two PVCs are satisfiable only by one PV is infeasible
    if len(static_required) >= 2:
        import itertools

        for r in range(2, len(static_required) + 1):
            for s in itertools.combinations(static_required, r):
                if len(set().union(*s)) < r:
                    return False
    return True


def filter_topology_spread(pod: Pod, state: OracleState, i: int) -> bool:
    node = state.nodes[i]
    for c in pod.spec.topology_spread_constraints:
        if c.when_unsatisfiable != api.DO_NOT_SCHEDULE:
            continue
        dom = _domain(node, c.topology_key)
        if dom is None:
            return False
        counts: dict[str, int] = {}
        for j, nd in enumerate(state.nodes):
            d = _domain(nd, c.topology_key)
            if d is None:
                continue
            counts.setdefault(d, 0)
            for other in state.pods_on_node[j]:
                if other.namespace == pod.namespace and match_label_selector(
                    c.label_selector, other.metadata.labels
                ):
                    counts[d] += 1
        if not counts:
            continue
        min_count = min(counts.values())
        if counts.get(dom, 0) + 1 - min_count > c.max_skew:
            return False
    return True


DEFAULT_FILTERS = (
    filter_node_unschedulable,
    filter_node_name,
    filter_taint_toleration,
    filter_node_affinity,
    filter_node_ports,
    filter_node_resources_fit,
    filter_volume_binding,
    filter_inter_pod_affinity,
    filter_topology_spread,
)

# Plugin names aligned 1:1 with DEFAULT_FILTERS, imported from the ONE
# inventory of record (config/types._DEFAULT_FILTERS — the framework's
# Filter execution order and therefore the column order of the kernels'
# reject-count tables). The trace-level differential (fuzz/) compares
# unschedulable REASONS tuples, so this alignment is load-bearing: a
# second hand-written copy here would drift the moment the plugin list
# changes and read as a phantom engine divergence.
FILTER_PLUGIN_NAMES = tuple(_FILTER_ORDER)

# name lookup for REASONS labeling: keyed by the filter FUNCTION so a
# caller passing a custom `filters` subset gets each filter's own name
# (zip against the full inventory would silently shift labels), and an
# unknown custom filter fails loudly with a KeyError
_FILTER_NAME_OF = dict(zip(DEFAULT_FILTERS, FILTER_PLUGIN_NAMES))
assert len(_FILTER_NAME_OF) == len(FILTER_PLUGIN_NAMES) == len(
    DEFAULT_FILTERS
), "oracle filters and config/types._DEFAULT_FILTERS drifted"


# Filters whose kernel plugin implements a STATIC mask
# (framework/plugins.py): the node-only predicates, NodePorts (existing
# pods' ports are stable-side), and VolumeBinding (pre-cycle
# availability). NodeResourcesFit, InterPodAffinity and
# PodTopologySpread define ONLY dyn_mask — their whole constraint
# (existing pods included) evaluates in the dynamic phase, so the
# attribution mirror must not let them first-reject a node statically.
_STATIC_PART_FILTERS = frozenset({
    filter_node_unschedulable,
    filter_node_name,
    filter_taint_toleration,
    filter_node_affinity,
    filter_node_ports,
    filter_volume_binding,
})


def attribute_rejects(
    pod: Pod,
    pre_state: OracleState,
    dyn_state: OracleState,
    filters=DEFAULT_FILTERS,
) -> list[int]:
    """First-rejector counts per filter, mirroring the kernels'
    attribution structure (framework.runtime.Framework.static + dyn):
    TWO phases per node, matching each plugin's static/dynamic split
    in framework/plugins.py:

    1. first filter WITH A STATIC PART (`_STATIC_PART_FILTERS`) whose
       check fails against `pre_state` — the static-table attribution;
       wholly-dynamic plugins (resources fit, inter-pod affinity,
       topology spread) are skipped here even when the pre-state alone
       would reject, because the kernel evaluates their entire
       constraint as a dynamic mask;
    2. for statically-feasible nodes only, first filter in full order
       whose check fails against `dyn_state` — the state the engine's
       dynamic masks actually saw: the pod's OWN scan step for the
       fused scan program (greedy_commit evaluates dyn_fn at the pod's
       turn, with earlier placements INCLUDING later-gang-unwound
       ones), the final post-cycle state for the rounds/diagnosis
       programs. Static-only predicates can never newly fail here, and
       a ports/volume conflict with EXISTING pods was already taken in
       phase 1, so running the full combined checks reproduces the
       kernel's per-plugin dyn increments.
    """
    counts = [0] * len(filters)
    for i in range(len(pre_state.nodes)):
        statically_rejected = False
        for fi, f in enumerate(filters):
            if f not in _STATIC_PART_FILTERS:
                continue
            if not f(pod, pre_state, i):
                counts[fi] += 1
                statically_rejected = True
                break
        if statically_rejected:
            continue
        for fi, f in enumerate(filters):
            if not f(pod, dyn_state, i):
                counts[fi] += 1
                break
    return counts


# --------------------------------------------------------------------------
# Score plugins
# --------------------------------------------------------------------------


def _score_fracs(pod: Pod, state: OracleState, i: int,
                 resources: Sequence[str]) -> list[float]:
    alloc = state.nodes[i].status.allocatable
    req = pod.resource_requests()
    fracs = []
    for r in resources:
        a = alloc.get(r, 0.0)
        after = state.requested[i].get(r, 0.0) + req.get(r, 0.0)
        fracs.append(min(max(after / a, 0.0), 1.0) if a > 0 else 1.0)
    return fracs


def score_least_requested(pod: Pod, state: OracleState, i: int,
                          resources: Sequence[str] = ("cpu", "memory")) -> float:
    fracs = _score_fracs(pod, state, i, resources)
    return sum((1.0 - f) * MAX_NODE_SCORE for f in fracs) / len(fracs)


def score_balanced_allocation(pod: Pod, state: OracleState, i: int,
                              resources: Sequence[str] = ("cpu", "memory")) -> float:
    fracs = _score_fracs(pod, state, i, resources)
    mean = sum(fracs) / len(fracs)
    var = sum((f - mean) ** 2 for f in fracs) / len(fracs)
    return (1.0 - math.sqrt(var)) * MAX_NODE_SCORE


def score_node_affinity(pod: Pod, state: OracleState, i: int) -> float:
    aff = pod.spec.affinity
    if not aff or not aff.node_affinity or not aff.node_affinity.preferred:
        return 0.0
    total = sum(p.weight for p in aff.node_affinity.preferred)
    if total <= 0:
        return 0.0
    got = sum(
        p.weight
        for p in aff.node_affinity.preferred
        if _match_term(state.nodes[i], p.preference)
    )
    return got / total * MAX_NODE_SCORE


def _untolerated_prefer_count(pod: Pod, state: OracleState, i: int) -> int:
    return sum(
        1
        for t in state.nodes[i].spec.taints
        if t.effect == api.PREFER_NO_SCHEDULE and not tolerates(pod, t)
    )


def score_taint_toleration(pod: Pod, state: OracleState, i: int) -> float:
    """Fewer untolerated PreferNoSchedule taints -> higher score, normalized
    by the max count over ALL nodes (DefaultNormalizeScore(reverse=true)
    analogue; same documented deviation as ops/taints.py: the max is over
    all nodes, not just feasible ones). The per-pod max is memoized on the
    state (taints don't change during a run)."""
    mx = state._taint_max.get(pod.uid)
    if mx is None:
        mx = max(
            (_untolerated_prefer_count(pod, state, j) for j in range(len(state.nodes))),
            default=0,
        )
        state._taint_max[pod.uid] = mx
    if mx == 0:
        return MAX_NODE_SCORE
    return (1.0 - _untolerated_prefer_count(pod, state, i) / mx) * MAX_NODE_SCORE


def _spread(state: OracleState, name: str) -> float:
    """Fraction of nodes holding an image; memoized (images are static)."""
    s = state._image_spread.get(name)
    if s is None:
        n = sum(
            1
            for nd in state.nodes
            if any(name in im.names for im in nd.status.images)
        )
        s = n / max(len(state.nodes), 1)
        state._image_spread[name] = s
    return s


def score_image_locality(pod: Pod, state: OracleState, i: int) -> float:
    images = {}
    for img in state.nodes[i].status.images:
        for nm in img.names:
            images[nm] = img.size_bytes
    # image size scaled by spread (upstream scaledImageScore), then the
    # 23MB..1GB ramp (upstream calculatePriority thresholds)
    have = sum(
        images.get(im, 0) * _spread(state, im) for im in pod.images() if im in images
    )
    lo, hi = 23 * 2**20, 2**30
    clipped = min(max(have, lo), hi)
    return (clipped - lo) / (hi - lo) * MAX_NODE_SCORE


def score_inter_pod_affinity(pod: Pod, state: OracleState, i: int) -> float:
    """Preferred affinity/anti-affinity terms, both directions (incoming
    pod's preferences against existing pods, and existing pods' preferences
    against the incoming pod). Raw weighted sum; normalized by caller."""
    node = state.nodes[i]
    score = 0.0
    aff = pod.spec.affinity or Affinity()
    prefs = []
    if aff.pod_affinity:
        prefs += [(w.weight, w.term) for w in aff.pod_affinity.preferred]
    if aff.pod_anti_affinity:
        prefs += [(-w.weight, w.term) for w in aff.pod_anti_affinity.preferred]
    for weight, term in prefs:
        dom = _domain(node, term.topology_key)
        if dom is None:
            continue
        for j, nd in enumerate(state.nodes):
            if _domain(nd, term.topology_key) != dom:
                continue
            for other in state.pods_on_node[j]:
                if _term_matches_pod(term, pod.namespace, other):
                    score += weight
    # symmetric: existing pods' preferred terms matching the incoming pod
    for j, nd in enumerate(state.nodes):
        for other in state.pods_on_node[j]:
            oa = other.spec.affinity or Affinity()
            oprefs = []
            if oa.pod_affinity:
                oprefs += [(w.weight, w.term) for w in oa.pod_affinity.preferred]
            if oa.pod_anti_affinity:
                oprefs += [(-w.weight, w.term) for w in oa.pod_anti_affinity.preferred]
            for weight, term in oprefs:
                dom_other = _domain(nd, term.topology_key)
                if dom_other is None or _domain(node, term.topology_key) != dom_other:
                    continue
                if _term_matches_pod(term, other.namespace, pod):
                    score += weight
    return score


def _spread_domain_counts(pod: Pod, state: OracleState,
                          c: api.TopologySpreadConstraint) -> dict[str, float]:
    """Matching-pod count per domain for one constraint — computed ONCE per
    (pod, constraint) instead of rescanning all nodes per candidate node."""
    counts: dict[str, float] = {}
    for j, nd in enumerate(state.nodes):
        d = _domain(nd, c.topology_key)
        if d is None:
            continue
        counts.setdefault(d, 0.0)
        for other in state.pods_on_node[j]:
            if other.namespace == pod.namespace and match_label_selector(
                c.label_selector, other.metadata.labels
            ):
                counts[d] += 1.0
    return counts


def score_topology_spread_raw(pod: Pod, state: OracleState, i: int,
                              _counts=None) -> float:
    """ScheduleAnyway constraints: matching-pod count in the node's domain
    (summed over constraints); the caller reverse-normalizes over feasible
    nodes — identical to ops/interpod.spread_dyn_score. `_counts` is the
    precomputed per-constraint domain-count list (see _spread_domain_counts);
    omitted, it is computed here."""
    node = state.nodes[i]
    constraints = [c for c in pod.spec.topology_spread_constraints
                   if c.when_unsatisfiable == api.SCHEDULE_ANYWAY]
    if _counts is None:
        _counts = [_spread_domain_counts(pod, state, c) for c in constraints]
    raw = 0.0
    for c, counts in zip(constraints, _counts):
        dom = _domain(node, c.topology_key)
        if dom is not None:
            raw += counts.get(dom, 0.0)
    return raw


# --------------------------------------------------------------------------
# The sequential scheduler
# --------------------------------------------------------------------------


@dataclasses.dataclass
class OracleDecision:
    pod: Pod
    node_index: int  # -1 = unschedulable


@dataclasses.dataclass(frozen=True)
class OracleWeights:
    """Defaults mirror the default-plugin score weights in config/types.py
    (TaintToleration 3, others 1; InterPodAffinity joins when its kernel
    lands so both sides stay in lockstep)."""

    least_requested: float = 1.0
    balanced_allocation: float = 1.0
    node_affinity: float = 1.0
    taint_toleration: float = 3.0
    image_locality: float = 1.0
    inter_pod_affinity: float = 1.0
    topology_spread: float = 2.0


def queue_order(pending: Sequence[Pod]) -> list[int]:
    """The queue's pop order: priority desc, creation asc, index (the
    PrioritySort QueueSort plugin; same key as the encoder's pod_order)."""
    return sorted(
        range(len(pending)),
        key=lambda i: (-pending[i].spec.priority,
                       pending[i].metadata.creation_timestamp, i),
    )


def feasible_nodes(pod: Pod, state: OracleState, filters) -> list[int]:
    """Filter pass + nominated-node narrowing (upstream evaluates the
    nominated node first and keeps it when it passes filters)."""
    feasible = [
        i for i in range(len(state.nodes))
        if all(f(pod, state, i) for f in filters)
    ]
    if pod.nominated_node_name:
        for i in feasible:
            if state.nodes[i].name == pod.nominated_node_name:
                return [i]
    return feasible


@dataclasses.dataclass
class _CrossNodeRaws:
    """Raw scores needing cross-node normalization over the feasible set
    (upstream NormalizeScore runs after Filter)."""

    ipa: dict
    ipa_hi: float
    spread: dict
    spread_hi: float

    @staticmethod
    def compute(pod: Pod, state: OracleState, feasible: list[int],
                weights: "OracleWeights") -> "_CrossNodeRaws":
        ipa, spread = {}, {}
        if weights.inter_pod_affinity:
            ipa = {i: score_inter_pod_affinity(pod, state, i) for i in feasible}
        if weights.topology_spread and pod.spec.topology_spread_constraints:
            constraints = [c for c in pod.spec.topology_spread_constraints
                           if c.when_unsatisfiable == api.SCHEDULE_ANYWAY]
            counts = [_spread_domain_counts(pod, state, c) for c in constraints]
            spread = {
                i: score_topology_spread_raw(pod, state, i, counts)
                for i in feasible
            }
        return _CrossNodeRaws(
            ipa, max(map(abs, ipa.values()), default=0.0),
            spread, max(spread.values(), default=0.0),
        )


def _score_pod(pod: Pod, state: OracleState, i: int, weights: OracleWeights,
               cn: "_CrossNodeRaws | None" = None) -> float:
    s = (
        weights.least_requested * score_least_requested(pod, state, i)
        + weights.balanced_allocation * score_balanced_allocation(pod, state, i)
        + weights.node_affinity * score_node_affinity(pod, state, i)
        + weights.taint_toleration * score_taint_toleration(pod, state, i)
        + weights.image_locality * score_image_locality(pod, state, i)
    )
    if cn is not None:
        if weights.inter_pod_affinity and cn.ipa_hi > 0:
            s += weights.inter_pod_affinity * (cn.ipa[i] / cn.ipa_hi) * MAX_NODE_SCORE
        if weights.topology_spread and pod.spec.topology_spread_constraints:
            if cn.spread_hi > 0:
                s += weights.topology_spread * (
                    1.0 - cn.spread[i] / cn.spread_hi
                ) * MAX_NODE_SCORE
            else:
                s += weights.topology_spread * MAX_NODE_SCORE
    return s


def validate_assignment(
    nodes: Sequence[Node],
    pending: Sequence[Pod],
    assignment: Sequence[int],
    existing: Sequence[tuple[Pod, str]] = (),
    weights: OracleWeights = OracleWeights(),
    filters=DEFAULT_FILTERS,
    tol: float = 0.05,
) -> list[str]:
    """Semantic differential check that is robust to f32-vs-f64 score ties.

    Replays the kernel's assignment through the oracle's sequential state:
    each chosen node must be oracle-feasible at that point and its oracle
    score within `tol` of the oracle's best feasible score (the batched
    kernel computes scores in float32, so two nodes whose f64 scores differ
    by ~1e-4 are legitimately interchangeable); -1 requires that NO node be
    feasible. Returns a list of human-readable violations (empty = valid)."""
    state = OracleState.build(nodes, existing)
    errors = []
    for pi in queue_order(pending):
        pod = pending[pi]
        node = assignment[pi]
        feasible = feasible_nodes(pod, state, filters)
        if node < 0:
            if feasible:
                errors.append(
                    f"{pod.name}: kernel says unschedulable but oracle finds "
                    f"feasible nodes {feasible}"
                )
            continue
        if node not in feasible:
            errors.append(f"{pod.name}: node {node} infeasible per oracle "
                          f"(feasible: {feasible})")
            continue
        cn = _CrossNodeRaws.compute(pod, state, feasible, weights)
        scores = {i: _score_pod(pod, state, i, weights, cn) for i in feasible}
        best = max(scores.values())
        if scores[node] < best - tol:
            errors.append(
                f"{pod.name}: node {node} scores {scores[node]:.4f}, "
                f"{best - scores[node]:.4f} below best {best:.4f}"
            )
        state.add(node, pod)
    return errors


def validate_rounds_assignment(
    nodes: Sequence[Node],
    pending: Sequence[Pod],
    assignment: Sequence[int],
    existing: Sequence[tuple[Pod, str]] = (),
    round_cap_hit: bool = False,
    allow_feasible_unplaced: Sequence[int] = (),
    pvcs: Sequence = (),
    pvs: Sequence = (),
    storage_classes: Sequence = (),
) -> list[str]:
    """Validity invariants for the round-based commit (ops/rounds.py).

    Unlike `validate_assignment` (which replays strict sequential
    semantics), this checks the FINAL state: with every placement applied,
    each placed pod's hard constraints must hold —
      - static filters (unschedulable/name/taints/node-affinity) exactly;
      - per-node capacity and hostPort uniqueness as aggregates;
      - required anti-affinity strictly (no other matching pod in any of
        the pod's anti domains), in both directions;
      - required affinity with the bootstrap allowance (a pod matching its
        own selector may stand alone);
      - DoNotSchedule spread as final skew <= maxSkew.
    Unplaced pods must be infeasible against the final state, unless the
    round cap was hit or they are listed in `allow_feasible_unplaced`
    (gang-dropped pods). Returns human-readable violations."""
    final = OracleState.build(nodes, existing, pvcs, pvs, storage_classes)
    placed: list[tuple[Pod, int]] = []
    # placed pods enter in QUEUE ORDER so their static-PV claims fold
    # rank-ordered (the shared binder-choice rule); unplaced-but-feasible
    # checks below then see the claimed bitmap
    for pi in queue_order(pending):
        node = assignment[pi]
        if node >= 0:
            final.add(node, pending[pi])
            placed.append((pending[pi], node))

    errors: list[str] = []
    # per-node aggregates: capacity + hostPort uniqueness
    for i, nd in enumerate(final.nodes):
        alloc = nd.status.allocatable
        for r, v in final.requested[i].items():
            if v > alloc.get(r, 0.0) * (1 + 1e-5) + 1e-5:
                errors.append(
                    f"node {nd.name}: {r} over capacity ({v} > "
                    f"{alloc.get(r, 0.0)})"
                )
        seen_ports: set = set()
        for pod in final.pods_on_node[i]:
            for (p, proto, _ip) in pod.host_ports():
                if (p, proto) in seen_ports:
                    errors.append(
                        f"node {nd.name}: duplicate hostPort {p}/{proto}"
                    )
                seen_ports.add((p, proto))

    for pod, i in placed:
        node = final.nodes[i]
        for f in (filter_node_unschedulable, filter_node_name,
                  filter_taint_toleration, filter_node_affinity):
            if not f(pod, final, i):
                errors.append(f"{pod.name}: fails {f.__name__} on {node.name}")
        aff = pod.spec.affinity or Affinity()
        if aff.pod_anti_affinity:
            for term in aff.pod_anti_affinity.required:
                dom = _domain(node, term.topology_key)
                if dom is None:
                    continue
                for j, nd in enumerate(final.nodes):
                    if _domain(nd, term.topology_key) != dom:
                        continue
                    for other in final.pods_on_node[j]:
                        if other is pod:
                            continue
                        if _term_matches_pod(term, pod.namespace, other):
                            errors.append(
                                f"{pod.name}: anti-affinity violated by "
                                f"{other.name} in {term.topology_key}={dom}"
                            )
        if aff.pod_affinity:
            for term in aff.pod_affinity.required:
                if _term_matches_pod(term, pod.namespace, pod):
                    continue  # bootstrap allowance / self-satisfying
                dom = _domain(node, term.topology_key)
                if dom is None:
                    errors.append(
                        f"{pod.name}: affinity key {term.topology_key} "
                        f"absent on {node.name}"
                    )
                    continue
                found = False
                for j, nd in enumerate(final.nodes):
                    if _domain(nd, term.topology_key) != dom:
                        continue
                    for other in final.pods_on_node[j]:
                        if other is not pod and _term_matches_pod(
                            term, pod.namespace, other
                        ):
                            found = True
                            break
                    if found:
                        break
                if not found:
                    errors.append(
                        f"{pod.name}: affinity unsatisfied in "
                        f"{term.topology_key}={dom}"
                    )
        for c in pod.spec.topology_spread_constraints:
            if c.when_unsatisfiable != api.DO_NOT_SCHEDULE:
                continue
            # the skew bound holds at the CONSTRAINED pod's placement time
            # only (upstream semantics): matching pods that carry no
            # constraint of their own may legally raise the final skew
            # afterwards, so the final state can only verify key presence.
            # test_rounds_spread_do_not_schedule_skew_holds covers the
            # all-carriers case, where final skew <= maxSkew is implied.
            if _domain(node, c.topology_key) is None:
                errors.append(
                    f"{pod.name}: spread key {c.topology_key} absent on "
                    f"{node.name}"
                )

    if not round_cap_hit:
        allowed = set(allow_feasible_unplaced)
        for pi, pod in enumerate(pending):
            if assignment[pi] >= 0 or pi in allowed:
                continue
            feas = feasible_nodes(pod, final, DEFAULT_FILTERS)
            if feas:
                errors.append(
                    f"{pod.name}: unplaced but feasible on {feas[:5]} "
                    f"in the final state"
                )
    return errors


# --------------------------------------------------------------------------
# Preemption (DefaultPreemption PostFilter analogue)
# --------------------------------------------------------------------------

# The candidate gate the preemption pass uses — mirrors the kernel's
# Candidate-node gate: the static filters eviction can never satisfy
# (volumes included — evicting a pod does not unbind a PersistentVolume).
# Everything eviction CAN free — resources, hostPorts, inter-pod
# (anti-)affinity, DoNotSchedule spread — is checked per victim PREFIX by
# simulating the prefix's removal from the post-cycle state, mirroring
# upstream's re-run-Filters-with-victims-removed and ops/preemption.py's
# what-if kernel.
PREEMPTION_STATIC_FILTERS = (
    filter_node_unschedulable,
    filter_node_name,
    filter_taint_toleration,
    filter_node_affinity,
    filter_volume_binding,
)
# constraints re-checked with the victim prefix removed
PREEMPTION_WHATIF_FILTERS = (
    filter_node_ports,
    filter_inter_pod_affinity,
    filter_topology_spread,
)


@dataclasses.dataclass
class OraclePreemption:
    pod_index: int
    node_index: int
    victims: list[int]  # indices into the `existing` sequence


def schedule_with_gangs(
    nodes: Sequence[Node],
    pending: Sequence[Pod],
    existing: Sequence[tuple[Pod, str]] = (),
    pod_groups: Sequence[api.PodGroup] = (),
    weights: "OracleWeights | None" = None,
    filters=None,
    pvcs: Sequence = (),
    pvs: Sequence = (),
    storage_classes: Sequence = (),
) -> tuple[list[OracleDecision], list[int]]:
    """schedule() then the all-or-nothing gang unwind (Coscheduling
    analogue, core/cycle.py gang_scheduling): groups whose placed-member
    count is below minMember have all members rolled back. Returns
    (decisions, dropped pod indices)."""
    weights = weights or OracleWeights()
    filters = filters or DEFAULT_FILTERS
    decisions = schedule(
        nodes, pending, existing, weights, filters, pvcs, pvs,
        storage_classes,
    )
    return gang_unwind(decisions, existing, pod_groups)


def gang_unwind(
    decisions: "list[OracleDecision]",
    existing: Sequence[tuple[Pod, str]],
    pod_groups: Sequence[api.PodGroup],
) -> tuple[list[OracleDecision], list[int]]:
    """The all-or-nothing rollback on its own: groups whose placed
    count (plus already-running members) stays below minMember have
    every placement unwound. Factored out of schedule_with_gangs so
    trace replay can keep the PRE-unwind decisions (the scan's turn
    states saw unwound pods as placed). Returns a NEW decisions list
    plus the dropped indices; the input list is not mutated."""
    decisions = list(decisions)
    min_member = {g.name: g.min_member for g in pod_groups}
    placed_count: dict[str, int] = {}
    for p, _node in existing:  # running members count toward minMember
        g = p.spec.pod_group
        if g:
            placed_count[g] = placed_count.get(g, 0) + 1
    for d in decisions:
        g = d.pod.spec.pod_group
        if g and d.node_index >= 0:
            placed_count[g] = placed_count.get(g, 0) + 1
    dropped = []
    for pi, d in enumerate(decisions):
        g = d.pod.spec.pod_group
        if g and d.node_index >= 0 and placed_count.get(g, 0) < min_member.get(g, 0):
            decisions[pi] = OracleDecision(d.pod, -1)
            dropped.append(pi)
    return decisions, dropped


def schedule_with_preemption(
    nodes: Sequence[Node],
    pending: Sequence[Pod],
    existing: Sequence[tuple[Pod, str]] = (),
    weights: "OracleWeights | None" = None,
    filters=None,
    pdbs: Sequence = (),
    pvcs: Sequence = (),
    pvs: Sequence = (),
    storage_classes: Sequence = (),
    budget: int | None = None,
    scan_budget: int | None = None,
) -> tuple[list[OracleDecision], list["OraclePreemption"]]:
    """schedule() then the preemption pass on whatever stayed pending."""
    weights = weights or OracleWeights()
    filters = filters or DEFAULT_FILTERS
    decisions = schedule(
        nodes, pending, existing, weights, filters, pvcs, pvs,
        storage_classes,
    )
    post_state = OracleState.build(
        nodes, existing, pvcs, pvs, storage_classes
    )
    for d in decisions:
        if d.node_index >= 0:
            post_state.add(d.node_index, d.pod)
    return decisions, preempt(
        nodes, pending, existing, decisions, post_state, pdbs=pdbs,
        pvcs=pvcs, pvs=pvs, storage_classes=storage_classes,
        budget=budget, scan_budget=scan_budget,
    )


def _pdb_selects(pdb, pod: Pod) -> bool:
    if pod.namespace != pdb.namespace:
        return False
    return match_label_selector(pdb.selector, pod.metadata.labels)


def preempt(
    nodes: Sequence[Node],
    pending: Sequence[Pod],
    existing: Sequence[tuple[Pod, str]],
    decisions: Sequence[OracleDecision],
    post_state: OracleState,
    pdbs: Sequence = (),
    pvcs: Sequence = (),
    pvs: Sequence = (),
    storage_classes: Sequence = (),
    budget: int | None = None,
    scan_budget: int | None = None,
    excluded: Sequence[int] = (),
) -> list[OraclePreemption]:
    """Sequential preemption over the unschedulable pods in queue order,
    mirroring ops/preemption.py's semantics: per node, victims are a prefix
    of the existing pods sorted ascending by priority; the minimal prefix
    that frees enough resources wins; a victim protected by an exhausted
    PodDisruptionBudget is evicted only as a LAST RESORT — the number of
    PDB violations among the NEW victims is the FIRST node-choice key
    (upstream pickOneNodeForPreemption criterion #1), and claims decrement
    budgets within the pass; node choice then minimizes (highest victim
    priority, victim priority sum, victim count, -(highest victim start
    time), node index). `post_state` is the oracle state AFTER the
    scheduling pass (committed pods consume capacity); the static filters
    run against the pre-cycle state."""
    idx = {n.name: i for i, n in enumerate(nodes)}
    static_state = OracleState.build(
        nodes, existing, pvcs, pvs, storage_classes
    )
    # PDB bookkeeping: per existing pod, the (first two) selecting PDBs —
    # same MB=2 cap as the encoder
    pdb_used = [0] * len(pdbs)
    pod_pdbs: list[list[int]] = []
    for p, _node in existing:
        sels = [gi for gi, pdb in enumerate(pdbs) if _pdb_selects(pdb, p)]
        pod_pdbs.append(sels[:2])
    # per-node victim lists: (priority asc, -existing_index) — same order as
    # the encoder's node_pods table
    per_node: list[list[int]] = [[] for _ in nodes]
    for e, (p, node_name) in enumerate(existing):
        i = idx.get(node_name)
        if i is not None:
            per_node[i].append(e)
    for lst in per_node:
        lst.sort(key=lambda e: (existing[e][0].spec.priority, -e))

    k_claimed = [0] * len(nodes)
    nominated_req: list[dict[str, float]] = [{} for _ in nodes]
    nominated_ports: list[set] = [set() for _ in nodes]
    out: list[OraclePreemption] = []

    # `excluded` mirrors the kernel's run_preemption(excluded=...) mask:
    # gang-dropped members fit without eviction — their group is what
    # failed — so they never preempt (upstream never runs PostFilter for
    # Permit rejections)
    excluded_set = set(excluded)
    unsched = [pi for pi in queue_order(pending)
               if decisions[pi].node_index < 0
               and pi not in excluded_set
               and pending[pi].spec.preemption_policy != "Never"]
    # ---- per-cycle latency budgets (ops/preemption.py mirror) ----
    # `budget`: only the lowest-rank `budget` candidates are considered
    # at all (phase-1 table bound). `scan_budget`: of those, only the
    # first `scan_budget` that are RESOURCE-FEASIBLE against the
    # pristine post-cycle state (the kernel's phase-1 prefilter — static
    # gate + some prefix k in [1, elig] whose freed resources fit,
    # IGNORING contention and the non-resource what-if) get a scan slot;
    # later candidates defer to the next cycle.
    if budget is not None:
        unsched = unsched[:budget]
    if scan_budget is not None and len(unsched) > scan_budget:
        def _pristine_feasible(pi: int) -> bool:
            pod = pending[pi]
            req = pod.resource_requests()
            for i in range(len(nodes)):
                if not all(
                    f(pod, static_state, i)
                    for f in PREEMPTION_STATIC_FILTERS
                ):
                    continue
                victs = per_node[i]
                elig = sum(
                    1 for e in victs
                    if existing[e][0].spec.priority < pod.spec.priority
                )
                alloc = nodes[i].status.allocatable
                freed: dict[str, float] = {}
                for k in range(1, elig + 1):
                    for r, v in (
                        existing[victs[k - 1]][0].resource_requests().items()
                    ):
                        freed[r] = freed.get(r, 0.0) + v
                    ok = True
                    for r, v in req.items():
                        used = (
                            post_state.requested[i].get(r, 0.0)
                            - freed.get(r, 0.0)
                        )
                        a = alloc.get(r, 0.0)
                        if used + v > a * (1 + 1e-5) + 1e-5:
                            ok = False
                            break
                    if ok:
                        return True
            return False

        unsched = [pi for pi in unsched if _pristine_feasible(pi)][
            :scan_budget
        ]
    for pi in unsched:
        pod = pending[pi]
        req = pod.resource_requests()
        pod_ports = {(pt, proto) for pt, proto, _ip in pod.host_ports()}
        candidates = []  # (pdb_violations, max_prio, sum_prio, n_vict, -hi_start, node, k_min)
        for i in range(len(nodes)):
            if not all(f(pod, static_state, i) for f in PREEMPTION_STATIC_FILTERS):
                continue
            if pod_ports & nominated_ports[i]:
                # an earlier nomination in this pass claims the port
                continue
            victs = per_node[i]
            elig = sum(
                1 for e in victs
                if existing[e][0].spec.priority < pod.spec.priority
            )
            # PDB protection no longer truncates: protected victims are
            # last-resort evictable; violations count toward the node
            # choice below. A victim violates when its within-group
            # ordinal among the NEW victims (from k_claimed on; earlier
            # claims already consumed pdb_used) exceeds the remaining
            # budget — per-victim decrement, like upstream's
            # filterPodsWithPDBViolation (kernel mirror).
            protected = [False] * len(victs)
            grp_cnt: dict[int, int] = {}
            for pos_ in range(k_claimed[i], len(victs)):
                e = victs[pos_]
                flag = False
                for g in pod_pdbs[e]:
                    grp_cnt[g] = grp_cnt.get(g, 0) + 1
                    rem = pdbs[g].disruptions_allowed - pdb_used[g]
                    if grp_cnt[g] > rem:
                        flag = True
                protected[pos_] = flag

            def fits(k: int) -> bool:
                alloc = nodes[i].status.allocatable
                freed: dict[str, float] = {}
                for e in victs[:k]:
                    for r, v in existing[e][0].resource_requests().items():
                        freed[r] = freed.get(r, 0.0) + v
                for r, v in req.items():
                    used = (
                        post_state.requested[i].get(r, 0.0)
                        + nominated_req[i].get(r, 0.0)
                        - freed.get(r, 0.0)
                    )
                    a = alloc.get(r, 0.0)
                    if used + v > a * (1 + 1e-5) + 1e-5:
                        return False
                return True

            def whatif_ok(k: int) -> bool:
                """Re-run the evictable filters with victims[:k] removed
                from the post-cycle state (upstream SelectVictimsOnNode
                re-runs Filters on the modified NodeInfo)."""
                removed = [existing[e][0] for e in victs[:k]]
                for rp in removed:
                    post_state.remove(i, rp)
                try:
                    return all(
                        f(pod, post_state, i)
                        for f in PREEMPTION_WHATIF_FILTERS
                    )
                finally:
                    for rp in removed:
                        # existing pods entered the state with
                        # claim_volumes=False; restoring with the default
                        # True would permanently add claimed_static
                        # entries and pollute later candidates' volume
                        # checks within this pass
                        post_state.add(i, rp, claim_volumes=False)

            k_min = None
            for k in range(k_claimed[i], elig + 1):
                if fits(k) and whatif_ok(k):
                    k_min = k
                    break
            if k_min is None or k_min <= k_claimed[i]:
                continue  # no help, or helps without evictions (not preemption)
            new = victs[k_claimed[i]:k_min]
            hi = victs[k_min - 1]  # highest-priority (last) prefix victim
            candidates.append((
                sum(protected[k_claimed[i]:k_min]),  # PDB violations
                max(existing[e][0].spec.priority for e in new),
                sum(existing[e][0].spec.priority for e in new),
                len(new),
                -existing[hi][0].metadata.creation_timestamp,
                i,
                k_min,
            ))
        if not candidates:
            continue
        _viol, max_p, sum_p, n_v, neg_start, node, k_min = min(candidates)
        victims = per_node[node][k_claimed[node]:k_min]
        k_claimed[node] = k_min
        for e in victims:
            for g in pod_pdbs[e]:
                pdb_used[g] += 1
        for r, v in req.items():
            nominated_req[node][r] = nominated_req[node].get(r, 0.0) + v
        nominated_ports[node] |= pod_ports
        out.append(OraclePreemption(pi, node, victims))
    return out


def schedule(
    nodes: Sequence[Node],
    pending: Sequence[Pod],
    existing: Sequence[tuple[Pod, str]] = (),
    weights: OracleWeights = OracleWeights(),
    filters=DEFAULT_FILTERS,
    pvcs: Sequence = (),
    pvs: Sequence = (),
    storage_classes: Sequence = (),
) -> list[OracleDecision]:
    """Sequential greedy scheduling in (priority desc, creation asc) order —
    the reference's queue order (PrioritySort QueueSort plugin)."""
    state = OracleState.build(nodes, existing, pvcs, pvs, storage_classes)
    decisions: dict[int, int] = {}
    for pi in queue_order(pending):
        pod = pending[pi]
        feasible = feasible_nodes(pod, state, filters)
        if not feasible:
            decisions[pi] = -1
            continue
        best, best_score = -1, -float("inf")
        cn = _CrossNodeRaws.compute(pod, state, feasible, weights)
        for i in feasible:
            s = _score_pod(pod, state, i, weights, cn)
            if s > best_score:
                best, best_score = i, s
        decisions[pi] = best
        if best >= 0:
            state.add(best, pod)
    return [OracleDecision(pending[i], decisions[i]) for i in range(len(pending))]


# --------------------------------------------------------------------------
# Trace semantics (the fuzz/ differential's per-cycle ground truth)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class OracleCycleOutcome:
    """Everything ONE scheduling cycle decides, oracle-side — the unit
    the trace-level differential (fuzz/replay.py) compares against the
    live Scheduler's apply phase:

    - `decisions`: per pending index, the chosen node (-1 = unplaced),
      gang rollbacks applied;
    - `dropped`: pending indices unwound by the all-or-nothing gang
      check (their reasons are ("Coscheduling",));
    - `reasons`: unplaced index -> rejecting plugin names, first-
      rejector attribution against the FINAL post-cycle state (the
      diagnosis-program mirror) — these drive the queueing hints, so
      they must match the engine's bit-exactly for the two queues to
      evolve identically;
    - `preemptions`: nominations + victims for the unplaced pods,
      gang-dropped excluded, under the kernel's production budgets.
    """

    decisions: "list[OracleDecision]"
    dropped: "list[int]"
    reasons: "dict[int, tuple[str, ...]]"
    preemptions: "list[OraclePreemption]"


def schedule_cycle_trace(
    nodes: Sequence[Node],
    pending: Sequence[Pod],
    existing: Sequence[tuple[Pod, str]] = (),
    *,
    pod_groups: Sequence[api.PodGroup] = (),
    pvcs: Sequence = (),
    pvs: Sequence = (),
    storage_classes: Sequence = (),
    pdbs: Sequence = (),
    gang_scheduling: bool = True,
    weights: "OracleWeights | None" = None,
    filters=None,
    budget: "int | None" = None,
    scan_budget: "int | None" = None,
) -> OracleCycleOutcome:
    """One full scheduling cycle under trace semantics: sequential
    greedy scheduling, gang unwind, FailedScheduling attribution, and
    the preemption pass — the oracle half of the fuzz differential.
    Callers that replay multi-cycle traces own the queue/cache state
    between cycles (fuzz/replay.py drives the SAME SchedulingQueue /
    SchedulerCache classes the live Scheduler uses, so the differential
    isolates the decision engine, not the host bookkeeping)."""
    weights = weights or OracleWeights()
    filters = filters or DEFAULT_FILTERS
    raw = schedule(
        nodes, pending, existing, weights, filters, pvcs, pvs,
        storage_classes,
    )
    if gang_scheduling:
        decisions, dropped = gang_unwind(raw, existing, pod_groups)
    else:
        decisions, dropped = list(raw), []
    # FailedScheduling attribution replays the scan: phase B of
    # attribute_rejects must see the state AT THE POD'S TURN — earlier
    # placements only, gang-unwound pods still placed (the fused scan
    # program computes dyn rejects per scan step, before the unwind).
    # `pre` is the pre-cycle (existing-only) state the STATIC half
    # sees; `turn` walks the scan in queue order using the PRE-unwind
    # decisions, claims folding rank-ordered (the shared binder-choice
    # rule).
    pre = OracleState.build(nodes, existing, pvcs, pvs, storage_classes)
    turn = OracleState.build(nodes, existing, pvcs, pvs, storage_classes)
    dropped_set = set(dropped)
    reasons: dict[int, tuple[str, ...]] = {}
    for pi in queue_order(pending):
        if raw[pi].node_index >= 0:
            if pi in dropped_set:
                reasons[pi] = ("Coscheduling",)
            turn.add(raw[pi].node_index, pending[pi])
            continue
        counts = attribute_rejects(pending[pi], pre, turn, filters)
        reasons[pi] = tuple(
            _FILTER_NAME_OF[f]
            for f, c in zip(filters, counts)
            if c > 0
        )
    # the preemption pass consumes the POST-unwind state (the kernel's
    # node_requested is rolled back by _gang_unwind before run_preemption)
    post = OracleState.build(nodes, existing, pvcs, pvs, storage_classes)
    for pi in queue_order(pending):
        if decisions[pi].node_index >= 0:
            post.add(decisions[pi].node_index, pending[pi])
    preemptions = preempt(
        nodes, pending, existing, decisions, post, pdbs=pdbs,
        pvcs=pvcs, pvs=pvs, storage_classes=storage_classes,
        budget=budget, scan_budget=scan_budget, excluded=dropped,
    )
    return OracleCycleOutcome(decisions, dropped, reasons, preemptions)
