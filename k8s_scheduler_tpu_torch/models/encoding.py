"""Snapshot encoding: typed Pod/Node objects -> structure-of-arrays tensors.

The port's counterpart of `k8s_scheduler_tpu/models/encoding.py`: the same
host-side interning in numpy/Python (full-encode path, pure-Python row
builder), and a `ClusterSnapshot` with the same field names, dtypes and
pads whose arrays are torch tensors on a chosen device.

Encoding strategy (as in the reference):

- **Interning.** Every string (label keys/values, taint keys, namespaces,
  image names, topology keys) becomes an int32 id via `StringInterner`.
- **Dedup + gather.** Pod-side structures that repeat across pods (node
  affinity requirements, toleration sets, label selectors, image sets) are
  deduplicated into small tables; each pod stores table indices.
- **Padding.** Every ragged axis is padded to a bucketed size with -1
  sentinels so shapes are stable across cycles.

Not in this slice (ROADMAP A4 and later): volumes and PDBs as encoder
inputs (their snapshot fields are emitted at their empty pads, and a pod
that mounts a PVC raises), and the delta/fold/arena encode paths.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from . import api
from .api import (
    Affinity,
    LabelSelector,
    Node,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    Pod,
    PodAffinityTerm,
)

# Operator codes for the expression table.
OP_IN = 0
OP_NOT_IN = 1
OP_EXISTS = 2
OP_DOES_NOT_EXIST = 3
OP_GT = 4
OP_LT = 5
OP_FIELD_IN = 6  # matchFields metadata.name: values are node indices
OP_IMPOSSIBLE = 7  # never matches (malformed requirement, upstream no-match)

_OP_CODE = {
    api.OP_IN: OP_IN,
    api.OP_NOT_IN: OP_NOT_IN,
    api.OP_EXISTS: OP_EXISTS,
    api.OP_DOES_NOT_EXIST: OP_DOES_NOT_EXIST,
    api.OP_GT: OP_GT,
    api.OP_LT: OP_LT,
}

# Taint effect codes.
EFFECT_NO_SCHEDULE = 0
EFFECT_PREFER_NO_SCHEDULE = 1
EFFECT_NO_EXECUTE = 2
_EFFECT_CODE = {
    api.NO_SCHEDULE: EFFECT_NO_SCHEDULE,
    api.PREFER_NO_SCHEDULE: EFFECT_PREFER_NO_SCHEDULE,
    api.NO_EXECUTE: EFFECT_NO_EXECUTE,
}

TOL_OP_EQUAL = 0
TOL_OP_EXISTS = 1

WHEN_DO_NOT_SCHEDULE = 0
WHEN_SCHEDULE_ANYWAY = 1

NAMESPACE_KEY = "__namespace__"
HOSTNAME_LABEL = "kubernetes.io/hostname"
_EMPTY_I32 = np.empty(0, np.int32)
_EMPTY_F32 = np.empty(0, np.float32)


def _i32(xs) -> np.ndarray:
    return np.array(xs, np.int32) if xs else _EMPTY_I32


def _f32(xs) -> np.ndarray:
    return np.array(xs, np.float32) if xs else _EMPTY_F32


def _scatter_rows(dst: np.ndarray, rows) -> None:
    """dst[i, :len(r)] = r for each row (rows may be shorter than dst)."""
    w = dst.shape[1]
    for i, r in enumerate(rows):
        n = min(len(r), w)
        dst[i, :n] = r[:n]


def _fill_scalars(dst: np.ndarray, values) -> None:
    n = min(len(values), dst.shape[0])
    dst[:n] = values[:n]


class StringInterner:
    """str -> dense int32 id. id 0 is reserved for "" (absent)."""

    def __init__(self) -> None:
        self._ids: dict[str, int] = {"": 0}
        self._strs: list[str] = [""]

    def intern(self, s: str) -> int:
        i = self._ids.get(s)
        if i is None:
            i = len(self._strs)
            self._ids[s] = i
            self._strs.append(s)
        return i

    def __len__(self) -> int:
        return len(self._strs)


class _InternTable:
    """Dedup table: hashable row -> dense index, rows in insertion order."""

    def __init__(self) -> None:
        self.index: dict = {}
        self.rows: list = []

    def intern(self, row) -> int:
        i = self.index.get(row)
        if i is None:
            i = len(self.rows)
            self.index[row] = i
            self.rows.append(row)
        return i

    def __len__(self) -> int:
        return len(self.rows)


def _pad_dim(n: int, bucket: int = 8, minimum: int = 1) -> int:
    """Round up to a bucket multiple so shapes are stable across cycles."""
    n = max(n, minimum)
    return ((n + bucket - 1) // bucket) * bucket


def _pow2_bucket(n: int, minimum: int = 8) -> int:
    """Round up to the next power of two (P/N padding)."""
    n = max(n, minimum)
    return 1 << (n - 1).bit_length()


def _num_or_nan(s: str) -> float:
    try:
        return float(s)
    except ValueError:
        return float("nan")


def priority_rank(priorities: np.ndarray, creation: np.ndarray) -> np.ndarray:
    """PrioritySort queue rank: priority desc, creation asc, index as the
    final deterministic tie-break. i32 [n] rank per pod."""
    n = priorities.shape[0]
    order_key = np.lexsort((np.arange(n), creation[:n], -priorities[:n]))
    out = np.empty(n, np.int32)
    out[order_key] = np.arange(n, dtype=np.int32)
    return out


@dataclass
class ClusterSnapshot:
    """The device-consumable cluster state: the reference's field set, with
    every array a torch tensor on one device.

    Axis glossary: N nodes, P pending pods, E existing pods, R resources,
    Ex label expressions, Rq node-affinity requirement sets, Pf preferred
    node-affinity sets, Tl toleration sets, Ts taint sets, S pod label
    selectors, D flat topology domains, K topology keys, I distinct
    images, Is distinct image sets, G pod groups, MPN max pods per node.
    """

    # --- static aux data ---
    resource_names: tuple[str, ...]
    topology_keys: tuple[str, ...]
    num_distinct_ports: int  # padded Q axis of the port-claim bitmap
    has_inter_pod_affinity: bool
    has_topology_spread: bool
    has_volumes: bool
    has_multi_volume: bool

    # --- real (unpadded) counts: 0-d tensors ---
    num_nodes: torch.Tensor
    num_pending: torch.Tensor
    num_existing: torch.Tensor
    num_domains: torch.Tensor
    cycle_index: torch.Tensor  # rotates the node-sampling windows

    # --- nodes [N...] ---
    node_allocatable: torch.Tensor  # f32 [N, R]
    node_requested: torch.Tensor  # f32 [N, R]
    node_unschedulable: torch.Tensor  # bool [N]
    node_taintset: torch.Tensor  # i32 [N] -> Ts
    node_label_keys: torch.Tensor  # i32 [N, ML]
    node_label_vals: torch.Tensor  # i32 [N, ML]
    node_label_num: torch.Tensor  # f32 [N, ML] (nan if not numeric)
    node_domains: torch.Tensor  # i32 [N, K]
    node_images: torch.Tensor  # bool [N, I]
    node_used_ports: torch.Tensor  # i32 [N, MUP]
    node_valid: torch.Tensor  # bool [N]

    # --- label expression table [Ex...] ---
    ex_key: torch.Tensor  # i32 [Ex]
    ex_op: torch.Tensor  # i32 [Ex]
    ex_vals: torch.Tensor  # i32 [Ex, MV]
    ex_num: torch.Tensor  # f32 [Ex]

    rq_exprs: torch.Tensor  # i32 [Rq, MT, ME]
    pf_exprs: torch.Tensor  # i32 [Pf, MPT, ME]
    pf_weight: torch.Tensor  # f32 [Pf, MPT]

    tl_key: torch.Tensor  # i32 [Tl, MTl]
    tl_op: torch.Tensor
    tl_val: torch.Tensor
    tl_effect: torch.Tensor
    tl_valid: torch.Tensor  # bool [Tl, MTl]
    ts_key: torch.Tensor  # i32 [Ts, MTt]
    ts_val: torch.Tensor
    ts_effect: torch.Tensor
    ts_valid: torch.Tensor  # bool [Ts, MTt]

    sel_exprs: torch.Tensor  # i32 [S, MSE]

    # --- pending pods [P...] ---
    pod_requested: torch.Tensor  # f32 [P, R]
    pod_priority: torch.Tensor  # i32 [P]
    pod_order: torch.Tensor  # i32 [P] queue rank
    pod_node_name: torch.Tensor  # i32 [P] (-1 none, -2 unknown node)
    pod_nominated: torch.Tensor  # i32 [P]
    pod_req_id: torch.Tensor  # i32 [P] -> Rq
    pod_sel_req_id: torch.Tensor  # i32 [P] -> Rq
    pod_pref_id: torch.Tensor  # i32 [P] -> Pf
    pod_tolset: torch.Tensor  # i32 [P] -> Tl
    pod_label_keys: torch.Tensor  # i32 [P, MPL]
    pod_label_vals: torch.Tensor  # i32 [P, MPL]
    pod_ports: torch.Tensor  # i32 [P, MPorts]
    pod_port_ids: torch.Tensor  # i32 [P, MPorts] -> Q
    pod_aff_terms: torch.Tensor  # i32 [P, MA, 2]
    pod_anti_terms: torch.Tensor  # i32 [P, MA, 2]
    pod_pref_aff: torch.Tensor  # i32 [P, MA, 2]
    pod_pref_aff_w: torch.Tensor  # f32 [P, MA]
    pod_tsc: torch.Tensor  # i32 [P, MC, 3]
    pod_tsc_skew: torch.Tensor  # i32 [P, MC]
    pod_group: torch.Tensor  # i32 [P] -> G
    pod_imageset: torch.Tensor  # i32 [P] -> Is
    pod_can_preempt: torch.Tensor  # bool [P]
    pod_valid: torch.Tensor  # bool [P]

    pod_vol_mode: torch.Tensor  # i32 [P, MVol]
    pod_vol_req: torch.Tensor
    pod_vol_class: torch.Tensor
    pod_vol_size: torch.Tensor  # f32 [P, MVol]
    pv_req_id: torch.Tensor  # i32 [V]
    pv_class: torch.Tensor
    pv_capacity: torch.Tensor  # f32 [V]
    pv_avail: torch.Tensor  # bool [V]

    group_min_member: torch.Tensor  # i32 [G]
    group_existing_count: torch.Tensor  # i32 [G]

    imgset_sizes: torch.Tensor  # f32 [Is, I]

    # --- existing pods [E...] ---
    exist_node: torch.Tensor  # i32 [E]
    exist_priority: torch.Tensor
    exist_start: torch.Tensor  # f32 [E]
    exist_pdb: torch.Tensor  # i32 [E, MB]
    exist_requested: torch.Tensor  # f32 [E, R]
    exist_label_keys: torch.Tensor
    exist_label_vals: torch.Tensor
    exist_ports: torch.Tensor  # i32 [E, MEP]
    exist_anti_terms: torch.Tensor  # i32 [E, MA, 2]
    exist_pref_aff: torch.Tensor
    exist_pref_aff_w: torch.Tensor
    exist_valid: torch.Tensor  # bool [E]

    node_pods: torch.Tensor  # i32 [N, MPN]

    domain_key: torch.Tensor  # i32 [D]
    domain_node_count: torch.Tensor  # f32 [D]

    pdb_allowed: torch.Tensor  # i32 [GP]

    has_extender: bool = False

    @property
    def P(self) -> int:
        return self.pod_requested.shape[0]

    @property
    def N(self) -> int:
        return self.node_allocatable.shape[0]

    @property
    def device(self) -> torch.device:
        return self.node_allocatable.device

    def array_fields(self) -> dict[str, torch.Tensor]:
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }


ARRAY_FIELDS = tuple(
    f.name for f in dataclasses.fields(ClusterSnapshot)
    if f.type == "torch.Tensor"
)
AUX_FIELDS = tuple(
    f.name for f in dataclasses.fields(ClusterSnapshot)
    if f.type != "torch.Tensor"
)


def snapshot_from_numpy(
    fields: dict[str, np.ndarray], aux: dict[str, Any], device=None
) -> ClusterSnapshot:
    """Build a snapshot from host arrays: `fields` are the reference
    snapshot's `array_fields()` (or this encoder's), `aux` its non-array
    fields. One tensor per field, copied to `device` with its dtype
    unchanged, so both packages compute on identical inputs."""
    dev = resolve_device(device)
    if aux.get("has_extender"):
        raise NotImplementedError(
            "HTTP-extender verdicts are not ported yet (ROADMAP A10)"
        )
    missing = [n for n in ARRAY_FIELDS if n not in fields]
    if missing:
        raise ValueError(f"snapshot fields missing: {missing}")
    kw = {n: torch.from_numpy(np.array(fields[n], order="C")).to(dev)
          for n in ARRAY_FIELDS}
    kw.update({n: aux[n] for n in AUX_FIELDS if n in aux})
    return ClusterSnapshot(**kw)


class SnapshotEncoder:
    """Builds `ClusterSnapshot`s. Holds the interners and the derived intern
    tables so every id is stable across encodes, and caches per-object
    encoded rows and the stable (node/existing) side like the reference."""

    def __init__(
        self,
        resource_names: Sequence[str] = api.DEFAULT_RESOURCES,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        self.strings = StringInterner()
        self.resource_names = list(resource_names)
        # persistent intern tables (grow-only; ids stable across encodes)
        self._exprs_t = _InternTable()  # rows: (key, op, vals, num)
        self._reqs_t = _InternTable()  # rows: tuple of terms (expr-id tuples)
        self._prefs_t = _InternTable()  # rows: tuple of (exprs, weight)
        self._tols_t = _InternTable()  # rows: sorted (key, op, val, effect)
        self._taints_t = _InternTable()  # rows: sorted (key, val, effect)
        self._sels_t = _InternTable()  # rows: tuple of expr ids
        self._imgsets_t = _InternTable()  # rows: sorted image ids
        self._image_ids: dict[str, int] = {}
        self._image_sizes: dict[int, float] = {}
        self._group_ids: dict[str, int] = {}
        self._topo_keys: list[str] = [HOSTNAME_LABEL]
        self._topo_idx: dict[str, int] = {HOSTNAME_LABEL: 0}
        self._rn_idx: dict[str, int] = {
            n: i for i, n in enumerate(self.resource_names)
        }
        # per-object row caches keyed by id(); the tuple holds a strong
        # reference so a live entry's id can never be reused. Rows baking
        # node INDICES in (matchFields) carry the node epoch.
        self._pod_cache: dict[int, tuple[Any, dict]] = {}
        self._node_cache: dict[int, tuple[Any, dict]] = {}
        self._node_epoch = 0
        self._node_names: tuple[str, ...] = ()
        self._cycle_index = 0  # bumped per encode (sampling rotation)
        # sticky (grow-only) pad dims and capability flags
        self._sticky_dims: dict[str, int] = {}
        self._sticky_flags: dict[str, bool] = {}
        self._stable_key = None
        self._stable: dict = {}

    def _stick(self, key: str, val: int) -> int:
        val = max(val, self._sticky_dims.get(key, 0))
        self._sticky_dims[key] = val
        return val

    def _stick_flag(self, key: str, val: bool) -> bool:
        cur = self._sticky_flags.get(key, False) or bool(val)
        self._sticky_flags[key] = cur
        return cur

    def _resources_vec(self, req: dict[str, float]) -> np.ndarray:
        idx = self._rn_idx
        for name in req:
            if name not in idx:
                idx[name] = len(self.resource_names)
                self.resource_names.append(name)
        v = np.zeros(len(self.resource_names), np.float32)
        for name, val in req.items():
            v[idx[name]] = val
        return v

    def encode(
        self,
        nodes: Sequence[Node],
        pending: Sequence[Pod],
        existing: Sequence[tuple[Pod, str]] = (),
        pod_groups: Sequence[api.PodGroup] = (),
    ) -> ClusterSnapshot:
        """One-shot encode onto the encoder's device. `existing` is
        (pod, node_name) for every pod already assigned."""
        fields, aux = self.encode_numpy(nodes, pending, existing, pod_groups)
        return snapshot_from_numpy(fields, aux, self.device)

    def encode_numpy(
        self,
        nodes: Sequence[Node],
        pending: Sequence[Pod],
        existing: Sequence[tuple[Pod, str]] = (),
        pod_groups: Sequence[api.PodGroup] = (),
    ) -> tuple[dict[str, np.ndarray], dict[str, Any]]:
        """The host half of `encode`: (array fields, aux fields) as numpy."""
        for p in list(pending) + [p for p, _ in existing]:
            if p.spec.volumes:
                raise NotImplementedError(
                    f"pod {p.namespace}/{p.name} mounts PVCs: VolumeBinding "
                    "is not ported yet (ROADMAP A4)"
                )
        S = self.strings
        rn = self.resource_names

        n_real, p_real, e_real = len(nodes), len(pending), len(existing)
        self._cycle_index += 1
        N = _pow2_bucket(n_real)
        P = _pow2_bucket(p_real)
        E = self._stick("E", _pow2_bucket(e_real) if e_real else 8)

        node_index = {nd.name: i for i, nd in enumerate(nodes)}
        names_now = tuple(nd.name for nd in nodes)
        if names_now != self._node_names:
            self._node_names = names_now
            self._node_epoch += 1

        exprs_t = self._exprs_t
        reqs_t = self._reqs_t
        prefs_t = self._prefs_t
        tols_t = self._tols_t
        taints_t = self._taints_t
        sels_t = self._sels_t
        imgsets_t = self._imgsets_t

        def intern_expr(key: int, op: int, vals: tuple[int, ...], num: float) -> int:
            return exprs_t.intern((key, op, vals, num))

        def compile_req(r: NodeSelectorRequirement) -> int:
            op = _OP_CODE[r.operator]
            vals = tuple(sorted(S.intern(v) for v in r.values))
            num = 0.0
            if op in (OP_GT, OP_LT):
                # upstream treats a missing or non-numeric bound as no-match
                try:
                    num = float(r.values[0])
                except (IndexError, ValueError):
                    return intern_expr(0, OP_IMPOSSIBLE, (), 0.0)
                vals = ()
            return intern_expr(S.intern(r.key), op, vals, num)

        def compile_field_req(r: NodeSelectorRequirement) -> int:
            # metadata.name In/NotIn [names] -> node index set (FIELD_IN)
            if r.operator not in (api.OP_IN, api.OP_NOT_IN):
                return intern_expr(0, OP_IMPOSSIBLE, (), 0.0)
            idxs = tuple(
                sorted(node_index[v] for v in r.values if v in node_index)
            )
            if r.operator == api.OP_NOT_IN:
                idxs = tuple(i for i in range(n_real) if i not in set(idxs))
            return intern_expr(0, OP_FIELD_IN, idxs, 0.0)

        def compile_node_affinity_required(terms: Sequence[NodeSelectorTerm]) -> int:
            compiled = []
            for t in terms:
                exprs = [compile_req(e) for e in t.match_expressions]
                exprs += [compile_field_req(e) for e in t.match_fields]
                compiled.append(tuple(exprs))
            if not compiled:
                return -1
            return reqs_t.intern(tuple(compiled))

        def compile_node_affinity_preferred(
            prefs: Sequence[api.PreferredSchedulingTerm],
        ) -> int:
            rows = []
            for p in prefs:
                exprs = [compile_req(e) for e in p.preference.match_expressions]
                exprs += [compile_field_req(e) for e in p.preference.match_fields]
                rows.append((tuple(exprs), float(p.weight)))
            if not rows:
                return -1
            return prefs_t.intern(tuple(rows))

        def compile_tolerations(tols: Sequence[api.Toleration]) -> int:
            rows = []
            for t in tols:
                key = S.intern(t.key) if t.key else -1
                op = TOL_OP_EXISTS if t.operator == "Exists" else TOL_OP_EQUAL
                val = S.intern(t.value)
                eff = _EFFECT_CODE[t.effect] if t.effect else -1
                rows.append((key, op, val, eff))
            return tols_t.intern(tuple(sorted(rows)))

        def compile_taints(taints: Sequence[api.Taint]) -> int:
            return taints_t.intern(
                tuple(
                    sorted(
                        (S.intern(t.key), S.intern(t.value), _EFFECT_CODE[t.effect])
                        for t in taints
                    )
                )
            )

        topo_keys = self._topo_keys
        topo_idx = self._topo_idx

        def topo_key_idx(key: str) -> int:
            i = topo_idx.get(key)
            if i is None:
                i = len(topo_keys)
                topo_idx[key] = i
                topo_keys.append(key)
            return i

        def compile_selector(sel: LabelSelector, namespaces: tuple[str, ...]) -> int:
            exprs = []
            ns_vals = tuple(sorted(S.intern(n) for n in namespaces))
            exprs.append(intern_expr(S.intern(NAMESPACE_KEY), OP_IN, ns_vals, 0.0))
            for k, v in sorted(sel.match_labels.items()):
                exprs.append(
                    intern_expr(S.intern(k), OP_IN, (S.intern(v),), 0.0)
                )
            for e in sel.match_expressions:
                exprs.append(compile_req(e))
            return sels_t.intern(tuple(exprs))

        def compile_aff_terms(
            terms: Sequence[PodAffinityTerm], own_ns: str
        ) -> list[tuple[int, int]]:
            out = []
            for t in terms:
                ns = t.namespaces or (own_ns,)
                out.append(
                    (compile_selector(t.label_selector, tuple(ns)),
                     topo_key_idx(t.topology_key))
                )
            return out

        image_ids = self._image_ids
        image_sizes = self._image_sizes

        def image_id(name: str) -> int:
            i = image_ids.get(name)
            if i is None:
                i = len(image_ids)
                image_ids[name] = i
            return i

        def compile_imageset(images: Sequence[str]) -> int:
            return imgsets_t.intern(tuple(sorted(image_id(i) for i in images)))

        group_ids = self._group_ids
        declared = {g.name: g.min_member for g in pod_groups}

        def group_id(name: str) -> int:
            if not name:
                return -1
            i = group_ids.get(name)
            if i is None:
                i = len(group_ids)
                group_ids[name] = i
            return i

        # ---- walk nodes (cached per object) ----
        def node_rowdata(nd: Node) -> dict:
            hit = self._node_cache.get(id(nd))
            if hit is not None and hit[0] is nd:
                return hit[1]
            labels = dict(nd.metadata.labels)
            labels.setdefault(HOSTNAME_LABEL, nd.name)
            imgs = []
            for img in nd.status.images:
                for nm in img.names:
                    ii = image_id(nm)
                    imgs.append(ii)
                    image_sizes[ii] = float(img.size_bytes)
            rows = [
                (S.intern(k), S.intern(v), _num_or_nan(v))
                for k, v in sorted(labels.items())
            ]
            data = {
                "alloc": self._resources_vec(nd.status.allocatable),
                "unsched": nd.spec.unschedulable,
                "taintset": compile_taints(nd.spec.taints),
                "lab_k": np.array([k for k, _, _ in rows], np.int32),
                "lab_v": np.array([v for _, v, _ in rows], np.int32),
                "lab_num": np.array([n for _, _, n in rows], np.float32),
                "images": imgs,
            }
            self._node_cache[id(nd)] = (nd, data)
            return data

        node_rows = [node_rowdata(nd) for nd in nodes]

        # ---- per-pod row data (cached per object) ----
        def pod_rowdata(p: Pod) -> dict:
            hit = self._pod_cache.get(id(p))
            if hit is not None and hit[0] is p:
                data = hit[1]
                if data["epoch"] is None or data["epoch"] == self._node_epoch:
                    return data
            a = p.spec.affinity or Affinity()
            req_id = -1
            pref_id = -1
            uses_fields = False
            if a.node_affinity and a.node_affinity.required:
                req_id = compile_node_affinity_required(a.node_affinity.required)
                uses_fields = uses_fields or any(
                    t.match_fields for t in a.node_affinity.required
                )
            if a.node_affinity and a.node_affinity.preferred:
                pref_id = compile_node_affinity_preferred(a.node_affinity.preferred)
                uses_fields = uses_fields or any(
                    t.preference.match_fields for t in a.node_affinity.preferred
                )
            sel_req_id = -1
            if p.spec.node_selector:
                term = NodeSelectorTerm(
                    tuple(
                        NodeSelectorRequirement(k, api.OP_IN, (v,))
                        for k, v in sorted(p.spec.node_selector.items())
                    )
                )
                sel_req_id = compile_node_affinity_required([term])
            ns = p.namespace
            aff: list[tuple[int, int]] = []
            anti: list[tuple[int, int]] = []
            prefs: list[tuple[int, int, float]] = []
            if a.pod_affinity:
                aff = compile_aff_terms(a.pod_affinity.required, ns)
                for w in a.pod_affinity.preferred:
                    (s, k) = compile_aff_terms([w.term], ns)[0]
                    prefs.append((s, k, float(w.weight)))
            if a.pod_anti_affinity:
                anti = compile_aff_terms(a.pod_anti_affinity.required, ns)
                for w in a.pod_anti_affinity.preferred:
                    (s, k) = compile_aff_terms([w.term], ns)[0]
                    prefs.append((s, k, -float(w.weight)))
            tsc = []
            for c in p.spec.topology_spread_constraints:
                when = (
                    WHEN_DO_NOT_SCHEDULE
                    if c.when_unsatisfiable == api.DO_NOT_SCHEDULE
                    else WHEN_SCHEDULE_ANYWAY
                )
                tsc.append((
                    topo_key_idx(c.topology_key),
                    compile_selector(c.label_selector, (ns,)),
                    when,
                    c.max_skew,
                ))
            labels = [(S.intern(NAMESPACE_KEY), S.intern(ns))] + [
                (S.intern(k), S.intern(v))
                for k, v in sorted(p.metadata.labels.items())
            ]
            ports = [
                port * 4 + {"TCP": 0, "UDP": 1, "SCTP": 2}.get(proto, 3)
                for (port, proto, _) in p.host_ports()
            ]
            data = {
                "reqvec": self._resources_vec(p.resource_requests()),
                "prio": p.spec.priority,
                "creation": p.metadata.creation_timestamp,
                "req_id": req_id,
                "pref_id": pref_id,
                "sel_req_id": sel_req_id,
                "tolset": compile_tolerations(p.spec.tolerations),
                "lab_k": _i32([k for k, _ in labels]),
                "lab_v": _i32([v for _, v in labels]),
                "ports": _i32(ports),
                "aff": _i32([x for t in aff for x in t]),
                "anti": _i32([x for t in anti for x in t]),
                "pref": _i32([x for s, k, _ in prefs for x in (s, k)]),
                "pref_w": _f32([w for _, _, w in prefs]),
                "tsc": _i32([x for k, s, w, _ in tsc for x in (k, s, w)]),
                "tsc_skew": _i32([sk for _, _, _, sk in tsc]),
                "n_aff": max(len(aff), len(anti), len(prefs)),
                "gid": group_id(p.spec.pod_group),
                "imageset": compile_imageset(p.images()),
                "can_preempt": p.spec.preemption_policy != "Never",
                "epoch": self._node_epoch if uses_fields else None,
            }
            self._pod_cache[id(p)] = (p, data)
            return data

        pend_rows = [pod_rowdata(p) for p in pending]
        exist_rows = [pod_rowdata(p) for p, _ in existing]
        all_rows = pend_rows + exist_rows

        # mark-and-sweep the caches against the live object set
        live_pods = {id(p) for p in pending} | {id(p) for p, _ in existing}
        if len(self._pod_cache) > 2 * max(len(live_pods), 1):
            self._pod_cache = {
                k: v for k, v in self._pod_cache.items() if k in live_pods
            }
        live_nodes = {id(nd) for nd in nodes}
        if len(self._node_cache) > 2 * max(len(live_nodes), 1):
            self._node_cache = {
                k: v for k, v in self._node_cache.items() if k in live_nodes
            }

        # the resource-name axis is final only now
        R = len(rn)

        MPL = self._stick(
            "MPL", _pad_dim(max([len(d["lab_k"]) for d in all_rows] + [1]), 8)
        )
        MA = self._stick(
            "MA", _pad_dim(max([d["n_aff"] for d in all_rows] + [1]), 2)
        )

        # ---- stable-side cache: everything derived from nodes/existing
        # alone, keyed on object identities plus every grow-only
        # interning dimension the arrays bake in ----
        stable_key = (
            tuple(id(nd) for nd in nodes),
            tuple((id(p), nm) for p, nm in existing),
            self._node_epoch, N, E, R, MPL, MA,
            len(exprs_t.rows), len(reqs_t.rows), len(prefs_t.rows),
            len(tols_t.rows), len(taints_t.rows), len(sels_t.rows),
            len(imgsets_t.rows), len(image_ids), len(group_ids),
            len(topo_keys),
        )
        if self._stable_key == stable_key:
            st = self._stable
        else:
            st = self._build_stable(
                nodes, existing, node_rows, exist_rows, node_index,
                n_real, e_real, N, E, R, MPL, MA,
            )
            # strong refs keep cached id()s from being reused
            st["__refs"] = (list(nodes), [p for p, _ in existing])
            self._stable_key = stable_key
            self._stable = st

        # group_min_member depends on the per-call pod_groups argument
        G = max(len(group_ids), 1)
        group_min_member = np.zeros(G, np.int32)
        for name, gi in group_ids.items():
            group_min_member[gi] = declared.get(name, 0)

        # ---- pending-pod arrays ----
        pod_req = np.zeros((P, R), np.float32)
        pod_prio = np.zeros(P, np.int32)
        pod_node_name = np.full(P, -1, np.int32)
        pod_nominated = np.full(P, -1, np.int32)
        pod_req_id = np.full(P, -1, np.int32)
        pod_sel_req_id = np.full(P, -1, np.int32)
        pod_pref_id = np.full(P, -1, np.int32)
        pod_tolset = np.zeros(P, np.int32)
        pod_group_arr = np.full(P, -1, np.int32)
        pod_imageset = np.zeros(P, np.int32)
        pod_can_preempt = np.zeros(P, bool)
        pod_valid = np.zeros(P, bool)
        pod_valid[:p_real] = True

        pl_keys = np.full((P, MPL), -1, np.int32)
        pl_vals = np.full((P, MPL), -1, np.int32)

        MPorts = self._stick(
            "MPorts",
            _pad_dim(max([len(d["ports"]) for d in pend_rows] + [1]), 4),
        )
        pod_ports = np.full((P, MPorts), -1, np.int32)
        pod_port_ids = np.full((P, MPorts), -1, np.int32)
        port_ids_t = _InternTable()  # distinct (port, proto) among pending

        pod_aff_terms = np.full((P, MA, 2), -1, np.int32)
        pod_anti_terms = np.full((P, MA, 2), -1, np.int32)
        pod_pref_aff = np.full((P, MA, 2), -1, np.int32)
        pod_pref_aff_w = np.zeros((P, MA), np.float32)

        MC = self._stick(
            "MC",
            _pad_dim(max([len(d["tsc_skew"]) for d in pend_rows] + [1]), 2),
        )
        pod_tsc = np.full((P, MC, 3), -1, np.int32)
        pod_tsc_skew = np.zeros((P, MC), np.int32)

        # volumes are not encoded in this slice: their per-pod axis keeps
        # the reference's empty pad (MVol bucket 2)
        MVol = self._stick("MVol", _pad_dim(1, 2))
        pod_vol_mode = np.full((P, MVol), -1, np.int32)
        pod_vol_req = np.full((P, MVol), -1, np.int32)
        pod_vol_class = np.full((P, MVol), -1, np.int32)
        pod_vol_size = np.zeros((P, MVol), np.float32)

        _scatter_rows(pod_req, [d["reqvec"] for d in pend_rows])
        _fill_scalars(pod_prio, [d["prio"] for d in pend_rows])
        _fill_scalars(pod_req_id, [d["req_id"] for d in pend_rows])
        _fill_scalars(pod_pref_id, [d["pref_id"] for d in pend_rows])
        _fill_scalars(pod_sel_req_id, [d["sel_req_id"] for d in pend_rows])
        _fill_scalars(pod_tolset, [d["tolset"] for d in pend_rows])
        _fill_scalars(pod_group_arr, [d["gid"] for d in pend_rows])
        _fill_scalars(pod_imageset, [d["imageset"] for d in pend_rows])
        _fill_scalars(pod_can_preempt, [d["can_preempt"] for d in pend_rows])
        _scatter_rows(pl_keys, [d["lab_k"] for d in pend_rows])
        _scatter_rows(pl_vals, [d["lab_v"] for d in pend_rows])
        _scatter_rows(pod_ports, [d["ports"] for d in pend_rows])
        _scatter_rows(pod_aff_terms.reshape(P, MA * 2),
                      [d["aff"] for d in pend_rows])
        _scatter_rows(pod_anti_terms.reshape(P, MA * 2),
                      [d["anti"] for d in pend_rows])
        _scatter_rows(pod_pref_aff.reshape(P, MA * 2),
                      [d["pref"] for d in pend_rows])
        _scatter_rows(pod_pref_aff_w, [d["pref_w"] for d in pend_rows])
        _scatter_rows(pod_tsc.reshape(P, MC * 3), [d["tsc"] for d in pend_rows])
        _scatter_rows(pod_tsc_skew, [d["tsc_skew"] for d in pend_rows])
        # sparse per-pod residue: pinned/nominated nodes and the per-cycle
        # distinct-port interning
        for i, (p, d) in enumerate(zip(pending, pend_rows)):
            if p.spec.node_name:
                pod_node_name[i] = node_index.get(p.spec.node_name, -2)
            if p.nominated_node_name:
                pod_nominated[i] = node_index.get(p.nominated_node_name, -1)
            if len(d["ports"]):
                for j, enc_port in enumerate(d["ports"]):
                    pod_port_ids[i, j] = port_ids_t.intern(int(enc_port))

        pod_order = np.full(P, np.iinfo(np.int32).max, np.int32)
        if p_real:
            creation = np.array([d["creation"] for d in pend_rows], np.float64)
            pod_order[:p_real] = priority_rank(pod_prio[:p_real], creation)

        exist_anti = st["exist_anti"]
        exist_pref = st["exist_pref"]
        fields = {
            "num_nodes": np.asarray(n_real, np.int32),
            "num_pending": np.asarray(p_real, np.int32),
            "num_existing": np.asarray(e_real, np.int32),
            "num_domains": np.asarray(st["num_domains_val"], np.int32),
            "cycle_index": np.asarray(self._cycle_index, np.int32),
            "node_allocatable": st["node_alloc"],
            "node_requested": st["node_requested"],
            "node_unschedulable": st["node_unsched"],
            "node_taintset": st["node_taintset"],
            "node_label_keys": st["nl_keys"],
            "node_label_vals": st["nl_vals"],
            "node_label_num": st["nl_num"],
            "node_domains": st["node_domains"],
            "node_images": st["node_images"],
            "node_used_ports": st["node_used_ports"],
            "node_valid": st["node_valid"],
            "pod_requested": pod_req,
            "pod_priority": pod_prio,
            "pod_order": pod_order,
            "pod_node_name": pod_node_name,
            "pod_nominated": pod_nominated,
            "pod_req_id": pod_req_id,
            "pod_sel_req_id": pod_sel_req_id,
            "pod_pref_id": pod_pref_id,
            "pod_tolset": pod_tolset,
            "pod_label_keys": pl_keys,
            "pod_label_vals": pl_vals,
            "pod_ports": pod_ports,
            "pod_port_ids": pod_port_ids,
            "pod_vol_mode": pod_vol_mode,
            "pod_vol_req": pod_vol_req,
            "pod_vol_class": pod_vol_class,
            "pod_vol_size": pod_vol_size,
            "pod_aff_terms": pod_aff_terms,
            "pod_anti_terms": pod_anti_terms,
            "pod_pref_aff": pod_pref_aff,
            "pod_pref_aff_w": pod_pref_aff_w,
            "pod_tsc": pod_tsc,
            "pod_tsc_skew": pod_tsc_skew,
            "pod_group": pod_group_arr,
            "pod_imageset": pod_imageset,
            "pod_can_preempt": pod_can_preempt,
            "pod_valid": pod_valid,
            "group_min_member": group_min_member,
        }
        for name in (
            "ex_key", "ex_op", "ex_vals", "ex_num", "rq_exprs", "pf_exprs",
            "pf_weight", "tl_key", "tl_op", "tl_val", "tl_effect",
            "tl_valid", "ts_key", "ts_val", "ts_effect", "ts_valid",
            "sel_exprs", "imgset_sizes", "group_existing_count",
            "exist_node", "exist_priority", "exist_start", "exist_pdb",
            "exist_requested", "exist_label_keys", "exist_label_vals",
            "exist_ports", "exist_anti_terms", "exist_pref_aff",
            "exist_pref_aff_w", "exist_valid", "node_pods", "domain_key",
            "domain_node_count", "pdb_allowed", "pv_req_id", "pv_class",
            "pv_capacity", "pv_avail",
        ):
            fields[name] = st[name]
        aux = {
            "resource_names": tuple(rn),
            "topology_keys": tuple(topo_keys),
            "num_distinct_ports": self._stick("Q", _pad_dim(len(port_ids_t), 4)),
            "has_inter_pod_affinity": self._stick_flag(
                "aff",
                bool(
                    (pod_aff_terms >= 0).any()
                    or (pod_anti_terms >= 0).any()
                    or (pod_pref_aff >= 0).any()
                    or (exist_anti >= 0).any()
                    or (exist_pref >= 0).any()
                ),
            ),
            "has_topology_spread": self._stick_flag(
                "tsc", bool((pod_tsc >= 0).any())
            ),
            "has_volumes": self._stick_flag("vol", False),
            "has_multi_volume": self._stick_flag("mvol", False),
        }
        return fields, aux

    def _build_stable(
        self, nodes, existing, node_rows, exist_rows, node_index,
        n_real, e_real, N, E, R, MPL, MA,
    ) -> dict:
        """The stable (node/existing/table) side of the snapshot."""
        S = self.strings
        st: dict[str, Any] = {}

        ML = _pad_dim(max([len(d["lab_k"]) for d in node_rows] + [1]), 8)
        node_alloc = np.zeros((N, R), np.float32)
        node_requested = np.zeros((N, R), np.float32)
        node_unsched = np.zeros(N, bool)
        node_taintset = np.zeros(N, np.int32)
        nl_keys = np.full((N, ML), -1, np.int32)
        nl_vals = np.full((N, ML), -1, np.int32)
        nl_num = np.full((N, ML), np.nan, np.float32)
        node_valid = np.zeros(N, bool)
        node_valid[:n_real] = True
        _scatter_rows(node_alloc, [d["alloc"] for d in node_rows])
        _fill_scalars(node_unsched, [d["unsched"] for d in node_rows])
        _fill_scalars(node_taintset, [d["taintset"] for d in node_rows])
        _scatter_rows(nl_keys, [d["lab_k"] for d in node_rows])
        _scatter_rows(nl_vals, [d["lab_v"] for d in node_rows])
        _scatter_rows(nl_num, [d["lab_num"] for d in node_rows])

        # volumes and PDBs are not encoder inputs in this slice: their
        # tables keep the reference's empty pads (V bucket 4, GP 1, MB 2)
        V = _pad_dim(0, 4)
        st["pv_req_id"] = np.full(V, -1, np.int32)
        st["pv_class"] = np.full(V, -1, np.int32)
        st["pv_capacity"] = np.zeros(V, np.float32)
        st["pv_avail"] = np.zeros(V, bool)
        st["pdb_allowed"] = np.zeros(1, np.int32)
        st["exist_pdb"] = np.full((E, 2), -1, np.int32)

        # ---- existing-pod arrays ----
        # start times relative to the oldest existing pod (f32 resolution)
        start_base = min(
            (p.metadata.creation_timestamp for p, _ in existing), default=0.0
        )
        exist_start = np.zeros(E, np.float32)
        exist_node = np.full(E, -1, np.int32)
        exist_prio = np.zeros(E, np.int32)
        exist_req = np.zeros((E, R), np.float32)
        el_keys = np.full((E, MPL), -1, np.int32)
        el_vals = np.full((E, MPL), -1, np.int32)
        MEP = self._stick(
            "MEP", _pad_dim(max([len(d["ports"]) for d in exist_rows] + [1]), 4)
        )
        exist_ports = np.full((E, MEP), -1, np.int32)
        exist_anti = np.full((E, MA, 2), -1, np.int32)
        exist_pref = np.full((E, MA, 2), -1, np.int32)
        exist_pref_w = np.zeros((E, MA), np.float32)
        exist_valid = np.zeros(E, bool)
        exist_valid[:e_real] = True
        exist_group = np.full(E, -1, np.int32)
        _fill_scalars(exist_prio, [d["prio"] for d in exist_rows])
        _fill_scalars(exist_group, [d["gid"] for d in exist_rows])
        _fill_scalars(exist_start, [d["creation"] - start_base for d in exist_rows])
        _fill_scalars(exist_node, [node_index.get(nm, -1) for _, nm in existing])
        _scatter_rows(exist_req, [d["reqvec"] for d in exist_rows])
        _scatter_rows(el_keys, [d["lab_k"] for d in exist_rows])
        _scatter_rows(el_vals, [d["lab_v"] for d in exist_rows])
        _scatter_rows(exist_ports, [d["ports"] for d in exist_rows])
        _scatter_rows(exist_anti.reshape(E, MA * 2), [d["anti"] for d in exist_rows])
        _scatter_rows(exist_pref.reshape(E, MA * 2), [d["pref"] for d in exist_rows])
        _scatter_rows(exist_pref_w, [d["pref_w"] for d in exist_rows])

        # per-node aggregation: requested sums, the priority-sorted victim
        # table, used ports
        en = exist_node[:e_real]
        placed_mask = en >= 0
        np.add.at(node_requested, en[placed_mask], exist_req[:e_real][placed_mask])
        used_ports: list[list[int]] = [[] for _ in range(N)]
        for i, d in enumerate(exist_rows):
            if len(d["ports"]) and exist_node[i] >= 0:
                used_ports[int(exist_node[i])].extend(int(x) for x in d["ports"])
        MUP = self._stick(
            "MUP", _pad_dim(max([len(u) for u in used_ports] + [1]), 4)
        )
        node_used_ports = np.full((N, MUP), -1, np.int32)
        for i, u in enumerate(used_ports):
            if u:
                node_used_ports[i, : len(u)] = u

        e_ids = np.flatnonzero(placed_mask)
        if e_ids.size:
            order_v = np.lexsort((-e_ids, exist_prio[:e_real][e_ids], en[e_ids]))
            se = e_ids[order_v].astype(np.int32)
            sn = en[se]
            starts = np.r_[True, sn[1:] != sn[:-1]]
            group_start = np.maximum.accumulate(
                np.where(starts, np.arange(sn.size), 0)
            )
            col = np.arange(sn.size) - group_start
            MPN = self._stick("MPN", _pad_dim(int(col.max()) + 1, 8))
            node_pods = np.full((N, MPN), -1, np.int32)
            node_pods[sn, col] = se
        else:
            MPN = self._stick("MPN", _pad_dim(1, 8))
            node_pods = np.full((N, MPN), -1, np.int32)

        # ---- topology domains (flat ids across keys) ----
        topo_keys = self._topo_keys
        K = len(topo_keys)
        domain_map: dict[tuple[int, int], int] = {}
        node_domains = np.full((N, K), -1, np.int32)
        for i, nd in enumerate(nodes):
            labels = dict(nd.metadata.labels)
            labels.setdefault(HOSTNAME_LABEL, nd.name)
            for k, key in enumerate(topo_keys):
                if key in labels:
                    dk = (k, S.intern(labels[key]))
                    if dk not in domain_map:
                        domain_map[dk] = len(domain_map)
                    node_domains[i, k] = domain_map[dk]
        D = _pad_dim(len(domain_map), 8)
        domain_key = np.full(D, -1, np.int32)
        domain_node_count = np.zeros(D, np.float32)
        for (k, _v), d in domain_map.items():
            domain_key[d] = k
        for i in range(n_real):
            for k in range(K):
                d = node_domains[i, k]
                if d >= 0:
                    domain_node_count[d] += 1.0

        # ---- finalize the dedup tables ----
        exprs_rows = self._exprs_t.rows
        Ex = _pad_dim(len(exprs_rows), 8)
        MV = _pad_dim(max([len(v) for _, _, v, _ in exprs_rows] + [1]), 4)
        ex_key = np.full(Ex, -1, np.int32)
        ex_op = np.full(Ex, -1, np.int32)
        ex_vals = np.full((Ex, MV), -1, np.int32)
        ex_num = np.zeros(Ex, np.float32)
        for i, (k, op, vals, num) in enumerate(exprs_rows):
            ex_key[i] = k
            ex_op[i] = op
            ex_vals[i, : len(vals)] = vals
            ex_num[i] = num

        reqs_rows = self._reqs_t.rows
        Rq = _pad_dim(len(reqs_rows), 4)
        MT = _pad_dim(max([len(r) for r in reqs_rows] + [1]), 2)
        ME = _pad_dim(max([len(t) for r in reqs_rows for t in r] + [1]), 2)
        rq_exprs = np.full((Rq, MT, ME), -1, np.int32)
        for i, terms in enumerate(reqs_rows):
            for j, t in enumerate(terms):
                rq_exprs[i, j, : len(t)] = t

        prefs_rows = self._prefs_t.rows
        Pf = _pad_dim(len(prefs_rows), 2)
        MPT = _pad_dim(max([len(r) for r in prefs_rows] + [1]), 2)
        MPE = _pad_dim(
            max([len(t) for r in prefs_rows for (t, _w) in r] + [1]), 2
        )
        pf_exprs = np.full((Pf, MPT, MPE), -1, np.int32)
        pf_weight = np.zeros((Pf, MPT), np.float32)
        for i, row in enumerate(prefs_rows):
            for j, (exprs, w) in enumerate(row):
                pf_exprs[i, j, : len(exprs)] = exprs
                pf_weight[i, j] = w

        tols_rows = self._tols_t.rows
        Tl = _pad_dim(len(tols_rows), 2)
        MTl = _pad_dim(max([len(r) for r in tols_rows] + [1]), 4)
        tl_key = np.full((Tl, MTl), 0, np.int32)
        tl_op = np.zeros((Tl, MTl), np.int32)
        tl_val = np.zeros((Tl, MTl), np.int32)
        tl_effect = np.zeros((Tl, MTl), np.int32)
        tl_valid = np.zeros((Tl, MTl), bool)
        for i, row in enumerate(tols_rows):
            for j, (k, op, v, e) in enumerate(row):
                tl_key[i, j] = k
                tl_op[i, j] = op
                tl_val[i, j] = v
                tl_effect[i, j] = e
                tl_valid[i, j] = True

        taints_rows = self._taints_t.rows
        Ts = _pad_dim(len(taints_rows), 2)
        MTt = _pad_dim(max([len(r) for r in taints_rows] + [1]), 4)
        ts_key = np.full((Ts, MTt), -1, np.int32)
        ts_val = np.zeros((Ts, MTt), np.int32)
        ts_effect = np.zeros((Ts, MTt), np.int32)
        ts_valid = np.zeros((Ts, MTt), bool)
        for i, row in enumerate(taints_rows):
            for j, (k, v, e) in enumerate(row):
                ts_key[i, j] = k
                ts_val[i, j] = v
                ts_effect[i, j] = e
                ts_valid[i, j] = True

        sels_rows = self._sels_t.rows
        Ssel = _pad_dim(len(sels_rows), 4)
        MSE = _pad_dim(max([len(r) for r in sels_rows] + [1]), 4)
        sel_exprs = np.full((Ssel, MSE), -1, np.int32)
        for i, row in enumerate(sels_rows):
            sel_exprs[i, : len(row)] = row

        I = max(len(self._image_ids), 1)
        Is = _pad_dim(len(self._imgsets_t.rows), 2)
        imgset_sizes = np.zeros((Is, I), np.float32)
        for i, row in enumerate(self._imgsets_t.rows):
            for ii in row:
                imgset_sizes[i, ii] = self._image_sizes.get(ii, 0.0)
        node_images = np.zeros((N, I), bool)
        for i, d in enumerate(node_rows):
            for ii in d["images"]:
                node_images[i, ii] = True

        G = max(len(self._group_ids), 1)
        group_existing_count = np.zeros(G, np.int32)
        for g in exist_group[:e_real]:
            if g >= 0:
                group_existing_count[g] += 1

        st.update(
            node_alloc=node_alloc, node_requested=node_requested,
            node_unsched=node_unsched, node_taintset=node_taintset,
            nl_keys=nl_keys, nl_vals=nl_vals, nl_num=nl_num,
            node_valid=node_valid, node_images=node_images,
            exist_node=exist_node, exist_priority=exist_prio,
            exist_requested=exist_req, exist_label_keys=el_keys,
            exist_label_vals=el_vals, exist_ports=exist_ports,
            exist_anti=exist_anti, exist_pref=exist_pref,
            exist_anti_terms=exist_anti, exist_pref_aff=exist_pref,
            exist_pref_aff_w=exist_pref_w, exist_valid=exist_valid,
            exist_start=exist_start, node_used_ports=node_used_ports,
            node_pods=node_pods, node_domains=node_domains,
            domain_key=domain_key, domain_node_count=domain_node_count,
            num_domains_val=len(domain_map),
            ex_key=ex_key, ex_op=ex_op, ex_vals=ex_vals, ex_num=ex_num,
            rq_exprs=rq_exprs, pf_exprs=pf_exprs, pf_weight=pf_weight,
            tl_key=tl_key, tl_op=tl_op, tl_val=tl_val, tl_effect=tl_effect,
            tl_valid=tl_valid, ts_key=ts_key, ts_val=ts_val,
            ts_effect=ts_effect, ts_valid=ts_valid, sel_exprs=sel_exprs,
            imgset_sizes=imgset_sizes,
            group_existing_count=group_existing_count,
        )
        return st
