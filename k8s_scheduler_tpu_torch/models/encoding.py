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

PodDisruptionBudgets are an encoder input (`pdbs=`): `pdb_allowed` [GP]
holds each budget's disruptionsAllowed and `exist_pdb` [E, MB] the first
MB budgets (in list order) whose selector covers each running pod, as
preemption reads them.

Volumes are an encoder input (`pvcs=`, `pvs=`, `storage_classes=`): each
pending pod's mounted claims become rows of `pod_vol_*` [P, MVol] (mode 0
bound PV, its nodeAffinity requirement in `pod_vol_req`; mode 1 unbound
WaitForFirstConsumer, with class, size and the dynamic-provisioning
requirement or -1 any / -2 none; mode 2 unschedulable), and the PVs the
table `pv_*` [V]. PV nodeAffinity and class allowedTopologies are interned
through the same requirement table as pod node affinity, in the
reference's order.

`encode_packed` returns an `EncodedFrame`: the snapshot packed into two
device buffers (`models/packing.py`) and the pod slots whose rows changed
since the previous frame, for the device-resident carry
(`core/cycle.py build_carry_fns`). The packed host buffers are a
persistent arena (pinned on the card: the upload's source), whose field
views a frame rewrites in place. The incremental encode of the reference
(`encode_packed`'s delta path): when only the pending side changed, only
the dirty pod slots' rows are rewritten; when the running list changed by
a pure append or a pure tail removal, the stable side is folded in place
first (`_try_fold_existing`). Anything else takes the full encode. Either
way the frame is bit for bit a full encode of the same objects.
`ingest_pod` parses an arriving pod's row ahead of the flush.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from ..framework.queuesort import PrioritySort, QueueSortPlugin
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


class EncodedFrame(NamedTuple):
    """encode_packed's result: the device buffers, their spec, a snapshot
    whose fields are views into them, and which pod slots changed.
    `dirty` is None when the carry key changed (every row must be rebuilt)
    and else an i32 array of slot ids: at least every slot whose row of a
    pod-axis field changed since the previous frame (the full path compares
    the rows; the delta path takes the slots whose pod object changed or
    was reported mutated, the slots emptied and those whose port ids
    moved), plus, when the existing set moved NodePorts' used ports, every
    slot of a pod that names a host port."""

    wbuf: torch.Tensor
    bbuf: torch.Tensor
    spec: Any
    snap: "ClusterSnapshot"
    dirty: np.ndarray | None


# pod-axis fields the carried tables do not read, left out of the row
# comparison: the queue rank moves for every later pod when one changes
_UNCARRIED_POD_FIELDS = ("pod_order",)


def _bits(a: np.ndarray) -> np.ndarray:
    """The array's bit patterns (floats compared exactly: -0.0 is not 0.0,
    a NaN equals itself)."""
    return a.view(np.int32) if a.dtype == np.float32 else a


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


MB = 2  # PDBs tracked per running pod (the reference's bound: a third
# budget selecting one pod is pathological; the first two protect it)


def _pdb_matches(pdb: api.PodDisruptionBudget, p: Pod) -> bool:
    """Does `pdb`'s selector cover pod `p`?"""
    if p.namespace != pdb.namespace:
        return False
    sel = pdb.selector
    labels = p.metadata.labels
    for k, v in sel.match_labels.items():
        if labels.get(k) != v:
            return False
    for e in sel.match_expressions:
        val = labels.get(e.key)
        if e.operator == api.OP_IN and val not in e.values:
            return False
        if e.operator == api.OP_NOT_IN and val in e.values:
            return False
        if e.operator == api.OP_EXISTS and val is None:
            return False
        if e.operator == api.OP_DOES_NOT_EXIST and val is not None:
            return False
    return True


def _pdb_tables(pdbs, existing, E: int) -> tuple[np.ndarray, np.ndarray]:
    """(pdb_allowed i32 [GP], exist_pdb i32 [E, MB]): each running pod's
    first MB covering budgets in list order. A budget with matchLabels only
    tests the pods carrying its first label pair (an index over the running
    pods), so hundreds of budgets over 12000 pods stay cheap."""
    GP = max(len(pdbs), 1)
    pdb_allowed = np.zeros(GP, np.int32)
    exist_pdb = np.full((E, MB), -1, np.int32)
    if not pdbs:
        return pdb_allowed, exist_pdb
    by_label: dict[tuple[str, str], list[int]] = {}
    for i, (p, _nm) in enumerate(existing):
        for kv in p.metadata.labels.items():
            by_label.setdefault(kv, []).append(i)
    n_set = np.zeros(E, np.int32)
    everyone = range(len(existing))
    for gi, pdb in enumerate(pdbs):
        pdb_allowed[gi] = pdb.disruptions_allowed
        ml = pdb.selector.match_labels
        cands = by_label.get(next(iter(ml.items())), []) if ml else everyone
        for i in cands:
            if n_set[i] < MB and _pdb_matches(pdb, existing[i][0]):
                exist_pdb[i, n_set[i]] = gi
                n_set[i] += 1
    return pdb_allowed, exist_pdb


def _num_or_nan(s: str) -> float:
    try:
        return float(s)
    except ValueError:
        return float("nan")


def _scatter_at(dst: np.ndarray, idx: np.ndarray, rows, pad) -> None:
    """dst[idx[k], :len(rows[k])] = rows[k], the rest of each of those rows
    `pad`: one fancy-index write for the batch (every row fits `dst`'s
    width; a [n, a, b] field is written through its [n, a * b] view)."""
    dst[idx] = pad
    lens = np.fromiter((len(r) for r in rows), np.int64, len(rows))
    total = int(lens.sum())
    if total:
        starts = np.cumsum(lens) - lens
        dst[np.repeat(idx, lens), np.arange(total) - np.repeat(starts, lens)] = (
            np.concatenate([r for r in rows if len(r)]))


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

    # HTTP-extender verdicts (computed on the host after the encode, set by
    # dataclasses.replace; None unless `has_extender`)
    has_extender: bool = False
    pod_extender_mask: torch.Tensor | None = None  # bool [P, N]
    pod_extender_score: torch.Tensor | None = None  # f32 [P, N] weighted
    # host-side bound on the inter-pod raw score sums (pref_raw_bound)
    pref_raw_bound: float = 0.0

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
# the extender verdict planes: array fields only when `has_extender`
EXTENDER_FIELDS = ("pod_extender_mask", "pod_extender_score")
# the reference snapshot's non-array fields (pref_raw_bound is the port's,
# derived from the arrays)
AUX_FIELDS = tuple(
    f.name for f in dataclasses.fields(ClusterSnapshot)
    if f.type != "torch.Tensor" and f.name != "pref_raw_bound"
    and f.name not in EXTENDER_FIELDS
)


def snapshot_from_numpy(
    fields: dict[str, np.ndarray], aux: dict[str, Any], device=None
) -> ClusterSnapshot:
    """Build a snapshot from host arrays: `fields` are the reference
    snapshot's `array_fields()` (or this encoder's), `aux` its non-array
    fields. One tensor per field, copied to `device` with its dtype
    unchanged, so both packages compute on identical inputs."""
    dev = resolve_device(device)
    names = ARRAY_FIELDS + (EXTENDER_FIELDS if aux.get("has_extender") else ())
    missing = [n for n in names if n not in fields]
    if missing:
        raise ValueError(f"snapshot fields missing: {missing}")
    kw = {n: torch.from_numpy(np.array(fields[n], order="C")).to(dev)
          for n in names}
    kw.update({n: aux[n] for n in AUX_FIELDS if n in aux})
    kw["pref_raw_bound"] = pref_raw_bound(
        fields["pod_pref_aff"], fields["pod_pref_aff_w"], fields["pod_tsc"],
        fields["exist_pref_aff"], fields["exist_pref_aff_w"])
    return ClusterSnapshot(**kw)


def pref_raw_bound(pod_terms, pod_w, pod_tsc, exist_terms, exist_w) -> float:
    """An upper bound, from the host arrays alone, on |every partial sum|
    of a raw inter-pod score that a cycle over this snapshot forms (K3's
    integer-valued f32 sums are exact in any order below 2^24): a pod's own
    preferred rows sum at most its |weights| times a count, and a count at
    most every pod (pending and existing); its symmetric sum at most the
    |weight| of every preferred term of every pod, each term counted once
    per node; a ScheduleAnyway sum at most MC counts."""
    def weights(terms, w):
        return np.where(np.asarray(terms)[..., 0] >= 0, np.abs(np.asarray(w)), 0.0)

    pw, ew = weights(pod_terms, pod_w), weights(exist_terms, exist_w)
    pods = pw.shape[0] + ew.shape[0]
    own = float(pw.sum(axis=1).max(initial=0.0)) * pods
    soft = float(np.asarray(pod_tsc).shape[1]) * pods
    return max(own + float(pw.sum() + ew.sum()), soft)


class SnapshotEncoder:
    """Builds `ClusterSnapshot`s. Holds the interners and the derived intern
    tables so every id is stable across encodes, and caches per-object
    encoded rows and the stable (node/existing) side like the reference.

    The serving knobs are the reference's (`models/encoding.py:397-436`):
    `pad_pods` / `pad_nodes` fix the P / N pads (else the power-of-two
    bucket through `hysteresis_pad`), `pad_existing` and
    `pad_pods_per_node` pre-size the sticky E and MPN pads an existing-set
    fold would otherwise outgrow mid-serving, `pad_ma` / `pad_mc` the
    sticky per-pod term pads, `pad_hysteresis_pct` the down-step margin of
    the P / N buckets; `queue_sort` is the profile's queueSort plugin
    (`framework/queuesort.py`, default PrioritySort), which owns
    `pod_order`. `incremental=False` makes every `encode_packed` a full
    encode (a reference for the delta path's frames)."""

    def __init__(
        self,
        resource_names: Sequence[str] = api.DEFAULT_RESOURCES,
        device=None,
        *,
        pad_pods: int | None = None,
        pad_nodes: int | None = None,
        queue_sort: QueueSortPlugin | None = None,
        pad_existing: int | None = None,
        pad_pods_per_node: int | None = None,
        pad_ma: int | None = None,
        pad_mc: int | None = None,
        pad_hysteresis_pct: float = 0.0,
        incremental: bool = True,
    ) -> None:
        self.device = resolve_device(device)
        self.strings = StringInterner()
        self.resource_names = list(resource_names)
        self.pad_pods = pad_pods
        self.pad_nodes = pad_nodes
        self.pad_existing = pad_existing
        self.pad_pods_per_node = pad_pods_per_node
        self.pad_ma = pad_ma
        self.pad_mc = pad_mc
        self.pad_hysteresis_pct = float(pad_hysteresis_pct)
        self._held_pads: dict[str, int] = {}  # last pad used per hysteresis dim
        self.queue_sort = queue_sort if queue_sort is not None else PrioritySort()
        self.incremental = incremental
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
        self._vol_sig = None
        self._vol_epoch = 0
        self._carry_key = None
        # the delta path's state, stashed by every full encode; the arena:
        # host buffers (pinned on the card) and numpy views of its fields
        self._delta_state: dict | None = None
        self._arena_synced = False
        self._arena: dict[str, np.ndarray] | None = None
        self._arena_spec = None
        self._host: tuple[torch.Tensor, torch.Tensor] | None = None
        self._upload_done = None
        # the previous frame's regime: (carry key, pack layout)
        self._frame_key = None
        self.last_changed_slots: np.ndarray | None = None
        # counters; `delta_profile` holds the last delta encode's ms per
        # segment (detect, rows, ports, fold, apply, order, ingest) and is
        # empty after a full encode, whose cause `full_reason` names
        self.full_encodes = 0
        self.delta_hits = 0
        self.fold_hits = 0
        self.ingest_hits = 0
        self.ingest_misses = 0
        self.delta_profile: dict[str, float] = {}
        self.full_reason = ""
        # admission-time rows (ingest_pod), keyed by id(pod) with the pod held
        self._staged: dict[int, tuple[Any, dict]] = {}
        self._staged_grew = False
        self._ingest_ms = 0.0

    def hysteresis_pad(self, dim: str, candidate: int, real: int) -> int:
        """The P / N pad to use for this encode given the bucket-rounded
        `candidate` and the `real` count behind it: up-steps at once; a
        down-step only when the real count leaves at least
        `pad_hysteresis_pct` percent of headroom in the smaller bucket, so
        a count oscillating around a boundary holds the larger regime. The
        identity on `candidate` with the knob at 0."""
        held = self._held_pads.get(dim, 0)
        pct = self.pad_hysteresis_pct
        if candidate >= held or pct <= 0.0 or real <= candidate * (1.0 - pct / 100.0):
            self._held_pads[dim] = candidate
            return candidate
        return held

    def _stick(self, key: str, val: int) -> int:
        val = max(val, self._sticky_dims.get(key, 0))
        self._sticky_dims[key] = val
        return val

    def _stick_flag(self, key: str, val: bool) -> bool:
        cur = self._sticky_flags.get(key, False) or bool(val)
        self._sticky_flags[key] = cur
        return cur

    def _table_lens(self) -> tuple:
        """Sizes of every grow-only interning structure a cached row can
        reference: if one grows while a row is built, the stable side's
        finalized tables lack the entry and the delta path must fall back
        to a full encode."""
        return (
            len(self.strings), len(self.resource_names), len(self._exprs_t),
            len(self._reqs_t), len(self._prefs_t), len(self._tols_t),
            len(self._taints_t), len(self._sels_t), len(self._imgsets_t),
            len(self._image_ids), len(self._group_ids), len(self._topo_keys),
        )

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
        *,
        pvcs: Sequence[api.PersistentVolumeClaim] = (),
        pvs: Sequence[api.PersistentVolume] = (),
        storage_classes: Sequence[api.StorageClass] = (),
        pdbs: Sequence[api.PodDisruptionBudget] = (),
    ) -> ClusterSnapshot:
        """One-shot encode onto the encoder's device. `existing` is
        (pod, node_name) for every pod already assigned."""
        fields, aux = self.encode_numpy(nodes, pending, existing, pod_groups,
                                        pvcs=pvcs, pvs=pvs,
                                        storage_classes=storage_classes,
                                        pdbs=pdbs)
        return snapshot_from_numpy(fields, aux, self.device)

    # ------------------------------------------------------------------
    # The packed frame and its incremental encode (reference
    # `models/encoding.py:1769-2567`). Contract for the delta path, as the
    # reference's: callers keep one list object per stable side and replace
    # or append to it when it changes (never rewrite an element in place);
    # pod objects are immutable once handed to the encoder, except
    # `nominated_node_name`, whose in-place change is reported through
    # `mutated_ids`.
    # ------------------------------------------------------------------

    # (field, row key, pad) of the pending side's 2-D fields and of its
    # 3-D fields (written through their [P, -1] views), and the scalar
    # fields' pads (the full path's initial values)
    _PEND_2D = (
        ("pod_requested", "reqvec", 0.0),
        ("pod_label_keys", "lab_k", -1),
        ("pod_label_vals", "lab_v", -1),
        ("pod_ports", "ports", -1),
        ("pod_pref_aff_w", "pref_w", 0.0),
        ("pod_tsc_skew", "tsc_skew", 0),
        ("pod_vol_mode", "vol_mode", -1),
        ("pod_vol_req", "vol_req", -1),
        ("pod_vol_class", "vol_cls", -1),
        ("pod_vol_size", "vol_size", 0.0),
    )
    _PEND_3D = (
        ("pod_aff_terms", "aff", -1),
        ("pod_anti_terms", "anti", -1),
        ("pod_pref_aff", "pref", -1),
        ("pod_tsc", "tsc", -1),
    )
    _PEND_SCALAR = (
        ("pod_priority", "prio"),
        ("pod_req_id", "req_id"),
        ("pod_pref_id", "pref_id"),
        ("pod_sel_req_id", "sel_req_id"),
        ("pod_tolset", "tolset"),
        ("pod_group", "gid"),
        ("pod_imageset", "imageset"),
        ("pod_can_preempt", "can_preempt"),
    )
    _PEND_SCALAR_PAD = {
        "pod_priority": 0, "pod_req_id": -1, "pod_pref_id": -1,
        "pod_sel_req_id": -1, "pod_tolset": 0, "pod_group": -1,
        "pod_imageset": 0, "pod_can_preempt": False,
        "pod_node_name": -1, "pod_nominated": -1,
    }
    # (field, row key, pad) of the running side's row fields
    _EXIST_ROWS = (
        ("exist_requested", "reqvec", 0.0),
        ("exist_label_keys", "lab_k", -1),
        ("exist_label_vals", "lab_v", -1),
        ("exist_ports", "ports", -1),
        ("exist_anti_terms", "anti", -1),
        ("exist_pref_aff", "pref", -1),
        ("exist_pref_aff_w", "pref_w", 0.0),
    )

    def ingest_pod(self, pod: Pod) -> bool:
        """Admission-time encode (reference `:1856`): parse `pod`'s row now,
        ahead of the flush, so the next delta finds it staged and skips the
        parse (`ingest_hits`; the staging ms show as the `ingest` segment
        of the next `delta_profile`). If the parse grew an interning table,
        the next `encode_packed` takes the full path once. Returns True if
        a row was staged; without a delta state yet, counts an
        `ingest_misses` and stages nothing."""
        ds = self._delta_state
        if ds is None:
            self.ingest_misses += 1
            return False
        t0 = time.perf_counter()
        lens0 = self._table_lens()
        try:
            d = ds["pod_rowdata"](pod)
        except Exception:
            self.ingest_misses += 1
            return False
        if self._table_lens() != lens0:
            self._staged_grew = True
        self._staged[id(pod)] = (pod, d)
        self._ingest_ms += (time.perf_counter() - t0) * 1e3
        return True

    def clear_ingest(self) -> None:
        """Drop staged rows no flush consumed (pods dropped between
        admission and the flush)."""
        self._staged.clear()

    def encode_packed(
        self,
        nodes: Sequence[Node],
        pending: Sequence[Pod],
        existing: Sequence[tuple[Pod, str]] = (),
        pod_groups: Sequence[api.PodGroup] = (),
        pvcs: Sequence[api.PersistentVolumeClaim] = (),
        pvs: Sequence[api.PersistentVolume] = (),
        storage_classes: Sequence[api.StorageClass] = (),
        pdbs: Sequence[api.PodDisruptionBudget] = (),
        mutated_ids: frozenset | set = frozenset(),
    ) -> EncodedFrame:
        """Encode, pack and upload in one step (reference
        `models/encoding.py:1898`). The buffers are new device tensors each
        frame (copies on the CPU), so an earlier frame's snapshot stays
        valid; the host arena they come from is rewritten by the next call.

        The delta path (`_encode_delta`) runs when the nodes, volumes and
        PDBs are the previous frame's objects and the running list is too
        or changed by a pure append or tail removal (`_try_fold_existing`);
        it falls back to the full encode on a new pad, interning growth or
        a dim overflow (`full_reason` names the cause). `full_encodes`,
        `delta_hits` and `fold_hits` count the paths.

        `dirty` (see `EncodedFrame`) is None on the first frame and
        whenever the carry key changes: `_carry_key`, the reference's rule
        (node objects, volumes, pads and interning dims, not the
        existing-pod set or PDBs), with the pack layout (pod pads, the
        capability flags, the distinct-port axis). On the full path it
        compares every pod row of every pod-axis field but the queue rank
        bit for bit with the arena's (the previous frame's), and adds every
        port-bearing slot when NodePorts' used ports moved; the delta path
        gives a superset of those rows. `last_changed_slots` holds the rows
        alone, without the port-bearing slots."""
        ds = self._delta_state
        if self._staged_grew:
            self._staged_grew = False
            ds = None
            self.full_reason = "an ingested row grew an interning table"
        elif not self.incremental:
            ds = None
            self.full_reason = "incremental encode off"
        elif ds is None:
            self.full_reason = "no earlier full encode"
        if ds is not None and self._stable_except_existing_ok(
                ds, nodes, pvcs, pvs, storage_classes, pdbs):
            frame = self._encode_delta(ds, pending, existing, pod_groups, mutated_ids)
            if frame is not None:
                self.delta_hits += 1
                return frame
        self.full_encodes += 1
        self.delta_profile = {}
        return self._encode_full(nodes, pending, existing, pod_groups, pvcs, pvs,
                                 storage_classes, pdbs)

    def _encode_full(self, nodes, pending, existing, pod_groups, pvcs, pvs,
                     storage_classes, pdbs) -> EncodedFrame:
        """The full path: encode, compare the pod rows with the arena's for
        `dirty`, then write every field into the arena."""
        from . import packing

        fields, aux = self.encode_numpy(
            nodes, pending, existing, pod_groups, pvcs=pvcs, pvs=pvs,
            storage_classes=storage_classes, pdbs=pdbs)
        aux = dict(aux, pref_raw_bound=pref_raw_bound(
            fields["pod_pref_aff"], fields["pod_pref_aff_w"], fields["pod_tsc"],
            fields["exist_pref_aff"], fields["exist_pref_aff_w"]))
        spec = packing.spec_of_fields(fields, aux)
        key = (self._carry_key, spec.layout_key())
        dirty = None
        self.last_changed_slots = None
        if key == self._frame_key:  # the arena holds the previous frame, same layout
            A = self._arena
            P = fields["pod_valid"].shape[0]
            changed = np.zeros(P, bool)
            for n, a in fields.items():
                if n.startswith("pod_") and n not in _UNCARRIED_POD_FIELDS:
                    changed |= (_bits(a) != _bits(A[n])).reshape(P, -1).any(axis=1)
            self.last_changed_slots = np.nonzero(changed)[0].astype(np.int32)
            if not np.array_equal(fields["node_used_ports"], A["node_used_ports"]):
                changed |= (fields["pod_ports"] >= 0).any(axis=1)
            dirty = np.nonzero(changed)[0].astype(np.int32)
        self._install_arena(fields, spec)
        self._frame_key = key
        self._carry_key = key  # the regime key a CarryKeeper compares
        return self._emit(spec, dirty)

    def _stable_except_existing_ok(self, ds, nodes, pvcs, pvs, storage_classes,
                                   pdbs) -> bool:
        """Are the nodes, volumes, PDBs and fixed pads the last full
        encode's (list identity first, element identity when the list was
        rebuilt; PDBs' disruptionsAllowed by value)? Names the cause in
        `full_reason` when not."""
        why = None
        if not self._arena_synced:
            why = "a direct encode() since the last packed frame"
        elif ds["pads"][:2] != (self.pad_pods, self.pad_nodes):
            why = "pad_pods / pad_nodes changed"
        elif ds["nodes_ids"] != (id(nodes), len(nodes)) and (
                tuple(id(nd) for nd in nodes) != ds["nodes_elems"]):
            why = "the node objects changed"
        elif ds["vol_ids"] != (id(pvcs), len(pvcs), id(pvs), len(pvs),
                               id(storage_classes), len(storage_classes)) and (
                ds["vol_elems"] != (tuple(id(c) for c in pvcs), tuple(id(v) for v in pvs),
                                    tuple(id(c) for c in storage_classes))):
            why = "the volume objects changed"
        elif ds["pdb_ids"] != (id(pdbs), len(pdbs)) and (
                tuple(id(b) for b in pdbs) != ds["pdb_elems"][0]):
            why = "the PDB objects changed"
        elif tuple(b.disruptions_allowed for b in pdbs) != ds["pdb_elems"][1]:
            why = "a PDB's disruptionsAllowed changed"
        if why is not None:
            self.full_reason = why
        return why is None

    def _bail(self, why: str) -> None:
        self.full_reason = why
        return None

    def _encode_delta(self, ds, pending, existing, pod_groups, mutated_ids):
        """The fast path (reference `:2275`): rewrite only the dirty pod
        slots' rows in the arena, after folding a changed running list.
        Every check comes before the first write to the arena, so a bail
        (None: take the full path) leaves it holding the previous frame."""
        t0 = time.perf_counter()
        prof = self.delta_profile = {}
        if self._ingest_ms:
            prof["ingest"] = self._ingest_ms  # spent in ingest_pod, before this call
            self._ingest_ms = 0.0

        def mark(name):
            nonlocal t0
            t = time.perf_counter()
            prof[name] = prof.get(name, 0.0) + (t - t0) * 1e3
            t0 = t

        dims = ds["dims"]
        P = ds["pads"][2]
        p_real = len(pending)
        if (self.pad_pods or self.hysteresis_pad("P", _pow2_bucket(p_real), p_real)) != P:
            return self._bail(f"{p_real} pending pods move the P pad from {P}")
        if ds["exist_ids"] == (id(existing), len(existing)):
            new_exist = None
        else:
            new_exist = tuple((id(p), nm) for p, nm in existing)
            if new_exist == ds["exist_elems"]:  # the same pods in a new list
                ds["exist_ids"] = (id(existing), len(existing))
                new_exist = None
        ids, rows, refs = ds["pend_ids"], ds["pend_rows"], ds["pend_refs"]
        n_prev = ds["p_real"]
        if n_prev < p_real:
            ids += [0] * (p_real - n_prev)
            rows += [None] * (p_real - n_prev)
            refs += [None] * (p_real - n_prev)
        now = [id(p) for p in pending]
        changed = [i for i in range(p_real) if ids[i] != now[i] or ids[i] in mutated_ids]
        mark("detect")

        rowdata = ds["pod_rowdata"]
        lens0 = self._table_lens()
        staged = self._staged
        new_rows = []
        for i in changed:
            p = pending[i]
            if staged:
                ent = staged.pop(now[i], None)
                if ent is not None and ent[0] is p:
                    self.ingest_hits += 1
            new_rows.append(rowdata(p))
        mark("rows")
        if self._table_lens() != lens0:
            return self._bail("a dirty pod's row grew an interning table")
        flag_aff, flag_tsc, flag_vol, flag_mvol = ds["flags"]
        for d in new_rows:
            if (len(d["lab_k"]) > dims["MPL"] or d["n_aff"] > dims["MA"]
                    or len(d["ports"]) > dims["MPorts"] or len(d["tsc_skew"]) > dims["MC"]
                    or len(d["vol_mode"]) > dims["MVol"] or len(d["reqvec"]) > dims["R"]):
                return self._bail("a dirty pod overflows a sticky pad dim")
            if ((not flag_aff and d["n_aff"] > 0) or (not flag_tsc and len(d["tsc_skew"]))
                    or (not flag_vol and len(d["vol_mode"]))
                    or (not flag_mvol and len(d["vol_mode"]) >= 2)):
                return self._bail("a dirty pod turns a capability flag on")
        port_set = ds["port_set"]
        for i, d in zip(changed, new_rows):
            ids[i], refs[i], rows[i] = now[i], pending[i], d
            if len(d["ports"]):
                port_set.add(i)
            else:
                port_set.discard(i)
        port_set.difference_update(range(p_real, n_prev))
        # the distinct-port axis, re-interned in slot order (the full path's)
        port_slots = sorted(port_set)
        port_tab: dict[int, int] = {}
        port_id_rows = [
            np.array([port_tab.setdefault(int(ep), len(port_tab)) for ep in rows[i]["ports"]],
                     np.int32)
            for i in port_slots
        ]
        if _pad_dim(len(port_tab), 4) > dims["Q"]:
            return self._bail("the distinct host ports outgrow the Q pad")
        mark("ports")

        self._wait_upload()  # the arena is the last upload's source
        fold_ports = False
        if new_exist is not None:
            why = self._try_fold_existing(ds, existing, new_exist)
            if why is not None:
                return self._bail(why)
            fold_ports = ds.pop("fold_port_dirty", False)
            self.fold_hits += 1
            mark("fold")

        # ---- every check passed: write the arena ----
        A = self._arena
        creation = ds["creation"]
        if changed:
            idx = np.asarray(changed, np.int64)
            for name, key, pad in self._PEND_2D:
                _scatter_at(A[name], idx, [d[key] for d in new_rows], pad)
            for name, key, pad in self._PEND_3D:
                _scatter_at(A[name].reshape(P, -1), idx, [d[key] for d in new_rows], pad)
            for name, key in self._PEND_SCALAR:
                A[name][idx] = [d[key] for d in new_rows]
            creation[idx] = [d["creation"] for d in new_rows]
            nidx = ds["node_index"]
            A["pod_node_name"][idx] = [
                nidx.get(pending[i].spec.node_name, -2) if pending[i].spec.node_name else -1
                for i in changed]
            A["pod_nominated"][idx] = [
                nidx.get(pending[i].nominated_node_name, -1)
                if pending[i].nominated_node_name else -1 for i in changed]
        mark("apply")
        if p_real != n_prev:
            A["pod_valid"][:] = False
            A["pod_valid"][:p_real] = True
            if p_real < n_prev:
                self._clear_slots(slice(p_real, n_prev))
                creation[p_real:n_prev] = 0.0
            del ids[p_real:], rows[p_real:], refs[p_real:]
            ds["p_real"] = p_real
            A["num_pending"][...] = p_real
        ppi = A["pod_port_ids"]
        old_ppi = ppi.copy()
        ppi[:] = -1
        if port_slots:
            _scatter_at(ppi, np.asarray(port_slots, np.int64), port_id_rows, -1)
        po = A["pod_order"]
        po[:] = np.iinfo(np.int32).max
        if p_real:
            po[:p_real] = self.queue_sort.rank(pending, A["pod_priority"][:p_real],
                                               creation[:p_real])
        gm = A["group_min_member"]
        gm[:] = 0
        declared = {g.name: g.min_member for g in pod_groups}
        for name, gi in self._group_ids.items():
            gm[gi] = declared.get(name, 0)
        self._cycle_index += 1
        A["cycle_index"][...] = self._cycle_index
        bound = pref_raw_bound(A["pod_pref_aff"], A["pod_pref_aff_w"], A["pod_tsc"],
                               A["exist_pref_aff"], A["exist_pref_aff_w"])
        spec = self._arena_spec = dataclasses.replace(self._arena_spec, aux=tuple(
            (k, bound if k == "pref_raw_bound" else v) for k, v in self._arena_spec.aux))
        mark("order")

        # the rows that changed: the new or mutated pods', the emptied
        # slots', those whose port ids moved; plus, after a fold that moved
        # used ports, every port-bearing slot
        moved = np.zeros(P, bool)
        moved[changed] = True
        moved[p_real:n_prev] = True
        moved |= (old_ppi != ppi).any(axis=1)
        self.last_changed_slots = np.nonzero(moved)[0].astype(np.int32)
        if fold_ports:
            moved[port_slots] = True
        self._sweep_pod_cache(pending, existing)
        return self._emit(spec, np.nonzero(moved)[0].astype(np.int32))

    def _sweep_pod_cache(self, pending, existing) -> None:
        """Drop the cached rows of pods no longer pending, running or staged
        once the cache holds twice the live set (both paths sweep: serving
        takes the delta path almost every frame)."""
        if len(self._pod_cache) > 2 * max(len(pending) + len(existing) + len(self._staged), 1):
            live = ({id(p) for p in pending} | {id(p) for p, _ in existing}
                    | self._staged.keys())
            self._pod_cache = {k: v for k, v in self._pod_cache.items() if k in live}

    def _clear_slots(self, sl) -> None:
        """Reset pending-side arena rows to the full path's pad values (slots
        no pod backs after the pending set shrank)."""
        A = self._arena
        for name, _key, pad in self._PEND_2D + self._PEND_3D:
            A[name][sl] = pad
        for name, pad in self._PEND_SCALAR_PAD.items():
            A[name][sl] = pad

    def _try_fold_existing(self, ds, existing, new) -> str | None:
        """The incremental existing-set fold (reference `:2007`): bring the
        cached stable side and the arena up to date in place when the
        running list changed by a pure append (pods bound since the last
        frame) or a pure tail removal. Returns None on success, else the
        reason for a full encode (which rebuilds the stable side from
        scratch: `_stable_key` still names the old list, so a partly
        updated stable side is discarded). The arena is written last, after
        every check.

        Exactness, as the reference states it: `node_requested` of the
        affected nodes is re-summed from their remaining members in
        ascending slot order (an f32 subtraction is not the inverse of the
        full path's accumulation); their used-port lists are rebuilt member
        ascending; their `node_pods` rows by the full path's lexsort;
        `exist_start` is re-based when the oldest pod changes; `exist_pdb`
        comes from `_pdb_matches` in list order. Unlike the reference's
        (which needs its C++ row writer), the appended rows are written
        from `pod_rowdata`, so every pod the parser covers folds."""
        st = self._stable
        if "exist_creation_abs" not in st:
            return "no stable side to fold into"
        old = ds["exist_elems"]
        n_old, n_new = len(old), len(new)
        if not ((n_new > n_old and new[:n_old] == old)
                or (n_new < n_old and old[:n_new] == new)):
            return "the running list changed other than by an append or a tail removal"
        L = min(n_old, n_new)
        exist_req = st["exist_requested"]
        E = exist_req.shape[0]
        if n_new > E:
            return "the running pods outgrow the E pad"
        exist_node, exist_ports = st["exist_node"], st["exist_ports"]
        exist_group, ca = st["exist_group"], st["exist_creation_abs"]
        affected: set[int] = set()
        port_nodes: set[int] = set()

        if n_new < n_old:  # ---- tail removal ----
            sl = np.arange(L, n_old)
            en = exist_node[sl]
            g = exist_group[sl]
            np.subtract.at(st["group_existing_count"], g[g >= 0], 1)
            affected.update(int(x) for x in en[en >= 0])
            port_nodes.update(int(x) for x in en[(en >= 0) & (exist_ports[sl, 0] >= 0)])
            for name, _key, pad in self._EXIST_ROWS:
                st[name][sl] = pad
            st["exist_priority"][sl] = 0
            st["exist_pdb"][sl] = -1
            st["exist_start"][sl] = 0.0
            st["exist_valid"][sl] = False
            exist_node[sl] = -1
            exist_group[sl] = -1
            ca[sl] = 0.0
            if affected:  # re-summed, never subtracted
                nr = st["node_requested"]
                an = np.fromiter(affected, np.int64)
                nr[an] = 0.0
                en_rem = exist_node[:n_new]
                mem = np.flatnonzero(np.isin(en_rem, an))  # ascending slots
                if mem.size:
                    np.add.at(nr, en_rem[mem], exist_req[mem])
        else:  # ---- pure append ----
            app = existing[L:]
            rowdata = ds["pod_rowdata"]
            lens0 = self._table_lens()
            arows = [rowdata(p) for p, _ in app]
            if self._table_lens() != lens0:
                return "an appended running pod's row grew an interning table"
            dims = ds["dims"]
            flag_aff = ds["flags"][0]
            for d in arows:
                if (len(d["lab_k"]) > dims["MPL"] or d["n_aff"] > dims["MA"]
                        or len(d["ports"]) > exist_ports.shape[1]
                        or len(d["reqvec"]) > dims["R"]):
                    return "an appended running pod overflows a sticky pad dim"
                if not flag_aff and (len(d["anti"]) or len(d["pref"])):
                    return "an appended running pod turns inter-pod affinity on"
            slots = np.arange(L, n_new, dtype=np.int64)
            for name, key, pad in self._EXIST_ROWS:
                _scatter_at(st[name].reshape(E, -1), slots, [d[key] for d in arows], pad)
            st["exist_priority"][slots] = [d["prio"] for d in arows]
            exist_group[slots] = [d["gid"] for d in arows]
            ca[slots] = [d["creation"] for d in arows]
            nidx = ds["node_index"]
            en_new = np.array([nidx.get(nm, -1) for _, nm in app], np.int32)
            exist_node[slots] = en_new
            st["exist_valid"][slots] = True
            m = en_new >= 0
            np.add.at(st["node_requested"], en_new[m], exist_req[slots][m])
            g = exist_group[slots]
            np.add.at(st["group_existing_count"], g[g >= 0], 1)
            affected.update(int(x) for x in en_new[m])
            port_nodes.update(int(x) for x in en_new[m & (exist_ports[slots, 0] >= 0)])
            pdbs = st["__refs"][5]
            if pdbs:
                for j, (p, _nm) in enumerate(app):
                    row, b = st["exist_pdb"][L + j], 0
                    for gi, pdb in enumerate(pdbs):
                        if b >= MB:
                            break
                        if _pdb_matches(pdb, p):
                            row[b] = gi
                            b += 1

        en_all = exist_node[:n_new]
        # used-port lists of the affected nodes, member slots ascending
        if port_nodes:
            if len(port_nodes) > 256:
                return "more than 256 nodes' used ports moved"
            nup = st["node_used_ports"]
            for n in port_nodes:
                ports = [int(x) for s in np.flatnonzero(en_all == n)
                         for x in exist_ports[s] if x >= 0]
                if len(ports) > nup.shape[1]:
                    return "a node's used ports outgrow the MUP pad"
                nup[n] = -1
                nup[n, :len(ports)] = ports
        # victim-table rows of the affected nodes, the full path's lexsort
        if affected:
            npods = st["node_pods"]
            an = np.fromiter(affected, np.int64)
            e_ids = np.flatnonzero(np.isin(en_all, an))
            npods[an] = -1
            if e_ids.size:
                order_v = np.lexsort((-e_ids, st["exist_priority"][e_ids], en_all[e_ids]))
                se = e_ids[order_v].astype(np.int32)
                sn = en_all[se]
                starts = np.r_[True, sn[1:] != sn[:-1]]
                col = np.arange(sn.size) - np.maximum.accumulate(
                    np.where(starts, np.arange(sn.size), 0))
                if int(col.max()) >= npods.shape[1]:
                    return "a node's running pods outgrow the MPN pad"
                npods[sn, col] = se
        # start times, re-based when the oldest pod changed
        base = float(ca[:n_new].min()) if n_new else 0.0
        if base != st["start_base"]:
            st["exist_start"][:n_new] = (ca[:n_new] - base).astype(np.float32)
            st["start_base"] = base
        elif n_new > n_old:
            st["exist_start"][L:n_new] = (ca[L:n_new] - base).astype(np.float32)
        st["e_real"] = n_new

        # ---- mirror into the arena ----
        A = self._arena
        rng = slice(L, max(n_old, n_new))
        for name in ([n for n, _k, _p in self._EXIST_ROWS]
                     + ["exist_node", "exist_priority", "exist_pdb", "exist_valid"]):
            A[name][rng] = st[name][rng]
        for name in ("exist_start", "node_requested", "node_pods", "node_used_ports",
                     "group_existing_count"):
            A[name][...] = st[name]
        A["num_existing"][...] = n_new

        # ---- identity bookkeeping ----
        refs = st["__refs"]
        st["__refs"] = (refs[0], [p for p, _ in existing]) + tuple(refs[2:])
        k = self._stable_key
        self._stable_key = (k[0], new) + k[2:]
        ds["exist_ids"] = (id(existing), len(existing))
        ds["exist_elems"] = new
        if port_nodes:  # NodePorts' static rows read node_used_ports
            ds["fold_port_dirty"] = True
        return None

    def _wait_upload(self) -> None:
        if self._upload_done is not None:
            self._upload_done[1].synchronize()

    def _install_arena(self, fields, spec) -> None:
        """Write every field into the arena (reference `_install_arena`,
        `:2532`), allocating it anew when the pack layout changed: on the
        card pinned host memory, the upload's source; fields start on
        16-byte boundaries (`PackSpec`), the bytes between them are 0."""
        from . import packing

        self._wait_upload()
        if self._arena_spec is None or self._arena_spec.layout_key() != spec.layout_key():
            pin = self.device.type == "cuda"
            hw = torch.zeros(spec.n_words, dtype=torch.int32, pin_memory=pin)
            hb = torch.zeros(spec.n_bytes, dtype=torch.uint8, pin_memory=pin)
            w, b = hw.numpy(), hb.numpy()
            views = {}
            for name, dt, shape, off in spec.words:
                n = packing._size(shape)
                views[name] = w[off:off + n].view(np.dtype(dt)).reshape(shape)
            for name, shape, off in spec.bools:
                n = packing._size(shape)
                views[name] = b[off:off + n].view(np.bool_).reshape(shape)
            self._host, self._arena = (hw, hb), views
        for name, v in self._arena.items():
            v[...] = fields[name]
        self._arena_spec = spec
        self._arena_synced = True

    def _emit(self, spec, dirty) -> EncodedFrame:
        """The frame of the arena's current contents: on the card fresh
        device buffers, one asynchronous copy each from the pinned arena
        (the next write to the arena waits for them); on the CPU copies."""
        from . import packing

        hw, hb = self._host
        if self.device.type == "cuda":
            wbuf = torch.empty(spec.n_words, dtype=torch.int32, device=self.device)
            bbuf = torch.empty(spec.n_bytes, dtype=torch.uint8, device=self.device)
            self._upload_done = (torch.cuda.Event(enable_timing=True),
                                 torch.cuda.Event(enable_timing=True))
            self._upload_done[0].record()
            wbuf.copy_(hw, non_blocking=True)
            bbuf.copy_(hb, non_blocking=True)
            self._upload_done[1].record()
        else:
            wbuf, bbuf = hw.clone(), hb.clone()
        return EncodedFrame(wbuf, bbuf, spec, packing.unpack(wbuf, bbuf, spec), dirty)

    def host_buffers(self) -> tuple[np.ndarray, np.ndarray]:
        """The arena's (u32 words, u8 bytes): the last frame's host buffers,
        valid until the next encode call writes them."""
        hw, hb = self._host
        return hw.numpy().view(np.uint32), hb.numpy()

    def last_upload_ms(self) -> float | None:
        """Device ms of the last frame's two copies (CUDA events around
        them; None off the card). Waits for them."""
        if self._upload_done is None:
            return None
        self._upload_done[1].synchronize()
        return self._upload_done[0].elapsed_time(self._upload_done[1])

    def encode_numpy(
        self,
        nodes: Sequence[Node],
        pending: Sequence[Pod],
        existing: Sequence[tuple[Pod, str]] = (),
        pod_groups: Sequence[api.PodGroup] = (),
        *,
        pvcs: Sequence[api.PersistentVolumeClaim] = (),
        pvs: Sequence[api.PersistentVolume] = (),
        storage_classes: Sequence[api.StorageClass] = (),
        pdbs: Sequence[api.PodDisruptionBudget] = (),
    ) -> tuple[dict[str, np.ndarray], dict[str, Any]]:
        """The host half of `encode`: (array fields, aux fields) as numpy."""
        S = self.strings
        rn = self.resource_names

        n_real, p_real, e_real = len(nodes), len(pending), len(existing)
        self._cycle_index += 1
        N = self.pad_nodes or self.hysteresis_pad("N", _pow2_bucket(n_real), n_real)
        P = self.pad_pods or self.hysteresis_pad("P", _pow2_bucket(p_real), p_real)
        # E is sticky (a fold appends in place), pad_existing folded into
        # its bucket so a grown e_real never needs a larger one
        E = self._stick(
            "E",
            _pow2_bucket(max(e_real, self.pad_existing or 0))
            if (e_real or self.pad_existing) else 8,
        )

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

        # ---- volumes (VolumeBinding inputs) ----
        pvc_map = {c.key: c for c in pvcs}
        pv_map = {v.name: v for v in pvs}
        class_map = {s.name: s for s in storage_classes}
        vol_sig = (
            tuple(sorted(
                (c.key, c.volume_name, c.storage_class, c.request)
                for c in pvcs
            )),
            tuple(sorted(
                (v.name, v.claim_ref, v.storage_class, v.capacity,
                 v.node_affinity)
                for v in pvs
            )),
            tuple(sorted(
                (s.name, s.volume_binding_mode, s.provisioner,
                 s.allowed_topologies)
                for s in storage_classes
            )),
        )
        if vol_sig != self._vol_sig:
            self._vol_sig = vol_sig
            self._vol_epoch += 1
        vol_epoch = self._vol_epoch

        def compile_pod_vols(p: Pod) -> tuple[list, bool]:
            """((mode, req_id, class_id, size) per mounted PVC, uses_fields):
            mode 0 bound (req_id = the PV's nodeAffinity), 1 unbound
            WaitForFirstConsumer (req_id = the class's allowedTopologies, -1
            any node, -2 no provisioner), 2 unschedulable (missing PVC or PV,
            unbound Immediate claim). uses_fields marks requirements that
            bake node indices in (matchFields)."""
            rows: list[tuple[int, int, int, float]] = []
            uses_fields = False
            for claim in p.spec.volumes:
                pvc = pvc_map.get(f"{p.namespace}/{claim}")
                if pvc is None:  # missing PVC: UnschedulableAndUnresolvable
                    rows.append((2, -1, -1, 0.0))
                    continue
                if pvc.volume_name:
                    pv = pv_map.get(pvc.volume_name)
                    if pv is None:
                        rows.append((2, -1, -1, 0.0))
                        continue
                    rid = (
                        compile_node_affinity_required(pv.node_affinity)
                        if pv.node_affinity else -1
                    )
                    uses_fields |= any(t.match_fields for t in pv.node_affinity)
                    rows.append((0, rid, -1, 0.0))
                    continue
                cls = class_map.get(pvc.storage_class)
                if cls is None or (
                    cls.volume_binding_mode != api.VOLUME_BINDING_WAIT
                ):
                    # unbound Immediate-mode PVC: the volume binder owns it
                    rows.append((2, -1, -1, 0.0))
                    continue
                if cls.provisioner:
                    dyn = (
                        compile_node_affinity_required(cls.allowed_topologies)
                        if cls.allowed_topologies else -1
                    )
                    uses_fields |= any(
                        t.match_fields for t in cls.allowed_topologies
                    )
                else:
                    dyn = -2
                rows.append(
                    (1, dyn, S.intern(pvc.storage_class), float(pvc.request))
                )
            return rows, uses_fields

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
                if (
                    data["epoch"] is None or data["epoch"] == self._node_epoch
                ) and (
                    data["vol_epoch"] is None or data["vol_epoch"] == vol_epoch
                ):
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
            # after the ports and before the tolerations: the reference's
            # interning order
            vols, vol_fields = compile_pod_vols(p)
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
                "vol_mode": _i32([m for m, _, _, _ in vols]),
                "vol_req": _i32([r for _, r, _, _ in vols]),
                "vol_cls": _i32([c for _, _, c, _ in vols]),
                "vol_size": _f32([z for _, _, _, z in vols]),
                "vol_epoch": vol_epoch if p.spec.volumes else None,
                "epoch": (
                    self._node_epoch if (uses_fields or vol_fields) else None
                ),
            }
            self._pod_cache[id(p)] = (p, data)
            return data

        pend_rows = [pod_rowdata(p) for p in pending]
        exist_rows = [pod_rowdata(p) for p, _ in existing]
        all_rows = pend_rows + exist_rows

        # mark-and-sweep the caches against the live object set
        self._sweep_pod_cache(pending, existing)
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
            "MA", _pad_dim(max([d["n_aff"] for d in all_rows] + [1, self.pad_ma or 0]), 2)
        )

        # ---- stable-side cache: everything derived from nodes/existing
        # alone, keyed on object identities plus every grow-only
        # interning dimension the arrays bake in ----
        def table_dims() -> tuple:
            return (len(exprs_t.rows), len(reqs_t.rows), len(prefs_t.rows),
                    len(tols_t.rows), len(taints_t.rows), len(sels_t.rows),
                    len(imgsets_t.rows), len(image_ids), len(group_ids),
                    len(topo_keys))

        stable_key = (
            tuple(id(nd) for nd in nodes),
            tuple((id(p), nm) for p, nm in existing),
            vol_sig,
            tuple((id(b), b.disruptions_allowed) for b in pdbs),
            self._node_epoch, N, E, R, MPL, MA,
        ) + table_dims()
        if self._stable_key == stable_key:
            st = self._stable
        else:
            st = self._build_stable(
                nodes, existing, pdbs, node_rows, exist_rows, node_index,
                n_real, e_real, N, E, R, MPL, MA,
                pv_tables=self._pv_tables(pvs, pvcs,
                                          compile_node_affinity_required),
            )
            # strong refs keep cached id()s from being reused
            st["__refs"] = (list(nodes), [p for p, _ in existing], list(pvs),
                            list(pvcs), list(storage_classes), list(pdbs))
            # keyed on the tables as built: the PV table interns its
            # requirements on the way (the reference keys on the dims
            # before, so its next full encode rebuilds the stable side once
            # and moves the carry key where volumes exist)
            stable_key = stable_key[:10] + table_dims()
            self._stable_key = stable_key
            self._stable = st
        # the reference's carry key: the carried [P, N] static base and
        # [S, P] matched-pending depend on pod rows x node tables x volumes
        # x interning dims, not on the existing-pod set or PDBs (the one
        # existing coupling, NodePorts' used ports, is repaired by marking
        # port-bearing pending slots dirty; `encode_packed`)
        self._carry_key = (stable_key[0], stable_key[2]) + stable_key[4:]

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
            _pad_dim(max([len(d["tsc_skew"]) for d in pend_rows] + [1, self.pad_mc or 0]), 2),
        )
        pod_tsc = np.full((P, MC, 3), -1, np.int32)
        pod_tsc_skew = np.zeros((P, MC), np.int32)

        MVol = self._stick(
            "MVol",
            _pad_dim(max([len(d["vol_mode"]) for d in pend_rows] + [1]), 2),
        )
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
        _scatter_rows(pod_vol_mode, [d["vol_mode"] for d in pend_rows])
        _scatter_rows(pod_vol_req, [d["vol_req"] for d in pend_rows])
        _scatter_rows(pod_vol_class, [d["vol_cls"] for d in pend_rows])
        _scatter_rows(pod_vol_size, [d["vol_size"] for d in pend_rows])
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

        # the queue rank, by the profile's queueSort plugin
        pod_order = np.full(P, np.iinfo(np.int32).max, np.int32)
        creation = np.zeros(P, np.float64)
        if p_real:
            creation[:p_real] = [d["creation"] for d in pend_rows]
            pod_order[:p_real] = self.queue_sort.rank(pending, pod_prio[:p_real],
                                                      creation[:p_real])

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
            "has_volumes": self._stick_flag(
                "vol", bool((pod_vol_mode >= 0).any())
            ),
            "has_multi_volume": self._stick_flag(
                "mvol", bool(((pod_vol_mode >= 0).sum(axis=1) >= 2).any())
            ),
        }

        # ---- what the delta path needs (reference `:1717-1765`); the
        # pod_rowdata closure stays valid while the stable side is
        # unchanged, which the delta path's identity checks and
        # `_table_lens` cover ----
        self._delta_state = {
            "pod_rowdata": pod_rowdata,
            "node_index": node_index,
            "pend_ids": [id(p) for p in pending],
            "pend_refs": list(pending),
            "pend_rows": list(pend_rows),
            # port-bearing slots, kept up to date by the delta path
            "port_set": {i for i, d in enumerate(pend_rows) if len(d["ports"])},
            "creation": creation,
            "p_real": p_real,
            "dims": {"R": R, "MPL": MPL, "MA": MA, "MPorts": MPorts, "MC": MC,
                     "MVol": MVol, "Q": aux["num_distinct_ports"]},
            "pads": (self.pad_pods, self.pad_nodes, P),
            "nodes_ids": (id(nodes), len(nodes)),
            "nodes_elems": tuple(id(nd) for nd in nodes),
            "exist_ids": (id(existing), len(existing)),
            "exist_elems": stable_key[1],
            "vol_ids": (id(pvcs), len(pvcs), id(pvs), len(pvs),
                        id(storage_classes), len(storage_classes)),
            "vol_elems": (tuple(id(c) for c in pvcs), tuple(id(v) for v in pvs),
                          tuple(id(c) for c in storage_classes)),
            "pdb_ids": (id(pdbs), len(pdbs)),
            "pdb_elems": (tuple(id(b) for b in pdbs),
                          tuple(b.disruptions_allowed for b in pdbs)),
            "flags": (aux["has_inter_pod_affinity"], aux["has_topology_spread"],
                      aux["has_volumes"], aux["has_multi_volume"]),
        }
        # a direct encode() leaves the arena behind: the next packed frame
        # takes the full path
        self._arena_synced = False
        return fields, aux

    def _pv_tables(self, pvs, pvcs, compile_node_affinity_required) -> dict:
        """The PV table [V] (V bucket 4): nodeAffinity requirement (-1 any
        node), interned class, capacity, and availability (no claimRef and
        no PVC names it)."""
        S = self.strings
        V = _pad_dim(len(pvs), 4)
        pv_req = np.full(V, -1, np.int32)
        pv_class = np.full(V, -1, np.int32)
        pv_cap = np.zeros(V, np.float32)
        pv_avail = np.zeros(V, bool)
        claimed_pvs = {c.volume_name for c in pvcs if c.volume_name}
        for i, pv in enumerate(pvs):
            pv_req[i] = (
                compile_node_affinity_required(pv.node_affinity)
                if pv.node_affinity else -1
            )
            pv_class[i] = S.intern(pv.storage_class)
            pv_cap[i] = pv.capacity
            pv_avail[i] = not pv.claim_ref and pv.name not in claimed_pvs
        return {"pv_req_id": pv_req, "pv_class": pv_class,
                "pv_capacity": pv_cap, "pv_avail": pv_avail}

    def _build_stable(
        self, nodes, existing, pdbs, node_rows, exist_rows, node_index,
        n_real, e_real, N, E, R, MPL, MA, pv_tables,
    ) -> dict:
        """The stable (node/existing/table) side of the snapshot; the PV
        table is compiled before it (`_pv_tables`) because it interns into
        the requirement tables finalised here."""
        S = self.strings
        st: dict[str, Any] = dict(pv_tables)

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

        st["pdb_allowed"], st["exist_pdb"] = _pdb_tables(pdbs, existing, E)

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
        # absolute creation times (f64) let a fold re-base exist_start exactly
        exist_creation_abs = np.zeros(E, np.float64)
        exist_creation_abs[:e_real] = [d["creation"] for d in exist_rows]
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
            # pad_pods_per_node folds into the bucket, as E's pad
            MPN = self._stick(
                "MPN", _pad_dim(max(int(col.max()) + 1, self.pad_pods_per_node or 0), 8))
            node_pods = np.full((N, MPN), -1, np.int32)
            node_pods[sn, col] = se
        else:
            MPN = self._stick("MPN", _pad_dim(max(1, self.pad_pods_per_node or 0), 8))
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
            # what an existing-set fold reads (_try_fold_existing)
            exist_group=exist_group, exist_creation_abs=exist_creation_abs,
            start_base=start_base, e_real=e_real,
        )
        return st
