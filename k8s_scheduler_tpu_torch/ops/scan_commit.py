"""K13 `scan_commit`: the scan engine's whole sequential commit in one
launch.

Reference: `k8s_scheduler_tpu/ops/commit.py:63 greedy_commit` (a
`lax.scan` over the priority-ordered pending set) with the default plugin
set's per-pod hooks (`framework/plugins.py`, `ops/interpod.py:151-315`,
`ops/resources.py`, VolumeBinding's `ops/volumes.py:242 / :400 / :567`).

`scan_commit_inputs` packs the operands once per cycle: the static base
from K1, the rank order, the per-pod terms, the running state (requested
resources, the host-port bitmap, the affinity state) and two short lists
the kernel walks instead of dense tables — each pod's matched selectors
(from `matched_pending` [S, P]) and each topology key's domains that hold
a node. `scan_commit_plain` runs the same contract through
`commit.greedy_commit` with the framework's per-pod hooks;
`scan_commit_cuda` launches csrc/scan_commit.cu: one thread-block cluster
(16 CTAs where the card can schedule them, else the portable 8) runs
every step, each CTA over its own slice of the nodes with the slice's
state in shared memory and a replica of the affinity counts; the CTAs
agree on each step's first-index argmax through records sent to every
CTA with st.async and awaited on an mbarrier (a cluster barrier only for
the normalisation maxima of a pod whose raw affinity or spread score can
be nonzero). The wrapper packs each pod's operands into one row
(`pod_rows`) and the valid pods' rank order (`valid_order`);
`launch_shape` gives a launch's slices and shared memory without a card.
`scan_commit` picks the kernel for CUDA tensors and the plain version for
CPU ones. Latency-bound on an H100: P dependent steps.

VolumeBinding (`F_VOLUMES`, where its claim bitmap is in the plugins'
state: a snapshot with volumes and static PVs) runs in the same launch,
in the kernel's instance with the volume path compiled in: each CTA keeps
a replica of the claim bitmap in shared memory (ceil(V / 32) words); a
pod with an unbound slot (`POD_VOL`) tests each node against it by
walking the node's PV list and the global one (`volumes.VolumeTables`),
with Hall's condition over the subset masks for a multi-volume pod; after
the exchange every CTA makes the winner's claims in its own replica the
same way (the slots in index order, the SDR-safe choice of
csrc/pv_common.cuh), and CTA 0 writes the bitmap out (`pv_claimed`).

The full outputs (`scan_commit_inputs(..., rejects=True)`) add the
reference's per-step reject attribution (`ops/commit.py:60`, `:84`,
`:114-117` over `framework/runtime.py:139 Framework.dyn`): i32 [P, F], row p
the nodes of p's static row that each dynamic filter (NodePorts,
NodeResourcesFit, InterPodAffinity, PodTopologySpread, at their columns in
the framework's order) rejects first at p's step. The kernel's instance
for them walks every rank, an invalid pod's step counting against the
state of its rank without an exchange or a commit; each CTA counts its
slice's nodes per part and adds them with one integer atomic a part, off
the step's exchange."""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any

import numpy as np
import torch

from ..framework.plugins import _score_resource_weights
from ..models.encoding import WHEN_DO_NOT_SCHEDULE, WHEN_SCHEDULE_ANYWAY
from . import interpod as ip
from . import volume_mask as vm
from . import volumes
from .commit import CommitResult, greedy_commit
from .dyn_round import balanced_is_constant, one_resource_fit
from .kernel_build import (checked, count_launch, load_cuda_library, raise_on_error,
                           stream_of)
from .resources import MAX_NODE_SCORE, _reciprocal, fit_slack
from .static_base import _overrides

NEG_INF = -1e9
EXACT_F32 = 2**24  # integer-valued f32 sums are exact below this
# csrc/scan_commit.cu limits (kMax*)
MAX_RESOURCES, MAX_PORTS, MAX_TERMS, MAX_CONSTRAINTS, MAX_KEYS = 8, 8, 8, 8, 8
# the launch: CTAs of THREADS threads, at most NODES_A_THREAD nodes a thread
# (kThreads, kPer), a cluster of CLUSTER CTAs where the card can schedule
# it, else CLUSTER_PORTABLE; so at most 1024 nodes a CTA
THREADS, NODES_A_THREAD = 512, 2
CLUSTER, CLUSTER_PORTABLE = 16, 8
MAX_NODES = CLUSTER * THREADS * NODES_A_THREAD  # 16384
MAX_NODES_PORTABLE = CLUSTER_PORTABLE * THREADS * NODES_A_THREAD  # 8192
SMEM_LIMIT = 232448  # shared memory bytes a CTA can use (227 KB)
MAX_SUBSETS = 64  # csrc/pv_common.cuh kMaxSub: a pod's slot subsets
POD_SELS = 8  # matched selectors carried in a pod row (kPodSels)
REC_BYTES, WARPS = 48, THREADS // 32  # sizeof(Rec), kWarps
# pod flags (kPod*); POD_VOL: an unbound volume slot (the volume instance)
POD_HARD, POD_AFF_NORM, POD_SPR_NORM, POD_INVALID, POD_VOL = 1, 2, 4, 8, 16
# the full mode's dynamic parts, in csrc/scan_commit.cu's fail-bit order
REJECT_PARTS = ("NodePorts", "NodeResourcesFit", "InterPodAffinity", "PodTopologySpread",
                "VolumeBinding")
# a pod row's fields; the last five (its volume slots: mode, requirement id,
# class, size as f32 bits, and per anchor slot the bits of the slots in its
# dominance group) are MVol wide in the volume instance, else empty
_ROW_FIELDS = ("req", "ports", "aff", "self", "anti", "pref", "prefw", "tsc", "skew",
               "sels", "sel0", "nsel", "nom", "nomdom", "flags", "p",
               "vmode", "vrid", "vcls", "vsize", "vmem")
_SMEM_FIELDS = ("slot3", "slot2", "wbest", "wred", "smin", "dptr", "rows", "mbar", "total",
                "alloc", "slack", "nreq", "ndom", "pbits", "cbits", "vsub", "wcnt")

# flag bits and score-term codes (csrc/scan_commit.cu mirrors these)
F_PORTS, F_FIT, F_AFFINITY, F_SPREAD, F_PORT_STATE, F_STATE, F_TABLES, F_MOST = (
    1, 2, 4, 8, 16, 32, 64, 128
)
# the fit weights are all 1 (the sum adds rounded products); every resource
# is BalancedAllocation's (its variance sum fuses the squares); VolumeBinding's
# per-pod hooks (the claim bitmap in the plugins' state)
F_FIT_ONES, F_BAL_ALL, F_VOLUMES = 256, 512, 1024
# T_CONST: BalancedAllocation over one resource, the constant 100 * w its
# weight holds (the reference folds it: ROADMAP C7)
T_FIT, T_BALANCED, T_AFFINITY, T_SPREAD, T_CONST = 1, 2, 3, 4, 5

# the plugins whose per-pod hooks the kernel implements
_COVERED = ("NodePorts", "NodeResourcesFit", "NodeResourcesBalancedAllocation",
            "InterPodAffinity", "PodTopologySpread", "VolumeBinding")
_PER_POD_HOOKS = ("dyn_mask", "dyn_score", "extra_update")


@dataclasses.dataclass
class ScanInputs:
    """Everything one scan commit reads. The tensors are the kernel's
    operands; `fw`, `ctx` and `extra` let the plain version run the
    framework's own hooks on the same cycle."""

    fw: Any
    ctx: Any
    extra: dict  # the framework's initial extra state
    flags: int
    # (term code, weight; T_CONST: 100 * w), score order
    terms: tuple[tuple[int, float], ...]
    fit_w100: tuple[float, ...]  # [R] f32(w) * f32(100) of the fit score
    fit_rwsum: float  # f32(1 / weight sum) of the fit score
    bal_cols: tuple[bool, ...]  # [R] resources BalancedAllocation averages
    bal_rn: float  # f32(1 / their count)
    sbase: torch.Tensor  # f32 [P, N] static base (K1)
    order: torch.Tensor  # i32 [P] pod at each rank
    pod_valid: torch.Tensor  # bool [P]
    pod_nominated: torch.Tensor  # i32 [P]
    pod_requested: torch.Tensor  # f32 [P, R]
    node_allocatable: torch.Tensor  # f32 [N, R]
    node_requested: torch.Tensor  # f32 [N, R] at cycle start
    slack: torch.Tensor  # f32 [N, R] fit slack
    pod_port_ids: torch.Tensor  # i32 [P, MP]
    ports: torch.Tensor  # bool [N, Q] host ports claimed this cycle
    state: ip.AffinityState  # counts [S, D], total [S], anti [S, N], pref [S, N]
    aff_terms: torch.Tensor  # i32 [P, MA, 2] (selector, key)
    aff_self: torch.Tensor  # bool [P, MA] the pod matches the term's selector
    anti_terms: torch.Tensor  # i32 [P, MA, 2]
    pref_terms: torch.Tensor  # i32 [P, MA, 2]
    pref_w: torch.Tensor  # f32 [P, MA]
    tsc: torch.Tensor  # i32 [P, MC, 3] (key, selector, when)
    tsc_skew: torch.Tensor  # i32 [P, MC]
    node_domains: torch.Tensor  # i32 [N, K]
    dom_ptr: torch.Tensor  # i32 [K + 1] CSR of each key's domains with a node
    dom_list: torch.Tensor  # i32 [nd]
    sel_ptr: torch.Tensor  # i32 [P + 1] CSR of each pod's matched selectors
    sel_list: torch.Tensor  # i32 [nnz]
    # the full outputs: each REJECT_PARTS entry's column (its filter's
    # index, -1 where the framework has no such filter) of n_filters; None
    # for the latency outputs
    reject_cols: tuple[int, ...] | None = None
    n_filters: int = 0
    # VolumeBinding (F_VOLUMES; None without it): the PV lists and
    # requirement rows, the PVs' class and capacity, the claim bitmap at
    # cycle start, the pods' volume slots, and per pod and anchor slot the
    # bits of its dominance group (multi-volume above 6 slots, else 0)
    vol_tables: volumes.VolumeTables | None = None
    pv_class: torch.Tensor | None = None  # i32 [V]
    pv_cap: torch.Tensor | None = None  # f32 [V]
    pv_claimed: torch.Tensor | None = None  # bool [V]
    vol_mode: torch.Tensor | None = None  # i32 [P, MVol]
    vol_req: torch.Tensor | None = None  # i32 [P, MVol]
    vol_class: torch.Tensor | None = None  # i32 [P, MVol]
    vol_size: torch.Tensor | None = None  # f32 [P, MVol]
    vol_member: torch.Tensor | None = None  # i32 [P, MVol]
    vol_multi: bool = False  # MVol >= 2 and a multi-volume pod: Hall's condition

    @property
    def full(self) -> bool:
        return self.reject_cols is not None

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.sbase.shape)

    @property
    def vol(self) -> tuple[int, int, int]:
        """(V, MVol, subset masks) of the volume instance; zeros without
        it."""
        if not self.flags & F_VOLUMES:
            return 0, 0, 0
        MVol = self.vol_mode.shape[1]
        return (self.pv_class.shape[0], MVol,
                MVol + (len(volumes._hall_subsets(MVol)) if self.vol_multi else 0))


@dataclasses.dataclass
class ScanResult:
    assignment: torch.Tensor  # i32 [P] node or -1
    node_requested: torch.Tensor  # f32 [N, R] after the commit
    ports: torch.Tensor  # bool [N, Q]
    state: ip.AffinityState  # the affinity state after the commit
    rejects: torch.Tensor | None = None  # i32 [P, F] (the full outputs)
    pv_claimed: torch.Tensor | None = None  # bool [V] (VolumeBinding's claims)


def _csr(rows: torch.Tensor, cols: torch.Tensor, n_rows: int):
    """(ptr i32 [n_rows + 1], cols i32) of (row, col) pairs sorted by row."""
    counts = torch.bincount(rows, minlength=n_rows)
    ptr_ = torch.zeros(n_rows + 1, dtype=torch.int64, device=rows.device)
    ptr_[1:] = torch.cumsum(counts, 0)
    return ptr_.to(torch.int32), cols.to(torch.int32).contiguous()


def scan_commit_inputs(fw, ctx, sbase: torch.Tensor, extra: dict,
                       rejects: bool = False) -> ScanInputs:
    """Pack one cycle's scan operands. `sbase` is K1's static base (fit
    against the cycle-start state folded in for the latency outputs:
    node_requested only grows during the scan, so that is the dynamic fit
    test's first step; without it for the full outputs, whose attribution
    counts those nodes under NodeResourcesFit at every step); `extra` is
    `fw.extra_init(ctx)`; `rejects` asks for the full outputs' per-step
    attribution. A plugin with per-pod hooks that the kernel does not
    implement raises NotImplementedError."""
    snap = ctx.snap
    dev = snap.device
    P, N = snap.P, snap.N
    for pl in fw.filters + [s for s, _ in fw.scores]:
        if pl.name not in _COVERED and any(_overrides(pl, h) for h in _PER_POD_HOOKS):
            raise NotImplementedError(
                f"plugin {pl.name!r}: its per-pod hooks are not in scan_commit")
    names = {f.name for f in fw.filters}
    flags = 0
    if "NodePorts" in names:
        flags |= F_PORTS
    if "NodeResourcesFit" in names:
        flags |= F_FIT
    if "InterPodAffinity" in names and snap.has_inter_pod_affinity:
        flags |= F_AFFINITY
    if "PodTopologySpread" in names and snap.has_topology_spread:
        flags |= F_SPREAD
    if "NodePorts" in extra:
        flags |= F_PORT_STATE
    state = next((v for v in extra.values() if isinstance(v, ip.AffinityState)), None)
    if state is not None:
        flags |= F_STATE
        if snap.has_inter_pod_affinity:
            flags |= F_TABLES
    R = snap.node_allocatable.shape[1]
    terms, fit_w100, fit_rwsum, bal_cols = [], [0.0] * R, 1.0, [False] * R
    folded = R == 1 and any(s.name == "NodeResourcesBalancedAllocation"
                            for s, _ in fw.scores)
    for s, w in fw.scores:
        if s.name == "NodeResourcesFit":
            wr = _score_resource_weights(snap, s.args)
            if s.args.get("scoring_strategy", "LeastAllocated") == "MostAllocated":
                flags |= F_MOST
            if one_resource_fit(snap.node_allocatable, wr):
                # commit.OneResourceFit: the fraction times 100 * w, a
                # product beside the folded BalancedAllocation, else
                # rounded (bare)
                c = float(np.float32(MAX_NODE_SCORE) * np.float32(w))
                fit_w100 = [1.0] if folded else [c]
                terms.append((T_FIT, c if folded else 1.0))
            else:
                fit_w100 = [float(np.float32(v) * np.float32(MAX_NODE_SCORE)) for v in wr]
                fit_rwsum = _reciprocal(max(float(np.float32(sum(wr))), 1e-9))
                if all(v == 1.0 for v in wr):
                    flags |= F_FIT_ONES
                terms.append((T_FIT, float(w)))
        elif (s.name == "NodeResourcesBalancedAllocation"
              and balanced_is_constant(snap.node_allocatable)):
            terms.append((T_CONST, float(np.float32(MAX_NODE_SCORE) * np.float32(w))))
        elif s.name == "NodeResourcesBalancedAllocation":
            bal_cols = [v > 0 for v in _score_resource_weights(snap, s.args)]
            if all(bal_cols):
                flags |= F_BAL_ALL
            terms.append((T_BALANCED, float(w)))
        elif s.name == "InterPodAffinity" and snap.has_inter_pod_affinity:
            terms.append((T_AFFINITY, float(w)))
        elif s.name == "PodTopologySpread" and snap.has_topology_spread:
            terms.append((T_SPREAD, float(w)))

    i32 = torch.int32
    if state is None:  # nothing reads the tables; keep every operand well-formed
        S, D = 1, max(int(snap.domain_key.shape[0]), 1)
        state = ip.AffinityState(
            torch.zeros((S, D), device=dev), torch.zeros((S,), device=dev),
            torch.zeros((S, N), dtype=torch.bool, device=dev),
            torch.zeros((S, N), device=dev))
        mp = torch.zeros((S, P), dtype=torch.bool, device=dev)
    else:
        mp = ctx.matched_pending
    S = state.counts.shape[0]
    pods, sels = torch.nonzero(mp.T, as_tuple=True)  # sorted by pod, then selector
    sel_ptr, sel_list = _csr(pods, sels, P)
    K = snap.node_domains.shape[1]
    elig = torch.nonzero(snap.domain_node_count > 0, as_tuple=True)[0]
    keys = snap.domain_key[elig].long()
    in_range = (keys >= 0) & (keys < K)
    keys, elig = keys[in_range], elig[in_range]
    by_key = torch.argsort(keys, stable=True)
    dom_ptr, dom_list = _csr(keys[by_key], elig[by_key], K)
    aff = snap.pod_aff_terms
    pid = torch.arange(P, device=dev)[:, None]
    aff_self = (aff[..., 0] >= 0) & mp[aff[..., 0].clamp(0, S - 1).long(), pid]
    ports = extra.get("NodePorts")
    if ports is None:
        ports = torch.zeros((N, max(int(snap.num_distinct_ports), 1)),
                            dtype=torch.bool, device=dev)
    vol = {}
    if "VolumeBinding" in names and "VolumeBinding" in extra:
        flags |= F_VOLUMES
        multi = volumes._multi(snap)
        MVol = snap.pod_vol_mode.shape[1]
        member = torch.zeros((P, MVol), dtype=i32, device=dev)
        if multi and MVol > 6:
            bits = 1 << torch.arange(MVol, dtype=i32, device=dev)
            member = (vm._membership_table(snap).to(i32) * bits).sum(2, dtype=i32)
        vol = dict(vol_tables=ctx.volume_tables, pv_class=snap.pv_class,
                   pv_cap=snap.pv_capacity, pv_claimed=extra["VolumeBinding"],
                   vol_mode=snap.pod_vol_mode, vol_req=snap.pod_vol_req,
                   vol_class=snap.pod_vol_class, vol_size=snap.pod_vol_size,
                   vol_member=member, vol_multi=multi)
    return ScanInputs(
        fw=fw, ctx=ctx, extra=extra, flags=flags, terms=tuple(terms),
        fit_w100=tuple(fit_w100), fit_rwsum=fit_rwsum, bal_cols=tuple(bal_cols),
        bal_rn=_reciprocal(max(sum(bal_cols), 1)),
        sbase=sbase, order=torch.argsort(snap.pod_order, stable=True).to(i32),
        pod_valid=snap.pod_valid, pod_nominated=snap.pod_nominated,
        pod_requested=snap.pod_requested, node_allocatable=snap.node_allocatable,
        node_requested=snap.node_requested, slack=fit_slack(snap.node_allocatable),
        pod_port_ids=snap.pod_port_ids, ports=ports, state=state,
        aff_terms=aff, aff_self=aff_self, anti_terms=snap.pod_anti_terms,
        pref_terms=snap.pod_pref_aff, pref_w=snap.pod_pref_aff_w,
        tsc=snap.pod_tsc, tsc_skew=snap.pod_tsc_skew,
        node_domains=snap.node_domains, dom_ptr=dom_ptr, dom_list=dom_list,
        sel_ptr=sel_ptr, sel_list=sel_list,
        reject_cols=tuple(fw.filter_names.index(n) if n in fw.filter_names else -1
                          for n in REJECT_PARTS) if rejects else None,
        n_filters=len(fw.filters), **vol,
    )


def _result(x: ScanInputs, res: CommitResult) -> ScanResult:
    state = next((v for v in res.extra.values() if isinstance(v, ip.AffinityState)),
                 x.state)
    return ScanResult(res.assignment, res.node_requested,
                      res.extra.get("NodePorts", x.ports), state, res.dyn_aux,
                      res.extra.get("VolumeBinding"))


def scan_commit_plain(x: ScanInputs) -> ScanResult:
    """The kernel's function through `greedy_commit` and the framework's
    per-pod hooks (`Framework.dyn`, `Framework.extra_update`); the full
    outputs walk every rank, as the reference's scan does, and collect
    `Framework.dyn`'s rejects."""
    fw, ctx = x.fw, x.ctx
    res = greedy_commit(
        order=x.order, static_mask=x.sbase > NEG_INF / 2, static_score=x.sbase,
        pod_requested=x.pod_requested, pod_valid=x.pod_valid,
        pod_nominated=x.pod_nominated, node_requested=x.node_requested,
        dyn_fn=lambda p, nr, ext, row: fw.dyn(ctx, p, nr, ext, row, rejects=x.full),
        extra=x.extra,
        update_fn=lambda ext, p, node, ok: fw.extra_update(ctx, ext, p, node, ok),
        rejects=x.n_filters if x.full else None,
    )
    return _result(x, res)


def exact_range_bound(x: ScanInputs) -> float:
    """An upper bound on every integer-valued f32 the scan forms (counts,
    totals, preferred weights and the raw affinity and spread sums): the
    kernel's sums are exact in any order below 2^24."""
    st = x.state
    nv = float(x.pod_valid.sum())
    MA = x.pref_terms.shape[1]
    MC = x.tsc.shape[1]
    maxw = float(x.pref_w.abs().max()) if x.pref_w.numel() else 0.0
    maxc = (float(st.counts.max()) if st.counts.numel() else 0.0) + nv
    maxpref = (float(st.pref_sym.abs().max()) if st.pref_sym.numel() else 0.0) + nv * MA * maxw
    per_pod = x.sel_ptr[1:] - x.sel_ptr[:-1]
    nsel = float(per_pod.max()) if per_pod.numel() else 0.0
    return max(maxc, float(st.total.max()) + nv if st.total.numel() else 0.0,
               MA * maxw * maxc + nsel * maxpref, MC * maxc)


def _dims(x: ScanInputs) -> tuple[int, ...]:
    """(P, N, R, MP, MA, MC, K, S, D, Q), or ValueError on what the kernel
    does not take (the node and PV limits are `launch_shape`'s)."""
    P, N = x.shape
    R = x.pod_requested.shape[1]
    MP = x.pod_port_ids.shape[1]
    MA = x.aff_terms.shape[1]
    MC = x.tsc.shape[1]
    K = x.node_domains.shape[1]
    S, D = x.state.counts.shape
    Q = x.ports.shape[1]
    if (R > MAX_RESOURCES or MP > MAX_PORTS or MA > MAX_TERMS or MC > MAX_CONSTRAINTS
            or K > MAX_KEYS or len(x.terms) > 4):
        raise ValueError(
            f"scan_commit: R={R} MP={MP} MA={MA} MC={MC} K={K} terms={len(x.terms)} over "
            f"the kernel's limits ({MAX_RESOURCES}, {MAX_PORTS}, {MAX_TERMS}, "
            f"{MAX_CONSTRAINTS}, {MAX_KEYS}, 4)")
    V, MVol, n_sub = x.vol
    if MVol > vm.MAX_VOLUME_SLOTS:
        raise ValueError(f"scan_commit: {MVol} volume slots per pod over "
                         f"{vm.MAX_VOLUME_SLOTS}")
    launch_shape(N, R, K, Q, S, row_layout(R, MP, MA, MC, K, MVol)["W"], V=V, n_sub=n_sub)
    return P, N, R, MP, MA, MC, K, S, D, Q


def row_layout(R: int, MP: int, MA: int, MC: int, K: int, MVol: int = 0) -> dict[str, int]:
    """Where each field of a pod row starts (ints; csrc `Args.r_*`) and the
    row's width W; `MVol` the volume slots of the volume instance (0
    without it)."""
    widths = (R, MP, 2 * MA, MA, 2 * MA, 2 * MA, MA, 3 * MC, MC, POD_SELS, 1, 1, 1, K, 1, 1,
              MVol, MVol, MVol, MVol, MVol)
    out, off = {}, 0
    for f, w in zip(_ROW_FIELDS, widths):
        out[f] = off
        off += w
    out["W"] = off
    return out


def smem_layout(ns: int, R: int, K: int, QW: int, S: int, W: int,
                full: bool = False, V: int = 0, n_sub: int = 0) -> dict[str, int]:
    """A CTA's shared memory (csrc `Args.o_*`, byte offsets, 16-aligned)
    for a slice of ns nodes, and its size `smem` (`full`: with the full
    mode's per-warp counts, after everything else; `V`, `n_sub`: the
    volume instance's claim bitmap of ceil(V / 32) words and its subset
    masks)."""
    sizes = (2 * CLUSTER * REC_BYTES, 2 * CLUSTER * 8, WARPS * REC_BYTES, WARPS * 8,
             MAX_CONSTRAINTS * WARPS * 4, (K + 1) * 4, 2 * W * 4, 2 * 8, S * 4,
             R * ns * 4, R * ns * 4, R * ns * 4, K * ns * 4, QW * ns * 4,
             -(-V // 32) * 4, n_sub * 4, WARPS * len(REJECT_PARTS) * 4 if full else 0)
    out, off = {}, 0
    for f, b in zip(_SMEM_FIELDS, sizes):
        out[f] = off
        off = (off + b + 15) // 16 * 16
    out["smem"] = off
    return out


def launch_shape(N: int, R: int, K: int, Q: int, S: int, W: int,
                 cluster: int = CLUSTER, full: bool = False, V: int = 0,
                 n_sub: int = 0) -> dict:
    """The launch for N nodes on a cluster of `cluster` CTAs (`full`: the
    full outputs' instance; `V`, `n_sub`: the volume instance's PVs and
    subset masks): the slice a CTA owns, nodes a thread and the shared
    memory layout; ValueError naming the limit the inputs pass (no
    fallback: a claim bitmap that does not fit beside the slice raises)."""
    ns = -(-N // cluster)
    if ns > THREADS * NODES_A_THREAD:
        raise ValueError(
            f"scan_commit: {N} nodes; the kernel takes at most "
            f"{cluster * THREADS * NODES_A_THREAD} on a cluster of {cluster} CTAs "
            f"({THREADS * NODES_A_THREAD} a CTA: {MAX_NODES} with {CLUSTER}, "
            f"{MAX_NODES_PORTABLE} on a card that schedules only the portable "
            f"{CLUSTER_PORTABLE})")
    if n_sub > MAX_SUBSETS:
        raise ValueError(f"scan_commit: {n_sub} slot subsets over {MAX_SUBSETS}")
    lay = smem_layout(ns, R, K, -(-Q // 32), S, W, full, V, n_sub)
    if lay["smem"] > SMEM_LIMIT:
        raise ValueError(
            f"scan_commit: {lay['smem']} bytes of shared memory a CTA for a slice of {ns} "
            f"nodes (R={R}, K={K}, Q={Q}), S={S} selector totals and a claim bitmap of "
            f"V={V} PVs ({-(-V // 32) * 4} bytes); a CTA has at most {SMEM_LIMIT}")
    return {"cluster": cluster, "slice": ns, "nodes_a_thread": -(-ns // THREADS),
            "smem": lay["smem"], "layout": lay}


# the volume instance's operands (csrc `Args`, in order)
_VOL_PTRS = ("node_off", "node_pv", "global_pv", "pv_class", "pv_cap", "req", "subs",
             "sdr_mask", "sdr_off", "claimed_in", "claimed_out")


class ScanArgs(ctypes.Structure):
    """csrc/scan_commit.cu `Args`, field for field."""

    _fields_ = (
        [(f, ctypes.c_int) for f in ("P", "N", "R", "MP", "MA", "MC", "K", "S", "D", "Q",
                                     "QW", "W", "flags", "csize", "ns", "rep_stride")]
        + [("term", ctypes.c_int * 4), ("weight", ctypes.c_float * 4),
           ("w100", ctypes.c_float * MAX_RESOURCES), ("rwsum", ctypes.c_float),
           ("rnf", ctypes.c_float), ("bal_mask", ctypes.c_int)]
        + [(f"o_{f}", ctypes.c_int) for f in _SMEM_FIELDS] + [("smem", ctypes.c_int)]
        + [(f"r_{f}", ctypes.c_int) for f in _ROW_FIELDS]
        + [(f, ctypes.c_void_p) for f in (
            "sbase", "vorder", "nv", "rows", "alloc", "slack", "node_domains", "dom_ptr",
            "dom_list", "sel_list", "assignment", "node_req", "ports", "counts",
            "counts_rep", "total", "anti", "pref", "rejects")]
        + [("F", ctypes.c_int), ("rej_col", ctypes.c_int * len(REJECT_PARTS))]
        + [(f, ctypes.c_int) for f in ("V", "MVol", "G", "Rq", "n_sub", "vmulti")]
        + [(f, ctypes.c_void_p) for f in _VOL_PTRS]
    )


def _library():
    lib = load_cuda_library("scan_commit")
    if lib.scan_commit_launch.argtypes is None:
        if lib.scan_commit_args_size() != ctypes.sizeof(ScanArgs):
            raise RuntimeError("scan_commit: ScanArgs does not match csrc/scan_commit.cu Args")
        lib.scan_commit_launch.argtypes = [ctypes.POINTER(ScanArgs), ctypes.c_void_p]
        lib.scan_commit_launch.restype = ctypes.c_int
        lib.scan_commit_clusters.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.scan_commit_clusters.restype = ctypes.c_int
    return lib


def scan_shape(x: ScanInputs, cluster: int = CLUSTER) -> dict:
    """The launch csrc/scan_commit.cu makes for these inputs on this card:
    a cluster of `cluster` CTAs where the card can schedule it, else the
    portable 8 (`launch_shape`'s dict). ValueError when `cluster` CTAs
    cannot hold the inputs; RuntimeError naming each shape tried when the
    card schedules none."""
    P, N, R, MP, MA, MC, K, S, D, Q = _dims(x)
    V, MVol, n_sub = x.vol
    W = row_layout(R, MP, MA, MC, K, MVol)["W"]
    shapes, tried = [launch_shape(N, R, K, Q, S, W, cluster, x.full, V, n_sub)], []
    if cluster != CLUSTER_PORTABLE:
        try:
            shapes.append(launch_shape(N, R, K, Q, S, W, CLUSTER_PORTABLE, x.full, V, n_sub))
        except ValueError as e:
            tried.append(str(e))
    lib = _library()
    for shape in shapes:
        n = ctypes.c_int(0)
        raise_on_error("scan_commit", lib.scan_commit_clusters(
            shape["cluster"], shape["smem"], int(x.full), int(bool(x.flags & F_VOLUMES)),
            ctypes.byref(n)))
        if n.value >= 1:
            return shape
        tried.append(f"the card schedules no cluster of {shape['cluster']} CTAs with "
                     f"{shape['smem']} bytes of shared memory each")
    raise RuntimeError("scan_commit: no cluster shape this card can run: " + "; ".join(tried))


def pod_flags(x: ScanInputs) -> torch.Tensor:
    """i32 [P]: POD_HARD where the kernel tests a DoNotSchedule constraint
    of the pod, POD_AFF_NORM where its raw affinity score can be nonzero
    (a preferred term, or a matched selector whose preferred-weight row is
    nonzero at cycle start or written by a valid pod's preferred term),
    POD_SPR_NORM where its raw spread score can (a ScheduleAnyway
    constraint). Without them a maximum is 0 on every node and the kernel
    skips its exchange. POD_VOL (the volume instance) where the pod has an
    unbound volume slot: the others skip VolumeBinding's test and claims;
    POD_INVALID (the full outputs) on a pad row."""
    P = x.shape[0]
    dev = x.sbase.device
    key, when = x.tsc[..., 0], x.tsc[..., 2]
    flags = torch.zeros(P, dtype=torch.int32, device=dev)
    codes = {t for t, _ in x.terms}
    if x.flags & F_SPREAD:
        flags |= POD_HARD * ((key >= 0) & (when == WHEN_DO_NOT_SCHEDULE)).any(1).int()
    if T_AFFINITY in codes:
        st = x.state
        S = st.counts.shape[0]
        psel = x.pref_terms[..., 0]
        written = (psel >= 0) & x.pod_valid[:, None]
        live = torch.zeros(S, dtype=torch.int32, device=dev).index_add_(
            0, psel.clamp(0, S - 1).reshape(-1).long(), written.reshape(-1).int())
        live = (live > 0) | (st.pref_sym != 0).any(1)
        norm = (psel >= 0).any(1)
        nnz = x.sel_list.shape[0]
        if nnz:
            pod_of = torch.searchsorted(
                x.sel_ptr[1:].contiguous(),
                torch.arange(nnz, dtype=torch.int32, device=dev), right=True)
            norm = norm | (torch.zeros(P, dtype=torch.int32, device=dev).index_add_(
                0, pod_of, live[x.sel_list.long()].int()) > 0)
        flags |= POD_AFF_NORM * norm.int()
    if T_SPREAD in codes:
        flags |= POD_SPR_NORM * ((key >= 0) & (when == WHEN_SCHEDULE_ANYWAY)).any(1).int()
    if x.full:
        flags |= POD_INVALID * (~x.pod_valid).int()
    if x.flags & F_VOLUMES:
        flags |= POD_VOL * (x.vol_mode == 1).any(1).int()
    return flags


def pod_rows(x: ScanInputs) -> torch.Tensor:
    """i32 [P, W]: each pod's operands in one row (`row_layout`; floats
    as their bits; the nominated node's domains, so the commit reads no
    node table)."""
    P = x.shape[0]
    dev = x.sbase.device
    i32 = torch.int32
    nsel = x.sel_ptr[1:] - x.sel_ptr[:-1]
    j = torch.arange(POD_SELS, device=dev)
    nnz = x.sel_list.shape[0]
    sels = torch.full((P, POD_SELS), -1, dtype=i32, device=dev)
    if nnz:
        idx = (x.sel_ptr[:-1, None].long() + j).clamp(max=nnz - 1)
        sels = torch.where(j < nsel[:, None], x.sel_list[idx], sels)
    cols = [x.pod_requested.contiguous().view(i32), x.pod_port_ids,
            x.aff_terms.reshape(P, -1), x.aff_self, x.anti_terms.reshape(P, -1),
            x.pref_terms.reshape(P, -1), x.pref_w.contiguous().view(i32),
            x.tsc.reshape(P, -1), x.tsc_skew, sels, x.sel_ptr[:-1, None], nsel[:, None],
            x.pod_nominated[:, None],
            x.node_domains[x.pod_nominated.clamp(0, x.shape[1] - 1).long()],
            pod_flags(x)[:, None],
            torch.arange(P, device=dev)[:, None]]
    if x.flags & F_VOLUMES:
        cols += [x.vol_mode, x.vol_req, x.vol_class, x.vol_size.contiguous().view(i32),
                 x.vol_member]
    return torch.cat([c.to(i32) for c in cols], 1).contiguous()


def valid_order(x: ScanInputs) -> tuple[torch.Tensor, torch.Tensor]:
    """(i32 [P] the valid pods in rank order, then the others; i32 [1] how
    many are valid), without a host synchronisation; for the full outputs
    every pod in rank order, and P."""
    if x.full:
        P = x.shape[0]
        return x.order.contiguous(), torch.full((1,), P, dtype=torch.int32,
                                                device=x.order.device)
    vr = x.pod_valid[x.order.long()]
    idx = torch.argsort((~vr).to(torch.int8), stable=True)
    return x.order[idx].contiguous(), vr.sum(dtype=torch.int32).reshape(1)


def scan_commit_cuda(x: ScanInputs, cluster: int = CLUSTER) -> ScanResult:
    """Launch csrc/scan_commit.cu on the current stream: one cluster of
    `cluster` CTAs, or of the portable 8 where the card cannot schedule it
    (`scan_shape`)."""
    k = "scan_commit"
    P, N, R, MP, MA, MC, K, S, D, Q = _dims(x)
    if x.flags & F_STATE and exact_range_bound(x) >= EXACT_F32:
        raise ValueError("scan_commit: affinity counts or weights reach 2^24, where "
                         "the kernel's f32 sums stop being exact")
    shape = scan_shape(x, cluster)
    dev = x.sbase.device
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    x = dataclasses.replace(
        x,
        order=checked(k, x.order, i32, (P,), dev),
        pod_valid=checked(k, x.pod_valid, b8, (P,), dev),
        pod_nominated=checked(k, x.pod_nominated, i32, (P,), dev),
        pod_requested=checked(k, x.pod_requested, f32, (P, R), dev),
        pod_port_ids=checked(k, x.pod_port_ids, i32, (P, MP), dev),
        aff_terms=checked(k, x.aff_terms, i32, (P, MA, 2), dev),
        aff_self=checked(k, x.aff_self, b8, (P, MA), dev),
        anti_terms=checked(k, x.anti_terms, i32, (P, MA, 2), dev),
        pref_terms=checked(k, x.pref_terms, i32, (P, MA, 2), dev),
        pref_w=checked(k, x.pref_w, f32, (P, MA), dev),
        tsc=checked(k, x.tsc, i32, (P, MC, 3), dev),
        tsc_skew=checked(k, x.tsc_skew, i32, (P, MC), dev),
        sel_ptr=checked(k, x.sel_ptr, i32, (P + 1,), dev),
        sel_list=checked(k, x.sel_list, i32, (x.sel_list.shape[0],), dev))
    keep = [
        checked(k, x.sbase, f32, (P, N), dev),
        *valid_order(x),
        pod_rows(x),
        checked(k, x.node_allocatable, f32, (N, R), dev),
        checked(k, x.slack, f32, (N, R), dev),
        checked(k, x.node_domains, i32, (N, K), dev),
        checked(k, x.dom_ptr, i32, (K + 1,), dev),
        checked(k, x.dom_list, i32, (x.dom_list.shape[0],), dev),
        x.sel_list,
    ]
    # outputs: copies of the carried state, updated in place by the kernel;
    # scratch: the other CTAs' replicas of the counts (16-byte rows)
    assignment = torch.empty(P, dtype=i32, device=dev)
    node_req = checked(k, x.node_requested, f32, (N, R), dev).clone()
    ports = checked(k, x.ports, b8, (N, Q), dev).clone()
    st = x.state
    counts = checked(k, st.counts, f32, (S, D), dev).clone()
    total = checked(k, st.total, f32, (S,), dev).clone()
    anti = checked(k, st.anti_presence, b8, (S, N), dev).clone()
    pref = checked(k, st.pref_sym, f32, (S, N), dev).clone()
    rejects = (torch.zeros((P, x.n_filters), dtype=i32, device=dev) if x.full
               else None)
    if x.full and not 0 < x.n_filters:
        raise ValueError("scan_commit: the full outputs need the framework's filters")
    c = shape["cluster"]
    rep_stride = -(-S * D // 4) * 4
    counts_rep = torch.empty(max(c - 1, 1) * rep_stride, dtype=f32, device=dev)
    terms = list(x.terms) + [(0, 0.0)] * (4 - len(x.terms))
    w100 = list(x.fit_w100) + [0.0] * (MAX_RESOURCES - R)
    V, MVol, n_sub = x.vol
    rl = row_layout(R, MP, MA, MC, K, MVol)
    vol, claimed, dims = {}, None, dict(V=V, MVol=MVol, n_sub=n_sub)
    if x.flags & F_VOLUMES:
        t = x.vol_tables
        Rq = t.req.shape[0]
        sdr_mask, sdr_off = vm.sdr_tables(MVol, str(dev))
        claimed = checked(k, x.pv_claimed, b8, (V,), dev).clone()
        vol = dict(zip(_VOL_PTRS, (
            checked(k, t.node_off, i32, (N + 1,), dev),
            checked(k, t.node_pv, i32, (t.node_pv.shape[0],), dev),
            checked(k, t.global_pv, i32, (t.global_pv.shape[0],), dev),
            checked(k, x.pv_class, i32, (V,), dev), checked(k, x.pv_cap, f32, (V,), dev),
            checked(k, t.req, b8, (Rq, N), dev),
            vm._subset_masks(MVol, x.vol_multi, str(dev)), sdr_mask, sdr_off,
            checked(k, x.pv_claimed, b8, (V,), dev), claimed)))
        keep += list(vol.values())
        dims.update(G=t.global_pv.shape[0], Rq=Rq, vmulti=int(x.vol_multi))
        for f, want in (("vol_mode", i32), ("vol_req", i32), ("vol_class", i32),
                        ("vol_size", f32), ("vol_member", i32)):
            checked(k, getattr(x, f), want, (P, MVol), dev)
    a = ScanArgs(
        P=P, N=N, R=R, MP=MP, MA=MA, MC=MC, K=K, S=S, D=D, Q=Q, QW=-(-Q // 32), W=rl["W"],
        flags=x.flags, csize=c, ns=shape["slice"], rep_stride=rep_stride,
        term=(ctypes.c_int * 4)(*[t for t, _ in terms]),
        weight=(ctypes.c_float * 4)(*[w for _, w in terms]),
        w100=(ctypes.c_float * MAX_RESOURCES)(*w100), rwsum=x.fit_rwsum, rnf=x.bal_rn,
        bal_mask=sum(1 << r for r, on in enumerate(x.bal_cols) if on),
        smem=shape["smem"],
        **{f"o_{f}": shape["layout"][f] for f in _SMEM_FIELDS},
        **{f"r_{f}": rl[f] for f in _ROW_FIELDS},
        **{f: t.data_ptr() for f, t in zip(
            ("sbase", "vorder", "nv", "rows", "alloc", "slack", "node_domains", "dom_ptr",
             "dom_list", "sel_list"), keep)},
        assignment=assignment.data_ptr(), node_req=node_req.data_ptr(),
        ports=ports.data_ptr(), counts=counts.data_ptr(), counts_rep=counts_rep.data_ptr(),
        total=total.data_ptr(), anti=anti.data_ptr(), pref=pref.data_ptr(),
        rejects=0 if rejects is None else rejects.data_ptr(), F=x.n_filters,
        rej_col=(ctypes.c_int * len(REJECT_PARTS))(
            *(x.reject_cols or (-1,) * len(REJECT_PARTS))),
        **dims, **{f: t.data_ptr() for f, t in vol.items()})
    err = _library().scan_commit_launch(ctypes.byref(a), stream_of(dev))
    raise_on_error(k, err)
    count_launch(k)
    return ScanResult(assignment, node_req, ports,
                      ip.AffinityState(counts, total, anti, pref), rejects, claimed)


def scan_commit(x: ScanInputs) -> ScanResult:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = scan_commit_cuda if x.sbase.device.type == "cuda" else scan_commit_plain
    return fn(x)
