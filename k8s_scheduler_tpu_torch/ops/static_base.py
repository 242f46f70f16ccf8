"""K1 `static_base`: the rounds engine's combined static base, f32 [P, N]
= the weighted static score (clipped to +-1e6) where every static filter
passes, NEG_INF elsewhere.

Reference: `ops/rounds.py:338` over `Framework.static_lean`
(`framework/runtime.py:103`), the composition `core/cycle.py:1092-1096`
also uses. Plain torch precomputes the small deduplicated tables once per
cycle (`static_base_inputs`); the kernel (`csrc/static_base.cu`) or its
plain version here does the [P, N] gather-and-combine. VolumeBinding's
static mask (K10's, bool [P, N]) comes in as one more operand, and the
HTTP extenders' verdicts (a snapshot's `pod_extender_mask` bool [P, N] and
`pod_extender_score` f32 [P, N], reference `core/cycle.py:574-580`) as two
more: the mask ANDed, the score added before the clip (one bare static
product fused into that add, as XLA contracts it). The scan engine's base
(`clip=False`) is not clipped, as the reference's scan takes the static
score as it is. The wrapper runs
the kernel for CUDA tensors and the plain version for CPU tensors — never
one in place of the other.

The kernel keeps nodes stationary: a block owns 2048 nodes, 8 a thread in
two chunks of 4 (so that each 16-byte access of a warp is contiguous),
with their node-side values in registers and the tile's room table in
shared memory, and walks groups of 32 pods whose scalars (tolerated taint
sets as bits, the TaintToleration row, the sampling window) it stages
once; rows are read 4 nodes at a time and each thread writes two 16-byte
streaming stores per pod. Bound on an H100: bytes, the f32 [P, N] output
(0.16 ms at P=16384, N=8192); the small tables stay in L2. An N that is
not a multiple of 4, or a row that is not aligned for the vector loads,
takes the same kernel with scalar loads and stores (the launcher checks
the pointers). The score takes the roundings of the reference's compiled
base (each weighted product rounded, the terms added in order, no
contraction; in the scan's instance the one fused product described at
`static_base_inputs`), and the kernel is bit-equal to `static_base_plain`.

K16 `static_rejects` (`csrc/static_rejects.cu`) takes the same inputs
without fit and sampling (`Framework.static`, the reference's
`framework/runtime.py:79`, has neither) and gives the reference's
first-rejector attribution over the static filters (`runtime.py:223
attribute_rejects`): i32 [P, F], column i the valid nodes that filter i
(the framework's order) rejects and no earlier filter does, for the rows
that `rows` (bool [P]) selects; with `survivors=True` also the chain's
remainder, bool [P, N] over every row: node_valid and every static filter,
the diagnosis program's start mask (K1's mask without fit and sampling).
With `base=(rows_plane, ids)` the chain starts from node_valid &
rows_plane[ids[p]] instead of node_valid: the diagnosis program's window
with the carried extender verdicts (reference `core/cycle.py:1482-1485`),
read in place from the [P, N] verdict plane, no gather.
It works on bit-sliced words: a first launch packs the node-side tables
(valid, schedulable, each toleration set's tolerated nodes, the
requirement rows; of a table of more than PACK_ALL rows only those the
pods name) into 32-node words, then a warp a pod row walks them, a test a
word, and counts each column with `__popc`; the counts are integer sums,
exact in any order. `static_rejects_plain` is its plain version."""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..framework.interfaces import PluginBase
from . import images as images_ops
from . import labels as labels_ops
from . import resources as res_ops
from . import taints as taints_ops
from .dyn_round import first_rejects
from .kernel_build import (checked, count_launch, load_cuda_library, raise_on_error,
                           stream_of)

NEG_INF = -1e9

# filter bits and score-term codes (csrc/static_base.cu mirrors these)
F_UNSCHED, F_NODENAME, F_TAINT, F_AFFINITY, F_PORTS, F_FIT, F_SAMPLE, F_MASK = (
    1, 2, 4, 8, 16, 32, 64, 128
)
F_EXT, F_NOCLIP = 256, 512  # the extender verdict operands; no clip (the scan)
# the static score's summands (the weighted terms, then the extender's score)
# are added in order; each add after the first (step k adds summand k) is
# plain (SUM_ADD) or fused with a product: the new summand's
# (SUM_FUSE_NEW: fma(a_k, c_k, sum)) or, at step 1, the first summand's
# (SUM_FUSE_FIRST: fma(a_0, c_0, summand 1)). Two bits a step from bit
# SUM_SHIFT of the flags (csrc/static_base.cu mirrors these).
SUM_ADD, SUM_FUSE_NEW, SUM_FUSE_FIRST = 0, 1, 2
SUM_SHIFT = 10
_SUM_BITS = 0x3F << SUM_SHIFT
TERM_IMAGE, TERM_PREF, TERM_TAINT = 1, 2, 3

_FILTER_BITS = {
    "NodeUnschedulable": F_UNSCHED,
    "NodeName": F_NODENAME,
    "TaintToleration": F_TAINT,
    "NodeAffinity": F_AFFINITY,
    "NodePorts": F_PORTS,
}
# static filters whose [P, N] mask another kernel computes: ANDed into the
# one mask operand
_MASK_OPERAND = ("VolumeBinding",)
# K16's tests, in csrc/static_rejects.cu's order: the filter each one is,
# and its bit (VolumeBinding's is the mask operand's)
REJECT_TESTS = (("NodeUnschedulable", F_UNSCHED), ("NodeName", F_NODENAME),
                ("TaintToleration", F_TAINT), ("NodeAffinity", F_AFFINITY),
                ("NodePorts", F_PORTS), ("VolumeBinding", F_MASK))
MAX_FILTERS = 32  # csrc/static_rejects.cu kMaxF
PACK_ALL = 64  # kPackAll: a table of more rows packs only those the pods name
_SCORE_TERMS = {
    "ImageLocality": TERM_IMAGE,
    "NodeAffinity": TERM_PREF,
    "TaintToleration": TERM_TAINT,
}


@dataclasses.dataclass
class StaticBaseInputs:
    """Everything the [P, N] combine reads: per-pod ids [P], per-node
    vectors [N], the [N, R] room table and the small deduplicated tables."""

    flags: int
    terms: tuple[tuple[int, float], ...]  # (term code, weight) in order
    pod_node_name: torch.Tensor  # i32 [P]
    pod_tolset: torch.Tensor  # i32 [P]
    pod_req_id: torch.Tensor  # i32 [P]
    pod_sel_req_id: torch.Tensor  # i32 [P]
    pod_pref_id: torch.Tensor  # i32 [P]
    pod_imageset: torch.Tensor  # i32 [P]
    pod_ports: torch.Tensor  # i32 [P, MPp]
    pod_requested: torch.Tensor  # f32 [P, R]
    samp_off: torch.Tensor  # i32 [P] sampling-window offsets
    samp_k: int  # window length
    samp_n: int  # rotation modulus (real node count, >= 1)
    node_valid: torch.Tensor  # bool [N]
    node_unsched: torch.Tensor  # bool [N]
    node_taintset: torch.Tensor  # i32 [N]
    node_used_ports: torch.Tensor  # i32 [N, MUP]
    node_room: torch.Tensor  # f32 [N, R] allocatable - requested + slack
    sched: torch.Tensor  # bool [Tl, Ts] taint-set schedulable
    tscore: torch.Tensor  # f32 [Tl, Ts] TaintToleration score
    req: torch.Tensor  # bool [Rq, N] requirement rows
    pref: torch.Tensor  # f32 [Pf, N] preferred-affinity score rows
    img: torch.Tensor  # f32 [Is, N] image-locality score rows
    mask: torch.Tensor | None = None  # bool [P, N] (F_MASK), or None
    emask: torch.Tensor | None = None  # bool [P, N] extender verdicts (F_EXT)
    escore: torch.Tensor | None = None  # f32 [P, N] weighted extender scores (F_EXT)
    # K16: each REJECT_TESTS entry's column (its filter's index, -1 where
    # the framework has no such filter or its mask is None) of F columns
    columns: tuple[int, ...] = (-1,) * len(REJECT_TESTS)
    n_filters: int = 0

    @property
    def shape(self) -> tuple[int, int]:
        return self.pod_tolset.shape[0], self.node_valid.shape[0]


def _overrides(plugin, hook: str) -> bool:
    return getattr(type(plugin), hook) is not getattr(PluginBase, hook)


def static_base_inputs(fw, ctx, *, fit: bool = False,
                       sampling: tuple[torch.Tensor, int, int] | None = None,
                       clip: bool = True) -> StaticBaseInputs:
    """Precompute the tables for the framework's static plugins.

    `fit` also ANDs NodeResourcesFit against the snapshot's node_requested
    (node_requested only grows within a cycle, so a pod that does not fit
    at the start never fits later: the rounds engine's masks are
    unchanged). `sampling` is `core.cycle.sampling_window` output. A
    snapshot with extender verdicts (`has_extender`) gives them as the
    F_EXT operands. `clip=False` leaves the score unclipped (the scan),
    and takes the scan's compiled score arithmetic, which fuses some
    products into the adds (`scan_sum_steps`). TaintToleration at weight
    1 passes its unscaled factor table and 100: its score's own multiply is
    a product the scan may fuse.

    A static plugin the kernel does not cover raises NotImplementedError."""
    snap = ctx.snap
    dev = snap.device
    flags = 0
    operand = None
    columns = {}
    for i, f in enumerate(fw.filters):
        bit = _FILTER_BITS.get(f.name)
        if bit is not None:
            flags |= bit
            columns.setdefault(f.name, i)
        elif f.name in _MASK_OPERAND:
            m = f.static_mask(ctx)
            if m is not None:
                operand = m if operand is None else operand & m
                flags |= F_MASK
                columns.setdefault(f.name, i)
        elif _overrides(f, "static_mask") and f.static_mask(ctx) is not None:
            raise NotImplementedError(
                f"static filter {f.name!r} is not covered by static_base"
            )
    terms = []
    for s, w in fw.scores:
        code = _SCORE_TERMS.get(s.name)
        if code is not None:
            terms.append((code, float(w)))
        elif _overrides(s, "static_score") and s.static_score(ctx) is not None:
            raise NotImplementedError(
                f"static score {s.name!r} is not covered by static_base"
            )
    if len(terms) > 3:
        raise NotImplementedError("static_base takes at most 3 score terms")
    if not clip:
        for k, mode in enumerate(scan_sum_steps(terms, snap.has_extender)):
            flags |= mode << (SUM_SHIFT + 2 * k)
    if fit:
        flags |= F_FIT
    if not clip:
        flags |= F_NOCLIP
    emask = escore = None
    if snap.has_extender:
        flags |= F_EXT
        emask, escore = snap.pod_extender_mask, snap.pod_extender_score
    if sampling is not None:
        flags |= F_SAMPLE
        samp_off, samp_k, samp_n = sampling
    else:
        samp_off, samp_k, samp_n = (
            torch.zeros(snap.P, dtype=torch.int32, device=dev), 0, 1
        )

    sched, prefer = taints_ops.toleration_tables(snap)
    # TaintToleration normalizes by the max count over VALID nodes per pod;
    # that max depends only on the pod's toleration set
    Ts = sched.shape[1]
    # which toleration-set rows a valid node carries: invalid nodes write
    # the extra row Ts (an index_fill, no boolean gather and so no sync)
    present = torch.zeros(Ts + 1, dtype=torch.bool, device=dev).index_fill_(
        0, torch.where(snap.node_valid, snap.node_taintset.long(), Ts), True)[:Ts]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    mx = torch.where(present[None, :], prefer, zero).amax(dim=1, keepdim=True)
    tscore = taints_ops.taint_score_table(prefer, mx)
    if (TERM_TAINT, 1.0) in terms:
        # the score as its factor times 100: the same rounding, and a
        # product a fused add takes unrounded
        tscore = taints_ops.taint_factor_table(prefer, mx)
        terms[terms.index((TERM_TAINT, 1.0))] = (TERM_TAINT, 100.0)

    em = ctx.expr_node_mask
    room = (snap.node_allocatable - snap.node_requested) + res_ops.fit_slack(
        snap.node_allocatable
    )
    return StaticBaseInputs(
        flags=flags,
        terms=tuple(terms),
        pod_node_name=snap.pod_node_name,
        pod_tolset=snap.pod_tolset,
        pod_req_id=snap.pod_req_id,
        pod_sel_req_id=snap.pod_sel_req_id,
        pod_pref_id=snap.pod_pref_id,
        pod_imageset=snap.pod_imageset,
        pod_ports=snap.pod_ports,
        pod_requested=snap.pod_requested,
        samp_off=samp_off,
        samp_k=int(samp_k),
        samp_n=max(int(samp_n), 1),
        node_valid=snap.node_valid,
        node_unsched=snap.node_unschedulable,
        node_taintset=snap.node_taintset,
        node_used_ports=snap.node_used_ports,
        node_room=room,
        sched=sched,
        tscore=tscore,
        req=ctx.requirement_rows,
        pref=labels_ops.preferred_table(snap, em),
        img=images_ops.image_table(snap),
        mask=operand,
        emask=emask,
        escore=escore,
        columns=tuple(columns.get(name, -1) for name, _ in REJECT_TESTS),
        n_filters=len(fw.filters),
    )


def scan_sum_steps(terms, ext: bool) -> tuple[int, ...]:
    """The scan's compiled static score, as steps of the summands' sum (the
    terms `(code, weight)` in order, then the extender's score when `ext`):
    one SUM_* mode a step. Read off the reference's scan program on the
    CPU, whose static score (the scan's input) is a fusion that ends in the
    add; tests/test_torch_extenders.py holds every combination of the three
    terms at weights 0, 1 and 3, with and without the extender's score.
    Only the first two summands' add ever fuses. Kinds: "P" an ImageLocality
    or NodeAffinity term at weight 1, "Q" one at another weight, "T"
    TaintToleration (its score ends in a multiply), "E" the extender's:
    the first summand's product fuses into its add when it is a Q or a T;
    else the second's into P+Q unless a T follows, and into P+T where
    nothing follows."""
    kinds = ["T" if code == TERM_TAINT else "P" if w == 1.0 else "Q" for code, w in terms]
    kinds += ["E"] if ext else []
    steps = [SUM_ADD] * max(len(kinds) - 1, 0)
    if len(kinds) >= 2:
        a, b = kinds[:2]
        after = kinds[2] if len(kinds) > 2 else None
        if a in "QT":
            steps[0] = SUM_FUSE_FIRST
        elif a == "P" and ((b == "Q" and after != "T") or (b == "T" and after is None)):
            steps[0] = SUM_FUSE_NEW
    return tuple(steps)


def reject_inputs(x: StaticBaseInputs) -> StaticBaseInputs:
    """K16's inputs from a cycle's K1 inputs: the same tables without the
    fit test, the sampling window and the extender verdicts (the reference
    attributes the static filters from node_valid, `runtime.py:79`)."""
    return dataclasses.replace(
        x, flags=x.flags & ~(F_FIT | F_SAMPLE | F_EXT | F_NOCLIP | _SUM_BITS),
        emask=None, escore=None)


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids.clamp(0, table.shape[0] - 1).long()]


def _filter_masks(x: StaticBaseInputs) -> dict[int, torch.Tensor]:
    """{filter bit: bool [P, N]} of the static filters the flags name."""
    P, N = x.shape
    dev = x.node_valid.device
    out = {}
    if x.flags & F_UNSCHED:
        out[F_UNSCHED] = ~x.node_unsched[None, :].expand(P, N)
    if x.flags & F_NODENAME:
        pin = x.pod_node_name[:, None]
        cols = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
        out[F_NODENAME] = torch.where(pin >= 0, cols == pin, True) & (pin != -2)
    if x.flags & F_TAINT:
        ts = x.node_taintset.clamp(0, x.sched.shape[1] - 1).long()
        tl = x.pod_tolset.clamp(0, x.sched.shape[0] - 1).long()
        out[F_TAINT] = x.sched[tl][:, ts]
    if x.flags & F_AFFINITY:
        m = torch.ones((P, N), dtype=torch.bool, device=dev)
        for ids in (x.pod_req_id, x.pod_sel_req_id):
            m = m & torch.where(ids[:, None] >= 0, _rows(x.req, ids), True)
        out[F_AFFINITY] = m
    if x.flags & F_PORTS:
        m = torch.ones((P, N), dtype=torch.bool, device=dev)
        for j in range(x.pod_ports.shape[1]):
            pj = x.pod_ports[:, j, None]
            for k in range(x.node_used_ports.shape[1]):
                m = m & ~((pj >= 0) & (pj == x.node_used_ports[None, :, k]))
        out[F_PORTS] = m
    if x.flags & F_MASK:
        out[F_MASK] = x.mask
    if x.flags & F_EXT:
        out[F_EXT] = x.emask
    return out


def static_base_plain(x: StaticBaseInputs) -> torch.Tensor:
    """The kernel's function in plain torch, same operations, same order."""
    P, N = x.shape
    dev = x.node_valid.device
    mask = x.node_valid[None, :].expand(P, N)
    for m in _filter_masks(x).values():
        mask = mask & m
    ts = x.node_taintset.clamp(0, x.sched.shape[1] - 1).long()
    tl = x.pod_tolset.clamp(0, x.sched.shape[0] - 1).long()
    if x.flags & F_FIT:
        for r in range(x.pod_requested.shape[1]):
            mask = mask & (x.pod_requested[:, r, None] <= x.node_room[None, :, r])
    if x.flags & F_SAMPLE:
        cols = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
        win = (cols - x.samp_off[:, None]) % x.samp_n
        mask = mask & (win < x.samp_k)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    summands = []  # (a, c): the value a * c, rounded unless fused
    for code, w in x.terms:
        if code == TERM_IMAGE:
            v = torch.where(x.pod_imageset[:, None] >= 0,
                            _rows(x.img, x.pod_imageset), zero)
        elif code == TERM_PREF:
            v = torch.where(x.pod_pref_id[:, None] >= 0,
                            _rows(x.pref, x.pod_pref_id), zero)
        else:
            v = x.tscore[tl][:, ts]
        summands.append((v, w))
    if x.flags & F_EXT:
        summands.append((x.escore, 1.0))
    score = summands[0][0] * summands[0][1] if summands else torch.zeros(
        (P, N), dtype=torch.float32, device=dev)  # one rounding; exact for a unit weight
    for k, (a, c) in enumerate(summands[1:]):
        mode = (x.flags >> (SUM_SHIFT + 2 * k)) & 3
        if mode == SUM_FUSE_NEW:
            score = res_ops._fma(a, c, score)
        elif mode == SUM_FUSE_FIRST:
            score = res_ops._fma(summands[0][0], summands[0][1], a * c)
        else:
            score = score + a * c
    if not x.flags & F_NOCLIP:
        score = torch.clamp(score, -1e6, 1e6)
    return torch.where(mask, score, torch.full((), NEG_INF, device=dev))


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
       ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_int] * 4 + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p]
    + [ctypes.c_void_p] * 3
)


def _library():
    lib = load_cuda_library("static_base")
    if lib.static_base_launch.argtypes is None:
        lib.static_base_launch.argtypes = _ARGTYPES
        lib.static_base_launch.restype = ctypes.c_int
    return lib


def _common_args(x: StaticBaseInputs, kernel: str) -> tuple[list, list]:
    """K1's launcher arguments after the output (csrc STATIC_PARAMS) and
    the tensors they point into, checked."""
    P, N = x.shape
    dev = x.node_valid.device
    R = x.pod_requested.shape[1]

    def i32(t, *shape):
        return checked(kernel, t, torch.int32, shape, dev)

    def f32(t, *shape):
        return checked(kernel, t, torch.float32, shape, dev)

    def u8(t, *shape):
        return checked(kernel, t, torch.bool, shape, dev).view(torch.uint8)

    Tl, Ts = x.sched.shape
    MPp, MUP = x.pod_ports.shape[1], x.node_used_ports.shape[1]
    keep = [  # references held across the launch
        i32(x.pod_node_name, P), i32(x.pod_tolset, P), i32(x.pod_req_id, P),
        i32(x.pod_sel_req_id, P), i32(x.pod_pref_id, P),
        i32(x.pod_imageset, P), i32(x.pod_ports, P, MPp),
        f32(x.pod_requested, P, R), i32(x.samp_off, P),
        u8(x.node_valid, N), u8(x.node_unsched, N), i32(x.node_taintset, N),
        i32(x.node_used_ports, N, MUP), f32(x.node_room, N, R),
        u8(x.sched, Tl, Ts), f32(x.tscore, Tl, Ts),
        u8(x.req, x.req.shape[0], N), f32(x.pref, x.pref.shape[0], N),
        f32(x.img, x.img.shape[0], N),
        u8(x.mask, P, N) if x.flags & F_MASK else None,
        u8(x.emask, P, N) if x.flags & F_EXT else None,
        f32(x.escore, P, N) if x.flags & F_EXT else None,
    ]
    terms = list(x.terms) + [(0, 0.0)] * (3 - len(x.terms))
    args = [
        P, N, R,
        *[_ptr(t) for t in keep[:7]], MPp, _ptr(keep[7]), _ptr(keep[8]),
        x.samp_k, x.samp_n,
        *[_ptr(t) for t in keep[9:13]], MUP, _ptr(keep[13]),
        _ptr(keep[14]), _ptr(keep[15]), Tl, Ts,
        _ptr(keep[16]), keep[16].shape[0], _ptr(keep[17]), keep[17].shape[0],
        _ptr(keep[18]), keep[18].shape[0],
        x.flags, terms[0][0], terms[1][0], terms[2][0],
        terms[0][1], terms[1][1], terms[2][1], len(x.terms),
        stream_of(dev), _ptr(keep[19]), _ptr(keep[20]), _ptr(keep[21]),
    ]
    return args, keep


def static_base_cuda(x: StaticBaseInputs) -> torch.Tensor:
    """Launch csrc/static_base.cu on the current stream (counted as the
    `static_base_ext` instance with the extender operands)."""
    P, N = x.shape
    args, _keep = _common_args(x, "static_base")
    out = torch.empty((P, N), dtype=torch.float32, device=x.node_valid.device)
    raise_on_error("static_base", _library().static_base_launch(_ptr(out), *args))
    count_launch("static_base_ext" if x.flags & F_EXT else "static_base")
    return out


def static_base(x: StaticBaseInputs) -> torch.Tensor:
    """f32 [P, N] static base: the kernel on CUDA, the plain version on CPU."""
    if x.node_valid.device.type == "cuda":
        return static_base_cuda(x)
    return static_base_plain(x)


def static_rejects_plain(x: StaticBaseInputs, rows=None, survivors: bool = False,
                         base=None):
    """K16's function in plain torch: the reference's attribution over the
    static filters' masks, in column order, from node_valid (and
    `base[0][base[1]]`); with `survivors` also the chain's remainder
    (every row)."""
    P, N = x.shape
    masks = _filter_masks(x)
    per_filter = [None] * x.n_filters
    for (_, bit), col in zip(REJECT_TESTS, x.columns):
        if col >= 0 and bit in masks:
            per_filter[col] = masks[bit]
    valid = x.node_valid[None, :].expand(P, N)
    if base is not None:
        valid = valid & base[0][base[1].long()]
    counts = first_rejects(valid, per_filter, rows)
    if not survivors:
        return counts
    rem = valid
    for m in per_filter:
        if m is not None:
            rem = rem & m
    return counts, rem


def _check_reject_inputs(x: StaticBaseInputs) -> None:
    if x.flags & (F_FIT | F_SAMPLE | F_EXT | F_NOCLIP | _SUM_BITS):
        raise ValueError("static_rejects: the inputs take neither fit, sampling, the "
                         "extender operands nor the scan's flag (reject_inputs)")
    if not 0 < x.n_filters <= MAX_FILTERS:
        raise ValueError(f"static_rejects: {x.n_filters} filters; the kernel takes 1 to "
                         f"{MAX_FILTERS}")
    cols = [c for (_, bit), c in zip(REJECT_TESTS, x.columns) if x.flags & bit]
    if len(set(cols)) != len(cols) or not all(0 <= c < x.n_filters for c in cols):
        raise ValueError(f"static_rejects: columns {cols} are not distinct columns of "
                         f"{x.n_filters}")


_REJ_ARGTYPES = (
    [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5 + [ctypes.c_int]
    + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p]
)


def _rejects_library():
    lib = load_cuda_library("static_rejects")
    if lib.static_rejects_launch.argtypes is None:
        lib.static_rejects_launch.argtypes = _REJ_ARGTYPES
        lib.static_rejects_launch.restype = ctypes.c_int
    return lib


def static_rejects_cuda(x: StaticBaseInputs, rows=None, survivors: bool = False,
                        base=None):
    """Launch K16 (csrc/static_rejects.cu: the rows the pods name, their
    words packed, then the counts) on the current stream (counted as the
    `static_rejects_base` instance with a per-pod base)."""
    k = "static_rejects"
    _check_reject_inputs(x)
    P, N = x.shape
    dev = x.node_valid.device

    def i32(t, *shape):
        return checked(k, t, torch.int32, shape, dev)

    def u8(t, *shape):
        return checked(k, t, torch.bool, shape, dev).view(torch.uint8)

    Tl, Ts = x.sched.shape
    Rq = x.req.shape[0]
    MPp, MUP = x.pod_ports.shape[1], x.node_used_ports.shape[1]
    keep = [  # references held across the launch
        i32(x.pod_node_name, P), i32(x.pod_tolset, P), i32(x.pod_req_id, P),
        i32(x.pod_sel_req_id, P), i32(x.pod_ports, P, MPp),
        u8(x.node_valid, N), u8(x.node_unsched, N), i32(x.node_taintset, N),
        i32(x.node_used_ports, N, MUP), u8(x.sched, Tl, Ts), u8(x.req, Rq, N),
        u8(x.mask, P, N) if x.flags & F_MASK else None,
        None if rows is None else u8(rows, P),
        None if base is None else u8(base[0], base[0].shape[0], N),
        None if base is None else i32(base[1], P),
    ]
    used = lst = None
    if Tl + Rq > PACK_ALL:  # mark the rows the pods name, pack those alone
        used = torch.zeros((Tl + Rq + 1,), dtype=torch.int32, device=dev)
        lst = torch.empty((Tl + Rq,), dtype=torch.int32, device=dev)
    words = torch.empty(((2 + Tl + Rq) * (-(-N // 32)),), dtype=torch.int32, device=dev)
    out = torch.empty((P, x.n_filters), dtype=torch.int32, device=dev)
    surv = torch.empty((P, N), dtype=torch.bool, device=dev) if survivors else None
    err = _rejects_library().static_rejects_launch(
        P, N, x.flags, *[_ptr(t) for t in keep[:5]], MPp,
        *[_ptr(t) for t in keep[5:9]], MUP, _ptr(keep[9]), Tl, Ts, _ptr(keep[10]), Rq,
        _ptr(keep[11]), x.n_filters, (ctypes.c_int * len(REJECT_TESTS))(*x.columns),
        _ptr(keep[12]), _ptr(used), _ptr(lst), _ptr(words), _ptr(out), _ptr(surv),
        _ptr(keep[13]), _ptr(keep[14]), base[0].shape[0] if base is not None else 0,
        stream_of(dev))
    raise_on_error(k, err)
    count_launch(k if base is None else "static_rejects_base")
    return out if surv is None else (out, surv)


def static_rejects(x: StaticBaseInputs, rows=None, survivors: bool = False,
                   base=None):
    """i32 [P, F] static first-rejector counts (and with `survivors` the
    bool [P, N] remainder of the chain), from node_valid or, with `base=
    (bool [Pb, N] rows, i32 [P] row ids)`, from node_valid & rows[ids]:
    the kernel on CUDA, the plain version on CPU."""
    if x.node_valid.device.type == "cuda":
        return static_rejects_cuda(x, rows, survivors, base)
    _check_reject_inputs(x)
    return static_rejects_plain(x, rows, survivors, base)
