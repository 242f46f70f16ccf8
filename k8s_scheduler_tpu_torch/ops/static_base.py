"""K1 `static_base`: the rounds engine's combined static base, f32 [P, N]
= the weighted static score (clipped to +-1e6) where every static filter
passes, NEG_INF elsewhere.

Reference: `ops/rounds.py:338` over `Framework.static_lean`
(`framework/runtime.py:103`), the composition `core/cycle.py:1092-1096`
also uses. Plain torch precomputes the small deduplicated tables once per
cycle (`static_base_inputs`); the kernel (`csrc/static_base.cu`) or its
plain version here does the [P, N] gather-and-combine. VolumeBinding's
static mask (K10's, bool [P, N]) comes in as one more operand. The wrapper runs
the kernel for CUDA tensors and the plain version for CPU tensors — never
one in place of the other."""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..framework.interfaces import PluginBase
from . import images as images_ops
from . import labels as labels_ops
from . import resources as res_ops
from . import taints as taints_ops
from .kernel_build import count_launch, load_cuda_library

NEG_INF = -1e9

# filter bits and score-term codes (csrc/static_base.cu mirrors these)
F_UNSCHED, F_NODENAME, F_TAINT, F_AFFINITY, F_PORTS, F_FIT, F_SAMPLE, F_MASK = (
    1, 2, 4, 8, 16, 32, 64, 128
)
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

    @property
    def shape(self) -> tuple[int, int]:
        return self.pod_tolset.shape[0], self.node_valid.shape[0]


def _overrides(plugin, hook: str) -> bool:
    return getattr(type(plugin), hook) is not getattr(PluginBase, hook)


def static_base_inputs(fw, ctx, *, fit: bool = False,
                       sampling: tuple[torch.Tensor, int, int] | None = None
                       ) -> StaticBaseInputs:
    """Precompute the tables for the framework's static plugins.

    `fit` also ANDs NodeResourcesFit against the snapshot's node_requested
    (node_requested only grows within a cycle, so a pod that does not fit
    at the start never fits later: the rounds engine's masks are
    unchanged). `sampling` is `core.cycle.sampling_window` output.

    A static plugin the kernel does not cover raises NotImplementedError."""
    snap = ctx.snap
    dev = snap.device
    flags = 0
    operand = None
    for f in fw.filters:
        bit = _FILTER_BITS.get(f.name)
        if bit is not None:
            flags |= bit
        elif f.name in _MASK_OPERAND:
            m = f.static_mask(ctx)
            if m is not None:
                operand = m if operand is None else operand & m
                flags |= F_MASK
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
    if fit:
        flags |= F_FIT
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
    present = torch.zeros(Ts, dtype=torch.bool, device=dev)
    present[snap.node_taintset[snap.node_valid].long()] = True
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    mx = torch.where(present[None, :], prefer, zero).amax(dim=1, keepdim=True)
    tscore = taints_ops.taint_score_table(prefer, mx)

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
    )


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids.clamp(0, table.shape[0] - 1).long()]


def static_base_plain(x: StaticBaseInputs) -> torch.Tensor:
    """The kernel's function in plain torch, same operations, same order."""
    P, N = x.shape
    dev = x.node_valid.device
    mask = x.node_valid[None, :].expand(P, N)
    if x.flags & F_UNSCHED:
        mask = mask & ~x.node_unsched[None, :]
    if x.flags & F_NODENAME:
        pin = x.pod_node_name[:, None]
        cols = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
        mask = mask & torch.where(pin >= 0, cols == pin, True) & (pin != -2)
    ts = x.node_taintset.clamp(0, x.sched.shape[1] - 1).long()
    tl = x.pod_tolset.clamp(0, x.sched.shape[0] - 1).long()
    if x.flags & F_TAINT:
        mask = mask & x.sched[tl][:, ts]
    if x.flags & F_AFFINITY:
        for ids in (x.pod_req_id, x.pod_sel_req_id):
            mask = mask & torch.where(ids[:, None] >= 0, _rows(x.req, ids), True)
    if x.flags & F_PORTS:
        for j in range(x.pod_ports.shape[1]):
            pj = x.pod_ports[:, j, None]
            for k in range(x.node_used_ports.shape[1]):
                mask = mask & ~((pj >= 0) & (pj == x.node_used_ports[None, :, k]))
    if x.flags & F_FIT:
        for r in range(x.pod_requested.shape[1]):
            mask = mask & (x.pod_requested[:, r, None] <= x.node_room[None, :, r])
    if x.flags & F_SAMPLE:
        cols = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
        win = (cols - x.samp_off[:, None]) % x.samp_n
        mask = mask & (win < x.samp_k)
    if x.flags & F_MASK:
        mask = mask & x.mask
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    score = torch.zeros((P, N), dtype=torch.float32, device=dev)
    for code, w in x.terms:
        if code == TERM_IMAGE:
            v = torch.where(x.pod_imageset[:, None] >= 0,
                            _rows(x.img, x.pod_imageset), zero)
        elif code == TERM_PREF:
            v = torch.where(x.pod_pref_id[:, None] >= 0,
                            _rows(x.pref, x.pod_pref_id), zero)
        else:
            v = x.tscore[tl][:, ts]
        score = res_ops._fma(v, w, score)
    return torch.where(mask, torch.clamp(score, -1e6, 1e6),
                       torch.full((), NEG_INF, device=dev))


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
    + [ctypes.c_void_p]
)


def _library():
    lib = load_cuda_library("static_base")
    if lib.static_base_launch.argtypes is None:
        lib.static_base_launch.argtypes = _ARGTYPES
        lib.static_base_launch.restype = ctypes.c_int
    return lib


def static_base_cuda(x: StaticBaseInputs) -> torch.Tensor:
    """Launch csrc/static_base.cu on the current stream."""
    P, N = x.shape
    dev = x.node_valid.device
    R = x.pod_requested.shape[1]

    def i32(t, *shape):
        if t.dtype != torch.int32 or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"static_base: want i32 {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        return t.contiguous()

    def f32(t, *shape):
        if t.dtype != torch.float32 or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"static_base: want f32 {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        return t.contiguous()

    def u8(t, *shape):
        if t.dtype != torch.bool or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"static_base: want bool {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        return t.contiguous().view(torch.uint8)

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
    ]
    out = torch.empty((P, N), dtype=torch.float32, device=dev)
    terms = list(x.terms) + [(0, 0.0)] * (3 - len(x.terms))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().static_base_launch(
        _ptr(out), P, N, R,
        *[_ptr(t) for t in keep[:7]], MPp, _ptr(keep[7]), _ptr(keep[8]),
        x.samp_k, x.samp_n,
        *[_ptr(t) for t in keep[9:13]], MUP, _ptr(keep[13]),
        _ptr(keep[14]), _ptr(keep[15]), Tl, Ts,
        _ptr(keep[16]), keep[16].shape[0], _ptr(keep[17]), keep[17].shape[0],
        _ptr(keep[18]), keep[18].shape[0],
        x.flags, terms[0][0], terms[1][0], terms[2][0],
        terms[0][1], terms[1][1], terms[2][1], len(x.terms),
        ctypes.c_void_p(stream), _ptr(keep[19]),
    )
    if err != 0:
        raise RuntimeError(f"static_base launch failed: CUDA error {err}")
    count_launch("static_base")
    return out


def static_base(x: StaticBaseInputs) -> torch.Tensor:
    """f32 [P, N] static base: the kernel on CUDA, the plain version on CPU."""
    if x.node_valid.device.type == "cuda":
        return static_base_cuda(x)
    return static_base_plain(x)
