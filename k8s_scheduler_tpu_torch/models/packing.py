"""Snapshot packing (`k8s_scheduler_tpu/models/packing.py`): the whole
`ClusterSnapshot` travels to the device as two buffers, a u32 word buffer
(every int32 and float32 field) and a u8 byte buffer (every bool field),
instead of one copy per field.

`pack` fills the two buffers on the host with numpy (the encoder packs into
pinned memory, so each buffer is one asynchronous host-to-device copy);
`unpack` rebuilds the snapshot on the device as views into the two device
buffers: the words as int32 or float32 through `Tensor.view`, the bools as
views of the bytes (`pack` writes 0 or 1, so the u8 bytes are valid bools;
no `!= 0` pass). The word buffer travels as int32 words, bit for bit the
u32 ones: torch's uint32 supports few operations.

The `PackSpec` pins every field's dtype, shape and offset plus the
snapshot's non-array fields (`aux`). Unlike the reference, each field
starts on a 16-byte boundary of its buffer: the kernels' vector loads need
aligned rows. `aux` also holds the port's `pref_raw_bound` (K3's exactness
bound, computed on the host from the pending set); `layout_key` is the
spec without it, the part that programs and device-resident state depend
on."""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from .encoding import ClusterSnapshot

ALIGN_WORDS = 4  # 16 bytes
ALIGN_BYTES = 16
_TORCH = {"int32": torch.int32, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class PackSpec:
    # (name, dtype_str, shape, word_offset) for u32-packed numeric fields
    words: tuple[tuple[str, str, tuple[int, ...], int], ...]
    # (name, shape, byte_offset) for bool fields in the u8 buffer
    bools: tuple[tuple[str, tuple[int, ...], int], ...]
    n_words: int
    n_bytes: int
    # non-array ClusterSnapshot attributes, captured as constants
    aux: tuple[tuple[str, Any], ...]

    def key(self):
        return (self.words, self.bools, self.aux)

    def layout_key(self):
        """`key` without the host-side bound `pref_raw_bound`, which only
        K3 reads and which moves with the pending set."""
        return (self.words, self.bools,
                tuple(kv for kv in self.aux if kv[0] != "pref_raw_bound"))

    def shape_of(self, name: str) -> tuple[int, ...]:
        for n, _dt, shape, _off in self.words:
            if n == name:
                return shape
        for n, shape, _off in self.bools:
            if n == name:
                return shape
        raise KeyError(name)


# The pad dimensions whose changes make a new program regime: name ->
# (snapshot field, axis) to read the padded size from (reference
# `models/packing.py:50`). P / N the pod / node pads, E the existing-pod
# pad, MPN the per-node victim depth, MA the per-pod (anti-)affinity term
# pad, MC the per-pod topology-spread pad. core/observe.py diffs
# consecutive signatures to attribute which dimension flipped.
SIGNATURE_DIMS = (
    ("P", "pod_valid", 0),
    ("N", "node_valid", 0),
    ("E", "exist_valid", 0),
    ("MPN", "node_pods", 1),
    ("MA", "pod_aff_terms", 1),
    ("MC", "pod_tsc", 1),
)


def shape_signature(spec: PackSpec) -> tuple[tuple[str, int], ...]:
    """Named pad-regime signature of a PackSpec (reference `:64`): a
    stable tuple of (dimension, padded size) pairs."""
    shapes: dict[str, tuple[int, ...]] = {
        name: shape for name, _dt, shape, _off in spec.words}
    shapes.update({name: shape for name, shape, _off in spec.bools})
    out = []
    for dim, fld, axis in SIGNATURE_DIMS:
        shp = shapes.get(fld)
        if shp is not None and len(shp) > axis:
            out.append((dim, int(shp[axis])))
    return tuple(out)


def respec(spec: PackSpec, dims: "dict[str, int]") -> PackSpec | None:
    """A PackSpec with its P and/or N pad rewritten to an adjacent regime
    size without re-encoding (reference `:83`): the speculative warm build
    needs the neighbouring regime's exact spec. Every `pod_*` field
    carries P on axis 0 and every `node_*` field N on axis 0, and no other
    axis scales with them; the extender verdict planes ([P, N]) would
    break that, so their presence refuses the rewrite (None), as does a
    result whose signature does not carry the new sizes. Offsets are
    recomputed with the port's alignment; aux is kept."""
    prefixes = {"P": "pod_", "N": "node_"}
    if not dims or any(d not in prefixes for d in dims):
        return None
    names = {n for n, _dt, _sh, _off in spec.words}
    names.update(n for n, _sh, _off in spec.bools)
    if names & {"pod_extender_mask", "pod_extender_score"}:
        return None
    old_sizes = dict(shape_signature(spec))

    def rewrite(name: str, shape: tuple) -> tuple:
        for dim, new in dims.items():
            if name.startswith(prefixes[dim]):
                if not shape or shape[0] != old_sizes.get(dim):
                    return shape
                return (int(new),) + tuple(shape[1:])
        return shape

    words, bools = [], []
    wo = bo = 0
    for name, dt, shape, _off in spec.words:
        shape = rewrite(name, shape)
        words.append((name, dt, shape, wo))
        wo = _up(wo + _size(shape), ALIGN_WORDS)
    for name, shape, _off in spec.bools:
        shape = rewrite(name, shape)
        bools.append((name, shape, bo))
        bo = _up(bo + _size(shape), ALIGN_BYTES)
    out = PackSpec(words=tuple(words), bools=tuple(bools), n_words=max(wo, 1),
                   n_bytes=max(bo, 1), aux=spec.aux)
    got = dict(shape_signature(out))
    if any(got.get(dim) != int(new) for dim, new in dims.items()):
        return None
    return out


def _size(shape) -> int:
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


def _up(n: int, a: int) -> int:
    return -(-n // a) * a


def _spec_of(named) -> PackSpec:
    """The spec of (name, value) pairs in the snapshot's field order."""
    words, bools, aux = [], [], []
    wo = bo = 0
    for name, v in named:
        if isinstance(v, (np.ndarray, torch.Tensor)):
            shape = tuple(v.shape)
            dt = str(v.dtype).replace("torch.", "")
            if dt == "bool":
                bools.append((name, shape, bo))
                bo = _up(bo + _size(shape), ALIGN_BYTES)
            elif dt in _TORCH:
                words.append((name, dt, shape, wo))
                wo = _up(wo + _size(shape), ALIGN_WORDS)
            else:
                raise TypeError(f"unpackable dtype {dt} for field {name}")
        else:
            aux.append((name, v))
    return PackSpec(words=tuple(words), bools=tuple(bools), n_words=max(wo, 1),
                    n_bytes=max(bo, 1), aux=tuple(aux))


def make_spec(snap: ClusterSnapshot) -> PackSpec:
    return _spec_of((f.name, getattr(snap, f.name)) for f in dataclasses.fields(snap))


def spec_of_fields(fields: Mapping[str, np.ndarray], aux: Mapping[str, Any]) -> PackSpec:
    """`make_spec` of the snapshot the encoder's host arrays `fields` and
    non-array fields `aux` (with `pref_raw_bound`) describe."""
    def value(f):
        if f.name in fields:
            return fields[f.name]
        return aux[f.name] if f.name in aux else f.default

    return _spec_of((f.name, value(f)) for f in dataclasses.fields(ClusterSnapshot))


def _host(src, name) -> np.ndarray:
    v = src[name] if isinstance(src, Mapping) else getattr(src, name)
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return np.ascontiguousarray(v)


def pack(src, spec: PackSpec, out=None):
    """-> (u32 [n_words], u8 [n_bytes]) numpy buffers of `src` (a
    snapshot, or the encoder's dict of host arrays); into `out` (a pair of
    such buffers, e.g. views of pinned memory) when given. Bytes between
    aligned fields are left as they are: no view reads them."""
    if out is None:
        out = (np.zeros(spec.n_words, np.uint32), np.zeros(spec.n_bytes, np.uint8))
    wbuf, bbuf = out
    for name, _dt, _shape, off in spec.words:
        a = _host(src, name)
        wbuf[off:off + a.size] = a.view(np.uint32).ravel()
    for name, _shape, off in spec.bools:
        a = _host(src, name)
        bbuf[off:off + a.size] = a.view(np.uint8).ravel()
    return wbuf, bbuf


def unpack(wbuf: torch.Tensor, bbuf: torch.Tensor, spec: PackSpec) -> ClusterSnapshot:
    """The snapshot as views into the device buffers `wbuf` (int32
    [n_words]) and `bbuf` (uint8 [n_bytes])."""
    if wbuf.dtype != torch.int32 or bbuf.dtype != torch.uint8:
        raise ValueError(f"unpack: want int32 words and uint8 bytes, got {wbuf.dtype} "
                         f"and {bbuf.dtype}")
    kw = dict(spec.aux)
    if kw.get("has_extender"):
        raise NotImplementedError("HTTP-extender verdicts are not ported yet (ROADMAP A10)")
    for name, dt, shape, off in spec.words:
        kw[name] = wbuf[off:off + _size(shape)].view(_TORCH[dt]).view(shape)
    for name, shape, off in spec.bools:
        kw[name] = bbuf[off:off + _size(shape)].view(torch.bool).view(shape)
    return ClusterSnapshot(**kw)
