"""Label-expression tables (`k8s_scheduler_tpu/ops/labels.py`): every
distinct match expression is one row of a deduplicated table, evaluated
against every node (or pod) at once; per-pod masks are row gathers.

Semantics parity (labels.Requirement): NotIn and DoesNotExist match when
the key is absent; Gt/Lt require a numerically-parsable label value."""

from __future__ import annotations

import torch

from ..models import encoding as enc


def take_rows(table: torch.Tensor, ids: torch.Tensor, fill) -> torch.Tensor:
    """table[ids] for a [X, N] table and [P] ids (-1 -> `fill`). The
    reference rides a one-hot matmul (exact: one nonzero per row); the
    port gathers."""
    X = table.shape[0]
    out = table[ids.clamp(0, X - 1).long()]
    fill_t = torch.full((), fill, dtype=table.dtype, device=table.device)
    return torch.where((ids >= 0)[:, None], out, fill_t)


EXPR_CHUNK = 1024  # expressions gathered at once (bounds the [Ex, MV, X] temporary)
_SENTINEL = torch.iinfo(torch.int64).max


def _presence(codes: torch.Tensor, valid: torch.Tensor, X: int):
    """(sorted distinct codes + a sentinel, bool [Q + 1, X] incidence):
    which subjects carry each code, from codes [X, M] valid where `valid`."""
    x_idx = torch.nonzero(valid, as_tuple=True)[0]
    uniq, inv = torch.unique(codes[valid], return_inverse=True)
    table = torch.zeros((uniq.shape[0] + 1, X), dtype=torch.bool, device=codes.device)
    table[inv, x_idx] = True
    sentinel = torch.full((1,), _SENTINEL, dtype=uniq.dtype, device=uniq.device)
    return torch.cat([uniq, sentinel]), table


def _any_present(uniq, table, codes, valid) -> torch.Tensor:
    """bool [Ex, X]: some valid code of the row (codes [Ex, M]) is carried
    by the subject."""
    pos = torch.searchsorted(uniq, codes).clamp(max=uniq.shape[0] - 1)
    hit = valid & (uniq[pos] == codes)
    return torch.cat([
        (table[pos[i:i + EXPR_CHUNK]] & hit[i:i + EXPR_CHUNK, :, None]).any(dim=1)
        for i in range(0, codes.shape[0], EXPR_CHUNK)])


def expr_match(
    ex_key: torch.Tensor,  # i32 [Ex]
    ex_op: torch.Tensor,  # i32 [Ex]
    ex_vals: torch.Tensor,  # i32 [Ex, MV] (-1 pad)
    ex_num: torch.Tensor,  # f32 [Ex]
    label_keys: torch.Tensor,  # i32 [X, ML] (-1 pad)
    label_vals: torch.Tensor,  # i32 [X, ML]
    label_num: torch.Tensor | None = None,  # f32 [X, ML] (nan if not numeric)
    subject_index: torch.Tensor | None = None,  # i32 [X] for FIELD_IN
) -> torch.Tensor:  # bool [Ex, X]
    """Evaluate every expression against every labeled subject.

    The reference compares every expression with every label slot, [Ex, X,
    ML, MV]; with thousands of hostname expressions (local volumes) that
    dominates a cycle. Here the subjects' (key, value) pairs and keys are
    interned once and each expression looks its own up: In / NotIn are
    "some (key, value) of the row is carried", Exists / DoesNotExist "the
    key is carried" — the same sets, exactly. Gt, Lt and field matches
    keep the dense form on their (few) rows."""
    Ex, X = ex_key.shape[0], label_keys.shape[0]
    dev = ex_key.device
    keys, vals = label_keys.long(), label_vals.long()
    span = int(torch.stack([label_vals.max(), ex_vals.max()]).clamp(min=0).max()) + 1
    uniq, table = _presence(keys * span + vals, (label_keys >= 0) & (label_vals >= 0), X)
    key_and_val = _any_present(uniq, table, ex_key.long()[:, None] * span + ex_vals.long(),
                               (ex_key >= 0)[:, None] & (ex_vals >= 0))
    uniq, table = _presence(keys, label_keys >= 0, X)
    has_key = _any_present(uniq, table, ex_key.long()[:, None], (ex_key >= 0)[:, None])

    op = ex_op[:, None]
    out = torch.zeros((Ex, X), dtype=torch.bool, device=dev)
    for code, val in (
        (enc.OP_IN, key_and_val),
        (enc.OP_NOT_IN, ~key_and_val),  # absent key matches NotIn
        (enc.OP_EXISTS, has_key),
        (enc.OP_DOES_NOT_EXIST, ~has_key),
    ):
        out = torch.where(op == code, val, out)
    if label_num is not None:
        rows = torch.nonzero((ex_op == enc.OP_GT) | (ex_op == enc.OP_LT),
                             as_tuple=True)[0]
        if rows.numel():
            key_eq = (label_keys[None, :, :] == ex_key[rows][:, None, None]) & (
                label_keys[None, :, :] >= 0)
            # nan compares False, so non-numeric labels never satisfy Gt/Lt
            num = ex_num[rows][:, None, None]
            gt = (key_eq & (label_num[None, :, :] > num)).any(-1)
            lt = (key_eq & (label_num[None, :, :] < num)).any(-1)
            out[rows] = torch.where(ex_op[rows][:, None] == enc.OP_GT, gt, lt)
    if subject_index is not None:
        rows = torch.nonzero(ex_op == enc.OP_FIELD_IN, as_tuple=True)[0]
        if rows.numel():
            v = ex_vals[rows]
            out[rows] = ((subject_index[None, :, None] == v[:, None, :])
                         & (v >= 0)[:, None, :]).any(-1)
    return out  # OP_IMPOSSIBLE / padding stay False


def expr_node_mask(snap) -> torch.Tensor:  # bool [Ex, N]
    return expr_match(
        snap.ex_key, snap.ex_op, snap.ex_vals, snap.ex_num,
        snap.node_label_keys, snap.node_label_vals, snap.node_label_num,
        subject_index=torch.arange(snap.N, dtype=torch.int32, device=snap.device),
    )


def _gather_expr(expr_mask: torch.Tensor, ids: torch.Tensor,
                 fill: bool) -> torch.Tensor:
    """expr_mask [Ex, X] gathered by ids [...] with -1 -> `fill`."""
    out = expr_mask[ids.clamp(0, expr_mask.shape[0] - 1).long()]  # [..., X]
    return torch.where((ids >= 0)[..., None], out, torch.tensor(fill, device=out.device))


def requirement_mask(rq_exprs: torch.Tensor, expr_mask: torch.Tensor) -> torch.Tensor:
    """[Rq, MT, ME] requirement table -> bool [Rq, X]: OR over terms of
    AND over expressions (an all-padding term is ignored)."""
    g = _gather_expr(expr_mask, rq_exprs, fill=True)  # [Rq, MT, ME, X]
    term_ok = g.all(dim=2)  # [Rq, MT, X]
    term_valid = (rq_exprs >= 0).any(dim=2)  # [Rq, MT]
    return (term_ok & term_valid[:, :, None]).any(dim=1)


def pod_requirement_mask(snap, expr_mask: torch.Tensor,
                         req: torch.Tensor | None = None) -> torch.Tensor:
    """Per-pod node-affinity + nodeSelector feasibility: bool [P, N]
    (`req`: the [Rq, N] requirement rows, when already built)."""
    if req is None:
        req = requirement_mask(snap.rq_exprs, expr_mask)  # [Rq, N]
    return take_rows(req, snap.pod_req_id, True) & take_rows(
        req, snap.pod_sel_req_id, True
    )


def preferred_table(snap, expr_mask: torch.Tensor) -> torch.Tensor:
    """Preferred node-affinity score per deduplicated term set: f32
    [Pf, N] = matched weight / total weight * 100."""
    g = _gather_expr(expr_mask, snap.pf_exprs, fill=True)  # [Pf, MPT, ME, N]
    term_ok = g.all(dim=2)  # [Pf, MPT, N]
    term_valid = (snap.pf_exprs >= 0).any(dim=2)  # [Pf, MPT]
    w = snap.pf_weight * term_valid  # [Pf, MPT]
    # a 0/1 factor makes every product exact: the sum is plain adds in
    # term order
    matched = torch.zeros(term_ok.shape[0], term_ok.shape[2],
                          dtype=torch.float32, device=w.device)
    for t in range(term_ok.shape[1]):
        matched = matched + w[:, t, None] * term_ok[:, t]
    total = torch.zeros(w.shape[0], dtype=torch.float32, device=w.device)
    for t in range(w.shape[1]):
        total = total + w[:, t]
    total = torch.clamp(total, min=1e-9)[:, None]
    return matched / total * 100.0


def preferred_score(snap, expr_mask: torch.Tensor) -> torch.Tensor:
    """NodeAffinity preferred terms -> score [P, N] in [0, 100] (normalized
    by the pod's total preferred weight, the reference's documented
    deviation)."""
    return take_rows(preferred_table(snap, expr_mask), snap.pod_pref_id, 0.0)
