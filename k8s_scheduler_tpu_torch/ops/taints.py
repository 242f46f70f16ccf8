"""Taint/toleration tables (`k8s_scheduler_tpu/ops/taints.py`): taint sets
and toleration sets are deduplicated at encode time, one small pass
builds the [Tl, Ts] set-compatibility tables, and the per-(pod, node)
values are a 2-D gather from them."""

from __future__ import annotations

import torch

from ..models import encoding as enc


def toleration_tables(snap) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (schedulable [Tl, Ts] bool, prefer_untolerated [Tl, Ts] f32).

    schedulable: every NoSchedule/NoExecute taint in set Ts is tolerated by
    set Tl (effect matches or toleration effect empty; key matches or
    toleration key empty with Exists; value matches unless Exists).
    prefer_untolerated: count of PreferNoSchedule taints not tolerated."""
    tl_key = snap.tl_key[:, None, :, None]  # [Tl, 1, MTl, 1]
    tl_op = snap.tl_op[:, None, :, None]
    tl_val = snap.tl_val[:, None, :, None]
    tl_eff = snap.tl_effect[:, None, :, None]
    tl_ok = snap.tl_valid[:, None, :, None]
    ts_key = snap.ts_key[None, :, None, :]  # [1, Ts, 1, MTt]
    ts_val = snap.ts_val[None, :, None, :]
    ts_eff = snap.ts_effect[None, :, None, :]
    ts_ok = snap.ts_valid[None, :, None, :]

    effect_match = (tl_eff == -1) | (tl_eff == ts_eff)
    key_match = torch.where(
        tl_key == -1, tl_op == enc.TOL_OP_EXISTS, tl_key == ts_key
    )
    value_match = (tl_op == enc.TOL_OP_EXISTS) | (tl_val == ts_val)
    tolerates = tl_ok & effect_match & key_match & value_match
    tolerated = tolerates.any(dim=2)  # [Tl, Ts, MTt]

    eff = ts_eff[:, :, 0, :]
    valid = ts_ok[:, :, 0, :]
    hard = valid & (
        (eff == enc.EFFECT_NO_SCHEDULE) | (eff == enc.EFFECT_NO_EXECUTE)
    )  # [1, Ts, MTt]
    schedulable = (~hard | tolerated).all(dim=-1)  # [Tl, Ts]
    prefer = valid & (eff == enc.EFFECT_PREFER_NO_SCHEDULE)
    prefer_untolerated = (prefer & ~tolerated).sum(dim=-1).to(torch.float32)
    return schedulable, prefer_untolerated


def _pair_lookup(table, row_ids, col_ids) -> torch.Tensor:
    """table[row_ids[p], col_ids[n]] for all (p, n) as f32, 0 where an id is
    out of range — the reference's two one-hot products, which are exact
    for these small tables, taken here as a direct gather."""
    A, B = table.shape
    rows_ok = (row_ids >= 0) & (row_ids < A)
    cols_ok = (col_ids >= 0) & (col_ids < B)
    t = table.to(torch.float32)
    out = t[row_ids.clamp(0, A - 1).long()][:, col_ids.clamp(0, B - 1).long()]
    zero = torch.zeros((), dtype=torch.float32, device=t.device)
    return torch.where(rows_ok[:, None] & cols_ok[None, :], out, zero)


def taint_filter_mask(snap) -> torch.Tensor:  # bool [P, N]
    schedulable, _ = toleration_tables(snap)
    return _pair_lookup(schedulable, snap.pod_tolset, snap.node_taintset) > 0.5


def taint_score_table(prefer: torch.Tensor, counts_max: torch.Tensor) -> torch.Tensor:
    """Normalized TaintToleration score from untolerated-PreferNoSchedule
    counts and their per-pod (or per-toleration-set) max over valid nodes:
    (1 - count / max) * 100, or 100 when no node has such taints."""
    return torch.where(
        counts_max > 0,
        (1.0 - prefer / torch.clamp(counts_max, min=1e-9)) * 100.0,
        torch.full((), 100.0, device=prefer.device),
    )


def taint_score(snap) -> torch.Tensor:  # f32 [P, N] in [0, 100]
    """TaintToleration score: fewer untolerated PreferNoSchedule taints is
    better, normalized by the max over ALL valid nodes (the reference's
    documented deviation from upstream)."""
    _, prefer = toleration_tables(snap)
    counts = _pair_lookup(prefer, snap.pod_tolset, snap.node_taintset)
    zero = torch.zeros((), dtype=torch.float32, device=counts.device)
    counts = torch.where(snap.node_valid[None, :], counts, zero)
    mx = counts.amax(dim=1, keepdim=True)  # [P, 1]
    return taint_score_table(counts, mx)
