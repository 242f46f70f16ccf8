"""The part of `k8s_scheduler_tpu/ops/interpod.py` the rounds engine and
`CycleContext` touch on snapshots without inter-pod affinity or topology
spread: selector matching against pending pods and the guard-active
selector sets. The affinity state, masks, scores and updates are ROADMAP
item A4."""

from __future__ import annotations

import torch

from . import labels as labels_ops


def selector_match(snap, label_keys, label_vals) -> torch.Tensor:  # [S, X]
    """Every deduplicated selector against every labeled subject."""
    em = labels_ops.expr_pod_mask(snap, label_keys, label_vals)  # [Ex, X]
    g = labels_ops._gather_expr(em, snap.sel_exprs, fill=True)  # [S, MSE, X]
    return g.all(dim=1)


def matched_pending(snap) -> torch.Tensor:  # bool [S, P]
    return selector_match(snap, snap.pod_label_keys, snap.pod_label_vals) & (
        snap.pod_valid[None, :]
    )


def _mark(terms_sel: torch.Tensor, S: int) -> torch.Tensor:
    """i32 selector ids (-1 pad) -> bool [S] referenced-set."""
    flat = terms_sel.reshape(-1)
    out = torch.zeros((S,), dtype=torch.bool, device=flat.device)
    return out.index_put_((flat[flat >= 0].long(),),
                          torch.ones((), dtype=torch.bool, device=flat.device))


def selector_activity(snap) -> tuple[torch.Tensor, torch.Tensor]:
    """(anti_active [S], spread_active [S]): selectors referenced by any
    required anti-affinity term (pending or existing pods) / any topology
    spread constraint."""
    S = snap.sel_exprs.shape[0]
    anti_active = _mark(snap.pod_anti_terms[..., 0], S) | _mark(
        snap.exist_anti_terms[..., 0], S
    )
    spread_active = _mark(snap.pod_tsc[..., 1], S)
    return anti_active, spread_active


def affinity_used(snap) -> torch.Tensor:
    """bool [S]: selectors named by a pending pod's required affinity."""
    return _mark(snap.pod_aff_terms[..., 0], snap.sel_exprs.shape[0])
