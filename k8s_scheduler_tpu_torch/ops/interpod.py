"""Inter-pod affinity and topology spread (`k8s_scheduler_tpu/ops/
interpod.py`), batched form: the rounds engine evaluates every pending pod
against the round-start state at once.

The state collapses to per-(selector, topology-domain) counts [S, D] plus
per-selector node tables [S, N] for the symmetric checks; label selectors
are deduplicated ([S] rows). Count lookups for every (key, selector, node)
form one [K*S, N] table (`counts_by_node`); a pod's terms pick rows of it
through a multi-hot [P, K*S] matrix.

The functions here keep the reference's algebra (multi-hot products,
`relu(cbn)`, `raw / hi * 100`, `(1 - raw / hi) * 100`) and are the plain
versions the hand kernels K3 (`ops/interpod_terms.py`) and K4
(`ops/affinity_update.py`) are held against. Every product here sums 0/1
or integer-valued f32 terms far below 2^24, so it is exact in any
summation order; matmuls run with TF32 off (chip_smoke.py sets it).

Semantics (reference module docstring): required affinity needs >= 1
matching pod in the node's domain, with the bootstrap rule (a pod matching
its own selector may place when no pod anywhere matches it); required
anti-affinity needs zero, in both directions (the [S, N] presence table);
preferred terms score both directions, normalized by max |raw| over the
pod's feasible nodes; a node missing the topology key cannot satisfy
affinity, cannot violate anti-affinity, and fails DoNotSchedule spread."""

from __future__ import annotations

import dataclasses

import torch

from ..models import encoding as enc
from . import labels as labels_ops


def selector_match(snap, label_keys, label_vals) -> torch.Tensor:  # [S, X]
    """Every deduplicated selector against every labeled subject. Only the
    expressions the selectors name are evaluated (the table also holds the
    node-affinity and PV-affinity expressions)."""
    sel = snap.sel_exprs
    used, inv = torch.unique(sel.clamp(min=0), return_inverse=True)
    em = labels_ops.expr_match(
        snap.ex_key[used], snap.ex_op[used], snap.ex_vals[used], snap.ex_num[used],
        label_keys, label_vals)  # [U, X]
    ids = torch.where(sel >= 0, inv.to(sel.dtype), -1)
    g = labels_ops._gather_expr(em, ids, fill=True)  # [S, MSE, X]
    return g.all(dim=1)


def matched_pending(snap) -> torch.Tensor:  # bool [S, P]
    return selector_match(snap, snap.pod_label_keys, snap.pod_label_vals) & (
        snap.pod_valid[None, :]
    )


def matched_existing(snap) -> torch.Tensor:  # bool [S, E]
    return selector_match(snap, snap.exist_label_keys, snap.exist_label_vals) & (
        snap.exist_valid[None, :]
    )


@dataclasses.dataclass
class AffinityState:
    """The affinity state the rounds carry (one per cycle)."""

    counts: torch.Tensor  # f32 [S, D] matching pods per (selector, domain)
    total: torch.Tensor  # f32 [S] matching pods anywhere (bootstrap rule)
    anti_presence: torch.Tensor  # bool [S, N] node blocked by anti(sel)
    pref_sym: torch.Tensor  # f32 [S, N] symmetric preferred-term weights


def _exist_domains(snap) -> torch.Tensor:  # i32 [E, K]
    safe_node = snap.exist_node.clamp(0, snap.N - 1).long()
    dom = snap.node_domains[safe_node]
    return torch.where((snap.exist_node >= 0)[:, None], dom, -1)


def initial_state(snap, m_exist: torch.Tensor) -> AffinityState:
    """Aggregate existing pods into the four state tables. The reference
    sums 0/1 one-hot products; the port scatter-adds ones, the same
    integers."""
    S, _ = m_exist.shape
    D = snap.domain_key.shape[0]
    K = snap.node_domains.shape[1]
    dom = _exist_domains(snap)  # [E, K]
    counts = torch.zeros((S * D,), dtype=torch.float32, device=snap.device)
    s_idx, e_idx = torch.nonzero(m_exist, as_tuple=True)
    for k in range(K):
        d = dom[e_idx, k].long()
        ok = d >= 0
        counts.index_add_(0, (s_idx * D + d)[ok],
                          torch.ones_like(d[ok], dtype=torch.float32))
    counts = counts.reshape(S, D)
    total = m_exist.to(torch.float32).sum(dim=1)
    if snap.has_inter_pod_affinity:
        anti = _flat_to_node(
            snap, _flat_table(snap.exist_anti_terms, None, dom, S, D), True
        )
        pref = _flat_to_node(
            snap,
            _flat_table(snap.exist_pref_aff, snap.exist_pref_aff_w, dom, S, D),
            False,
        )
    else:
        anti = torch.zeros((S, snap.N), dtype=torch.bool, device=snap.device)
        pref = torch.zeros((S, snap.N), dtype=torch.float32, device=snap.device)
    return AffinityState(counts, total, anti, pref)


def _flat_table(terms, weights, owner_dom, S, D):
    """Scatter every term (sel, k) of every owner into [S, D] at the
    owner's k-domain. terms [X, MA, 2], owner_dom [X, K]; weights None ->
    bool OR table, else f32 sum table (integer weights: exact)."""
    X, MA, _ = terms.shape
    K = owner_dom.shape[1]
    sel = terms[..., 0].reshape(-1)
    k = terms[..., 1].reshape(-1).clamp(0, K - 1).long()
    xi = torch.arange(X, device=terms.device).repeat_interleave(MA)
    d = owner_dom[xi, k]
    valid = (sel >= 0) & (d >= 0)
    flat = (sel[valid].long() * D + d[valid].long())
    if weights is None:
        out = torch.zeros((S * D,), dtype=torch.bool, device=terms.device)
        out[flat] = True
    else:
        out = torch.zeros((S * D,), dtype=torch.float32, device=terms.device)
        out.index_add_(0, flat, weights.reshape(-1)[valid])
    return out.reshape(S, D)


def _flat_to_node(snap, flat, bool_mode: bool):
    """[S, D] per-domain table -> [S, N] per-node table (a node is in one
    domain per topology key; flat ids are unique across keys)."""
    dtype = torch.bool if bool_mode else torch.float32
    out = torch.zeros((flat.shape[0], snap.N), dtype=dtype, device=flat.device)
    for k in range(snap.node_domains.shape[1]):
        nd = snap.node_domains[:, k]
        g = flat[:, nd.clamp(0, flat.shape[1] - 1).long()]  # [S, N]
        m = (nd >= 0)[None, :]
        if bool_mode:
            out = out | (g & m)
        else:
            out = out + torch.where(m, g, torch.zeros((), device=g.device))
    return out


def counts_by_node(snap, state: AffinityState) -> torch.Tensor:
    """[K*S, N] table: counts[s, domain(n, k)] for every (k, s, n); -1
    where node n has no domain for key k."""
    K = snap.node_domains.shape[1]
    _, D = state.counts.shape
    rows = []
    for k in range(K):
        nd = snap.node_domains[:, k]
        g = state.counts[:, nd.clamp(0, D - 1).long()]
        rows.append(torch.where((nd >= 0)[None, :], g,
                                torch.full((), -1.0, device=g.device)))
    return torch.cat(rows, dim=0)


def _row_index(snap, sel, k) -> torch.Tensor:
    S = snap.sel_exprs.shape[0]
    K = snap.node_domains.shape[1]
    return k.clamp(0, K - 1).long() * S + sel.clamp(0, S - 1).long()


def _row_onehot(snap, sel, k) -> torch.Tensor:  # f32 [P, K*S]
    """One-hot row selector for per-pod (selector, key) terms."""
    S = snap.sel_exprs.shape[0]
    K = snap.node_domains.shape[1]
    row = _row_index(snap, sel, k)
    ks = torch.arange(K * S, device=row.device)[None, :]
    return (row[:, None] == ks).to(torch.float32)


def _term_pick(snap, table, sel, k) -> torch.Tensor:  # f32 [P, N]
    """table[row(sel, k)] for every pod as a one-hot product (one nonzero
    per row: exact)."""
    return _row_onehot(snap, sel, k) @ table


def _multi_hot(snap, sel, k, w) -> torch.Tensor:  # [P, A] each -> f32 [P, K*S]
    """Weighted multi-hot term matrix: row (k, sel) accumulates w[:, a] over
    the term axis in slot order. Callers zero w for invalid slots;
    duplicate (sel, k) slots sum."""
    S = snap.sel_exprs.shape[0]
    K = snap.node_domains.shape[1]
    W = torch.zeros((sel.shape[0], K * S), dtype=torch.float32, device=sel.device)
    ks = torch.arange(K * S, device=sel.device)[None, :]
    zero = torch.zeros((), device=sel.device)
    for a in range(sel.shape[1]):
        row = _row_index(snap, sel[:, a], k[:, a])
        W = W + torch.where(row[:, None] == ks, w[:, a][:, None], zero)
    return W


def affinity_mask_batched(snap, state: AffinityState, m_pending,
                          cbn) -> torch.Tensor:  # bool [P, N]
    """Required affinity + anti-affinity + symmetric anti for all pods:
    satisfied-term counts against the needed count, anti hits against zero,
    and placed pods' anti terms whose selector matches the pod."""
    P = m_pending.shape[1]
    S = state.total.shape[0]
    pid = torch.arange(P, device=cbn.device)
    pos = (cbn > 0).to(torch.float32)  # [K*S, N]

    sel = snap.pod_aff_terms[..., 0]  # [P, MA]
    k = snap.pod_aff_terms[..., 1]
    scl = sel.clamp(0, S - 1).long()
    boot = (state.total[scl] == 0) & m_pending[scl, pid[:, None]]
    need = (sel >= 0) & ~boot
    W = _multi_hot(snap, sel, k, need.to(torch.float32))
    n_req = need.sum(dim=1).to(torch.float32)
    ok = (W @ pos) >= n_req[:, None] - 0.5

    a_sel = snap.pod_anti_terms[..., 0]
    a_k = snap.pod_anti_terms[..., 1]
    Wa = _multi_hot(snap, a_sel, a_k, (a_sel >= 0).to(torch.float32))
    ok &= (Wa @ pos) < 0.5
    return ok & ~symmetric_anti(state, m_pending)


def symmetric_anti(state: AffinityState, m_pending) -> torch.Tensor:
    """bool [P, N]: some placed pod's anti term whose selector matches the
    pod covers the node (a [P, S] x [S, N] product of 0/1 values)."""
    mT = m_pending.T.to(torch.float32)
    return (mT @ state.anti_presence.to(torch.float32)) > 0.0


def symmetric_pref(state: AffinityState, m_pending) -> torch.Tensor:
    """f32 [P, N]: placed pods' preferred weights toward the pod."""
    return m_pending.T.to(torch.float32) @ state.pref_sym


def affinity_raw_batched(snap, state: AffinityState, m_pending,
                         cbn) -> torch.Tensor:  # f32 [P, N]
    """Raw preferred-term sums: w * relu(count) over the pod's terms (one
    weighted multi-hot product) plus the symmetric direction."""
    sel = snap.pod_pref_aff[..., 0]
    k = snap.pod_pref_aff[..., 1]
    w = torch.where(sel >= 0, snap.pod_pref_aff_w, torch.zeros((), device=sel.device))
    raw = _multi_hot(snap, sel, k, w) @ torch.relu(cbn)
    return raw + symmetric_pref(state, m_pending)


def normalize_affinity(raw, feasible) -> torch.Tensor:
    """Per pod, raw / max|raw| over its feasible nodes * 100 (0 if none)."""
    zero = torch.zeros((), device=raw.device)
    hi = torch.where(feasible, raw.abs(), zero).amax(dim=1, keepdim=True)
    return torch.where(hi > 0, raw / hi * 100.0, zero)


def affinity_score_batched(snap, state: AffinityState, m_pending, cbn,
                           feasible) -> torch.Tensor:  # f32 [P, N]
    """Preferred-term score for all pods, in [-100, 100]."""
    return normalize_affinity(
        affinity_raw_batched(snap, state, m_pending, cbn), feasible
    )


def spread_minc(snap, state: AffinityState) -> torch.Tensor:  # f32 [K*S]
    """Min matching-pod count over eligible domains per (key, selector)."""
    K = snap.node_domains.shape[1]
    inf = torch.full((), float("inf"), device=state.counts.device)
    outs = []
    for k in range(K):
        eligible = (snap.domain_key == k) & (snap.domain_node_count > 0)
        m = torch.where(eligible[None, :], state.counts, inf).amin(dim=1)
        outs.append(torch.where(torch.isfinite(m), m, torch.zeros((), device=m.device)))
    return torch.cat(outs, dim=0)


def spread_mask_batched(snap, state: AffinityState, cbn,
                        minc) -> torch.Tensor:  # bool [P, N]
    """DoNotSchedule: count(dom) + 1 - minc <= maxSkew; no key fails."""
    ok = torch.ones((snap.P, snap.N), dtype=torch.bool, device=cbn.device)
    for c in range(snap.pod_tsc.shape[1]):
        k = snap.pod_tsc[:, c, 0]
        sel = snap.pod_tsc[:, c, 1]
        when = snap.pod_tsc[:, c, 2]
        cnt = _term_pick(snap, cbn, sel, k)
        mc = minc[_row_index(snap, sel, k)]
        skew = snap.pod_tsc_skew[:, c].to(torch.float32)
        viol = (cnt + 1.0 - mc[:, None] > skew[:, None]) | (cnt < 0)
        hard = (k >= 0) & (when == enc.WHEN_DO_NOT_SCHEDULE)
        ok &= torch.where(hard[:, None], ~viol, True)
    return ok


def spread_raw_batched(snap, cbn) -> torch.Tensor:  # f32 [P, N]
    """ScheduleAnyway raw: relu(count) summed over the soft constraints
    (one multi-hot product)."""
    k = snap.pod_tsc[..., 0]
    sel = snap.pod_tsc[..., 1]
    when = snap.pod_tsc[..., 2]
    soft = (k >= 0) & (when == enc.WHEN_SCHEDULE_ANYWAY)
    return _multi_hot(snap, sel, k, soft.to(torch.float32)) @ torch.relu(cbn)


def normalize_spread(raw, feasible) -> torch.Tensor:
    """Per pod, (1 - raw / max raw over feasible nodes) * 100 (100 if 0)."""
    zero = torch.zeros((), device=raw.device)
    hi = torch.where(feasible, raw, zero).amax(dim=1, keepdim=True)
    return torch.where(hi > 0, (1.0 - raw / hi) * 100.0,
                       torch.full((), 100.0, device=raw.device))


def spread_score_batched(snap, state: AffinityState, cbn,
                         feasible) -> torch.Tensor:  # f32 [P, N]
    return normalize_spread(spread_raw_batched(snap, cbn), feasible)


def affinity_update_batched(snap, state: AffinityState, m_pending,
                            accepted, node_of) -> AffinityState:
    """Fold a round's accepted placements (accepted bool [P], node_of i32
    [P]) into the state tables, with the reference's one-hot products
    (0/1 or integer-weight operands: exact)."""
    K = snap.node_domains.shape[1]
    S, D = state.counts.shape
    N = snap.N
    dev = state.counts.device
    acc_f = accepted.to(torch.float32)
    mp_acc = m_pending.to(torch.float32) * acc_f[None, :]  # [S, P]
    node_dom = snap.node_domains[node_of.clamp(0, N - 1).long()]  # [P, K]

    counts = state.counts
    d_ids = torch.arange(D, device=dev)[None, :]
    for k in range(K):
        d = torch.where(accepted, node_dom[:, k], -1)
        counts = counts + mp_acc @ (d[:, None] == d_ids).to(torch.float32)
    total = state.total + mp_acc.sum(dim=1)

    anti, pref = state.anti_presence, state.pref_sym
    if not snap.has_inter_pod_affinity:
        return AffinityState(counts, total, anti, pref)
    s_ids = torch.arange(S, device=dev)[None, :]
    ndT = snap.node_domains.T  # [K, N]
    zero = torch.zeros((), device=dev)

    def rows(terms, a):
        sel = terms[:, a, 0]
        k = terms[:, a, 1].clamp(0, K - 1).long()
        d = node_dom.gather(1, k[:, None])[:, 0]
        row = ((ndT[k] == d[:, None]) & (d >= 0)[:, None]
               & (sel >= 0)[:, None] & accepted[:, None])  # [P, N]
        return sel, row.to(torch.float32)

    for a in range(snap.pod_anti_terms.shape[1]):
        sel, row = rows(snap.pod_anti_terms, a)
        oh_s = (sel[:, None] == s_ids).to(torch.float32)  # [P, S]
        anti = anti | ((oh_s.T @ row) > 0.0)
        sel2, row2 = rows(snap.pod_pref_aff, a)
        w2 = snap.pod_pref_aff_w[:, a]
        oh_w = torch.where(sel2[:, None] == s_ids, w2[:, None], zero)
        pref = pref + oh_w.T @ row2
    return AffinityState(counts, total, anti, pref)


def _mark(terms_sel: torch.Tensor, S: int) -> torch.Tensor:
    """i32 selector ids (-1 pad) -> bool [S] referenced-set."""
    flat = terms_sel.reshape(-1)
    out = torch.zeros((S,), dtype=torch.bool, device=flat.device)
    out[flat[flat >= 0].long()] = True
    return out


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


def spread_min2(snap, counts) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per (key, selector): (min1 f32, argmin-domain i32, min2 f32) of the
    matching-pod counts over eligible domains, each [K*S].

    Preemption's what-if needs "min over domains EXCLUDING d" for the
    candidate node's domain d (evicting on one node only lowers that
    domain's count): min2 if argmin == d else min1. A (key, selector) with
    a single eligible domain gets min2 = 1e9; argmin is the first index of
    the minimum (0 when no domain is eligible)."""
    K = snap.node_domains.shape[1]
    _, D = counts.shape
    dev = counts.device
    inf = torch.full((), float("inf"), device=dev)
    d_ids = torch.arange(D, dtype=torch.int32, device=dev)[None, :]
    m1s, aas, m2s = [], [], []
    for k in range(K):
        eligible = (snap.domain_key == k) & (snap.domain_node_count > 0)
        vals = torch.where(eligible[None, :], counts, inf)  # [S, D]
        m1 = vals.amin(dim=1)
        a1 = torch.where(vals == m1[:, None], d_ids, D).amin(dim=1)
        m2 = torch.where(d_ids == a1[:, None], inf, vals).amin(dim=1)
        m1s.append(torch.where(torch.isfinite(m1), m1, torch.zeros((), device=dev)))
        aas.append(a1.to(torch.int32))
        m2s.append(torch.where(torch.isfinite(m2), m2, torch.full((), 1e9, device=dev)))
    return torch.cat(m1s), torch.cat(aas), torch.cat(m2s)


def anti_owner_counts(snap, assignment) -> torch.Tensor:  # f32 [S, D]
    """How many pods (running + placed this cycle) OWN a required anti-
    affinity term (sel, key) whose key-domain is d: the count version of
    AffinityState.anti_presence, which preemption needs to know whether
    evicting a node's victim prefix removes the last owner blocking a
    symmetric-anti candidate. Integer sums: exact in any order."""
    S = snap.sel_exprs.shape[0]
    D = snap.domain_key.shape[0]
    dev = snap.device
    ones_e = torch.ones(snap.exist_anti_terms.shape[:2], device=dev)
    cnt = _flat_table(snap.exist_anti_terms, ones_e, _exist_domains(snap), S, D)
    placed = snap.pod_valid & (assignment >= 0)
    node_dom = snap.node_domains[assignment.clamp(0, snap.N - 1).long()]
    terms_p = torch.where(placed[:, None, None], snap.pod_anti_terms, -1)
    ones_p = torch.ones(terms_p.shape[:2], device=dev)
    return cnt + _flat_table(terms_p, ones_p, node_dom, S, D)
