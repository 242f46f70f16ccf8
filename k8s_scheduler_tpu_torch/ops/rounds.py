"""Round-based batched commit (`k8s_scheduler_tpu/ops/rounds.py
rounds_commit`), wide path: a few ROUNDS replace the per-pod loop, each a
handful of batched passes.

  1. CLAIM  — every still-pending pod evaluates the plugin masks/scores
              against the round-start state and claims its best node
              (nominated node first, then the first-index argmax of
              round(score) + hash tie-break).
  2. ACCEPT — `passes` capacity passes: every unaccepted pod claims its
              best live choice with the node-local score re-anchored to
              the in-round node_req; claims resolve per node in rank order
              (K5 `capacity` over the (node, rank) sort); a loser that no
              longer fits the node alone marks that choice dead. One guard
              sweep at round end (K6 `guard_sweep`) revokes claims that
              conflict within the round: anti-affinity in both directions,
              affinity bootstrap, DoNotSchedule spread caps, hostPorts, and
              two claimants of one static PV (keyed by `pv_choice_fn`).
  3. UPDATE — accepted placements fold into the running state.

Round 0 covers the whole pending set; later rounds run over a compacted
view of the lowest-rank `compact_window(P)` actives. The loop is a Python
loop whose stop condition reads one device scalar per round, its one wait
for the device.

The reference's convergence counters (`rounds.py:753-757`, `:838-842`,
`:876-879`) stay on the device: K5 adds each pass's live claims and
capacity rejections, and each round-end fold's revocations, into the
round's row of one i32 [max_rounds, 3] table (`capacity`'s `diag`); a
round's acceptances are its live claims less both, since every accepted
claim was live in one pass and survives unless revoked.

Not in this slice: the shortlist path, one-hot compaction and the mesh
(ROADMAP A13)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..models import encoding as enc
from . import guard_sweep as gs
from . import interpod as interpod_ops
from .capacity import capacity
from .claim_pass import NEG_INF, claim_pass  # schedlint: disable=HY001 -- NEG_INF is re-exported: rounds.NEG_INF is the rounds engine's infeasible score its callers read
from .resources import fit_slack

MS_MATCH = 4  # guard-active selectors tracked per pod (overflow = defer)
_BIG = 2**31 - 1


@dataclasses.dataclass
class RoundsResult:
    assignment: torch.Tensor  # i32 [P] node index or -1
    node_requested: torch.Tensor  # f32 [N, R] post-commit
    extra: Any  # final plugin state
    placed_round: torch.Tensor  # i32 [P] round each pod was accepted in, or -1
    rounds_used: torch.Tensor  # i32 [] rounds run (round 0 included)
    accepted_per_round: torch.Tensor  # i32 [max_rounds] acceptances a round
    diag_per_round: torch.Tensor  # i32 [max_rounds, 3] a round's (live
    # claims, capacity rejections, guard revocations), summed over passes


def compact_window(P: int, compact: int = 8) -> int:
    """Row count of the compacted per-round view: the `P/compact`
    lowest-rank actives, padded to a multiple of 128."""
    return min(P, max(256, -(-P // compact) // 128 * 128))


def _matched_active(m_pending, active_sel, ms: int):
    """Per-pod list of up to `ms` guard-active selectors it matches:
    (sels i32 [P, ms] ascending, -1 pad; overflow bool [P])."""
    S, _ = m_pending.shape
    remaining = (m_pending & active_sel[:, None]).T  # [P, S]
    sel_ids = torch.arange(S, dtype=torch.int32, device=m_pending.device)[None, :]
    cols = []
    for _ in range(ms):
        cand = torch.where(remaining, sel_ids, S)
        nxt = cand.amin(dim=1).to(torch.int32)  # [P]
        cols.append(torch.where(nxt < S, nxt, -1))
        remaining = remaining & (sel_ids != nxt[:, None])
    return torch.stack(cols, dim=1), remaining.any(dim=1)


def _pod_view(snap, gid: torch.Tensor):
    """A snapshot whose pod-axis arrays are gathered at `gid`."""
    g = gid.long()
    updates = {
        f.name: getattr(snap, f.name)[g]
        for f in dataclasses.fields(snap)
        if f.name.startswith("pod_") and isinstance(getattr(snap, f.name), torch.Tensor)
    }
    return dataclasses.replace(snap, **updates)


def _host_table(values, dev) -> torch.Tensor:
    """i32 [n] of host values on `dev`; on the card by a pinned copy that
    does not wait for the device (a pageable one would)."""
    t = torch.tensor(values, dtype=torch.int32)
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


def _owner_state(ext_state):
    for v in ext_state.values():
        if isinstance(v, interpod_ops.AffinityState):
            return v
    return None


def rounds_commit(
    *,
    snap,
    sbase: torch.Tensor,  # f32 [P, N] static base (NEG_INF where infeasible)
    m_pending: torch.Tensor,  # bool [S, P]
    # (vsnap, vmp, node_req, ext, vsbase, act_v) -> (mask, base), [B, N]:
    # the static row and the dynamic filters ANDed with act_v, and vsbase
    # plus the dynamic scores (`Framework.dyn_batched`)
    dyn_batched_view_fn: Callable,
    update_batched_view_fn: Callable,  # (vsnap, vmp, ext, accepted, node_of) -> ext
    extra: Any,
    max_rounds: int = 64,
    compact: int = 8,
    passes: int = 6,
    passes_round0: int = 10,
    score_anchor_fn: Callable | None = None,  # node_requested -> f32 [N]
    claim_pass_fn: Callable = claim_pass,
    capacity_fn: Callable = capacity,
    guard_sweep_fn: Callable = gs.guard_sweep,
    pv_choice_fn: Callable | None = None,  # (vsnap, node_of, live, ext)
    # -> i32 [B, MVol] chosen static PV per claimant and slot (-1 none): the
    # guard keeps the first claimant by rank of each PV
) -> RoundsResult:
    if snap.has_volumes and pv_choice_fn is None:
        raise ValueError("rounds_commit: a snapshot with volumes needs pv_choice_fn "
                         "(the static-PV guard)")
    P, N = sbase.shape
    dev = sbase.device
    S = m_pending.shape[0]
    D = snap.domain_key.shape[0]
    K = snap.node_domains.shape[1]
    MA = snap.pod_anti_terms.shape[1]
    MC = snap.pod_tsc.shape[1]
    Q = snap.num_distinct_ports
    V = snap.pv_avail.shape[0]
    MPorts = snap.pod_port_ids.shape[1]
    rank_g = snap.pod_order.to(torch.int32)  # [P] lower = earlier
    rank_bits = int(P - 1).bit_length()
    rank_space = 1 << rank_bits  # active ranks are < P

    anti_active, spread_active = interpod_ops.selector_activity(snap)
    active_sel = anti_active | spread_active | interpod_ops.affinity_used(snap)
    matched_sels_g, overflow_g = _matched_active(m_pending, active_sel, MS_MATCH)

    has_guards = bool(snap.has_inter_pod_affinity or snap.has_topology_spread)
    has_port_guards = Q > 0
    # group-key space as in the reference: domain groups, per-selector
    # global groups, (node, port) groups, static-PV groups, invalid
    GK_GLOBAL = S * (D + 1)
    GK_PORT = GK_GLOBAL + S
    GK_PV = GK_PORT + N * Q
    GK_INVALID = GK_PV + V + 1
    has_pv_guards = bool(snap.has_volumes)

    alloc = snap.node_allocatable  # [N, R]
    slack = fit_slack(alloc)

    def guards_ok(vsnap, vrank, vsels, choice, live, ext_state):
        """Participant-table sweep over the round's accepted claims: within
        a (selector, domain) / (node, port) group, entries resolve in rank
        order (K6 after the sort). ok bool [B]."""
        B = vrank.shape[0]
        state = _owner_state(ext_state) if has_guards else None
        if state is None and not has_port_guards and not has_pv_guards:
            return torch.ones(B, dtype=torch.bool, device=dev)
        nsafe = choice.clamp(0, N - 1).long()
        keys, roles, caps = [], [], []

        def emit(key, valid, role, cap=None):
            keys.append(torch.where(valid & live, key, GK_INVALID))
            roles.append(role)
            caps.append(cap)

        def dom_key(sel, d):
            return sel.clamp(0, S - 1).long() * (D + 1) + (d.long() + 1)

        if state is not None:
            node_dom = snap.node_domains[nsafe]  # [B, K]
            boot_active = state.total == 0  # [S]
            if snap.has_inter_pod_affinity:
                for a in range(MA):
                    sel = vsnap.pod_anti_terms[:, a, 0]
                    k = vsnap.pod_anti_terms[:, a, 1].clamp(0, K - 1).long()
                    d = node_dom.gather(1, k[:, None])[:, 0]
                    emit(dom_key(sel, d), (sel >= 0) & (d >= 0), gs.RB_ANTI)
                for a in range(MA):
                    sel = vsnap.pod_aff_terms[:, a, 0]
                    scl = sel.clamp(0, S - 1).long()
                    emit(GK_GLOBAL + scl, (sel >= 0) & boot_active[scl], gs.RB_BOOT)
            if snap.has_topology_spread:
                minc = interpod_ops.spread_minc(snap, state)  # [K*S]
                for c in range(MC):
                    k = vsnap.pod_tsc[:, c, 0]
                    sel = vsnap.pod_tsc[:, c, 1]
                    when = vsnap.pod_tsc[:, c, 2]
                    kcl = k.clamp(0, K - 1).long()
                    d = node_dom.gather(1, kcl[:, None])[:, 0]
                    scl = sel.clamp(0, S - 1).long()
                    hard = (k >= 0) & (when == enc.WHEN_DO_NOT_SCHEDULE) & (d >= 0)
                    cnt = state.counts[scl, d.clamp(0, D - 1).long()]
                    cap = ((vsnap.pod_tsc_skew[:, c].to(torch.float32) - cnt)
                           + minc[kcl * S + scl]).to(torch.int32)
                    emit(dom_key(sel, d), hard, gs.RB_SPREAD, cap=cap.clamp(min=1))
            # matchers feed the anti guard and the spread arrival counts
            for m in range(MS_MATCH):
                sel = vsels[:, m]
                scl = sel.clamp(0, S - 1).long()
                for k in range(K):
                    d = node_dom[:, k]
                    emit(dom_key(sel, d), (sel >= 0) & (d >= 0), gs.RB_MATCH)
                if snap.has_inter_pod_affinity:
                    emit(GK_GLOBAL + scl, (sel >= 0) & boot_active[scl], gs.RB_GMATCH)
        if has_port_guards:
            for j in range(MPorts):
                ids = vsnap.pod_port_ids[:, j]
                emit(GK_PORT + nsafe * Q + ids.clamp(0, Q - 1).long(), ids >= 0,
                     gs.RB_PORT)
        if has_pv_guards:
            # one entry per (claimant, slot) naming the PV it would bind
            pvc = pv_choice_fn(vsnap, nsafe.to(torch.int32), live, ext_state)
            for j in range(pvc.shape[1]):
                ids = pvc[:, j]
                emit(GK_PV + ids.clamp(0, V - 1).long(), ids >= 0, gs.RB_PV)

        keys_c = torch.stack(keys, dim=0).reshape(-1)  # slot-major [slots * B]
        ranks_c = vrank.clamp(max=rank_space - 1).long().repeat(len(keys))
        s_packed, perm = torch.sort(keys_c * rank_space + ranks_c, stable=True)
        caps_c = None
        if any(c is not None for c in caps):
            no_cap = torch.full((B,), gs.NO_CAP, dtype=torch.int32, device=dev)
            caps_c = torch.stack([no_cap if c is None else c for c in caps]).reshape(-1)
        role_tab = _host_table(roles, dev)
        return guard_sweep_fn(s_packed, perm, rank_bits, B, role_tab, caps_c,
                              GK_INVALID)

    diag = torch.zeros((max_rounds, 3), dtype=torch.int32, device=dev)

    def one_round(gid, act_v, node_req, ext, n_passes: int, identity: bool, rnd: int):
        B = gid.shape[0]
        if identity:
            vsnap, vmp, vsbase = snap, m_pending, sbase
            vrank, vsels, vovf = rank_g, matched_sels_g, overflow_g
        else:
            g = gid.long()
            vsnap = _pod_view(snap, gid)
            vmp = m_pending[:, g]
            vsbase = sbase[g]
            vrank, vsels, vovf = rank_g[g], matched_sels_g[g], overflow_g[g]
        mask, base = dyn_batched_view_fn(vsnap, vmp, node_req, ext, vsbase, act_v)
        anchor0 = score_anchor_fn(node_req) if score_anchor_fn is not None else None
        pid = torch.arange(B, device=dev)
        req = vsnap.pod_requested
        rkey = vrank.clamp(max=rank_space - 1).long()

        def resolve_capacity(live, best, node_req):
            """Rank-ordered capacity resolution of one pass's claims:
            (accepted bool [B], node_req')."""
            nkey = torch.where(live, best, N).long()
            s_key, order = torch.sort(nkey * rank_space + rkey, stable=True)
            return capacity_fn(s_key, order, rank_bits, req, node_req, alloc,
                               slack, True, diag[rnd])

        def fits_alone_at(best, node_req):
            # a capacity loser keeps the node alive if it still fits ALONE
            # in the node's post-pass free space
            b = best.clamp(0, N - 1).long()
            return torch.all(
                req <= (alloc[b] - node_req[b]) + slack[b], dim=1
            )

        def pick_overflow(has, acc, normal):
            # overflow claimants are accepted only alone: lowest rank, iff
            # the round is still empty-handed
            allow = ~acc.any() & ~normal.any()
            ovf_rank = torch.where(has & vovf, vrank, _BIG).amin()
            return has & vovf & (vrank == ovf_rank) & allow

        acc = torch.zeros(B, dtype=torch.bool, device=dev)
        acc_node = torch.full((B,), -1, dtype=torch.int32, device=dev)
        dead = torch.zeros((B, N), dtype=torch.bool, device=dev)
        nominated = vsnap.pod_nominated
        for t in range(n_passes):
            delta = None
            if anchor0 is not None and t > 0:
                # nodes that filled this round lose attractiveness NOW
                delta = score_anchor_fn(node_req) - anchor0
            best, has = claim_pass_fn(base, mask, dead, acc, delta, gid, nominated)
            has = has & act_v & vsnap.pod_valid & ~acc
            normal = has & ~vovf
            live = normal
            if t == n_passes - 1:
                live = normal | pick_overflow(has, acc, normal)
            accepted_t, node_req = resolve_capacity(live, best, node_req)
            acc = acc | accepted_t
            acc_node = torch.where(accepted_t, best, acc_node)
            lost = live & ~accepted_t & ~fits_alone_at(best, node_req)
            dead[pid, best.long()] |= lost

        # round-end guard sweep over ALL capacity-accepted claims; revoked
        # pods retry next round against refreshed masks
        g_ok = guards_ok(vsnap, vrank, vsels, acc_node, acc, ext)
        revoked = acc & ~g_ok
        s_key, order = torch.sort(torch.where(revoked, acc_node, N).long(),
                                  stable=True)
        _, node_req = capacity_fn(s_key, order, 0, -req, node_req, alloc,
                                  slack, False, diag[rnd])
        acc = acc & g_ok
        acc_node = torch.where(acc, acc_node, -1)
        ext = update_batched_view_fn(
            vsnap, vmp, ext, acc, torch.where(acc, acc_node, 0)
        )
        return acc, acc_node, node_req, ext

    # ---- round 0: full pending set ----
    gid0 = torch.arange(P, dtype=torch.int32, device=dev)
    acc0, node0, node_req, extra = one_round(
        gid0, snap.pod_valid, snap.node_requested, extra, passes_round0, True, 0
    )
    placed = torch.where(acc0, node0, -1)
    placed_round = torch.where(acc0, 0, -1).to(torch.int32)
    active = snap.pod_valid & ~acc0

    # ---- rounds 1+: compacted to the lowest-rank actives. A zero-accept
    # round advances the window by B over the rank order instead of
    # stopping, so the loop ends only after every active pod had a full-
    # mask check against the final state ("unplaced => infeasible"). ----
    B = compact_window(P, compact)
    skip = torch.where(acc0.any(), 0, P)
    span = torch.arange(B, device=dev)
    rnd = 1
    while rnd < max_rounds and bool(skip < active.sum()):
        key = torch.where(active, rank_g, _BIG)
        order = torch.argsort(key, stable=True).to(torch.int32)
        start = torch.clamp(skip, max=max(P - B, 0))
        gid = order[start + span]
        act_v = active[gid.long()]
        accepted, node_of, node_req, extra = one_round(
            gid, act_v, node_req, extra, passes, False, rnd
        )
        g = gid.long()
        placed[g] = torch.where(accepted, node_of, placed[g])
        placed_round[g] = torch.where(accepted, rnd, placed_round[g])
        active[g] = act_v & ~accepted
        skip = torch.where(accepted.any(), 0, skip + B)
        rnd += 1

    return RoundsResult(
        assignment=placed.to(torch.int32),
        node_requested=node_req,
        extra=extra,
        placed_round=placed_round,
        rounds_used=torch.full((), rnd, dtype=torch.int32, device=dev),
        accepted_per_round=diag[:, 0] - diag[:, 1] - diag[:, 2],
        diag_per_round=diag,
    )
