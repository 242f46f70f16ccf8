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
              (sorted segmented prefix of requests); a loser that no longer
              fits the node alone marks that choice dead. One guard sweep
              at round end revokes claims that conflict within the round
              (hostPort exclusivity in this slice).
  3. UPDATE — accepted placements fold into the running state.

Round 0 covers the whole pending set; later rounds run over a compacted
view of the lowest-rank `compact_window(P)` actives. The loop is a Python
loop whose stop condition reads one device scalar per round.

Not in this slice: the shortlist path, one-hot compaction, the mesh, and
the anti-affinity/spread/bootstrap/PV guard roles (ROADMAP A4, A13) — a
snapshot that needs them raises NotImplementedError."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from . import interpod as interpod_ops
from .claim_pass import NEG_INF, claim_pass
from .resources import fit_slack

MS_MATCH = 4  # guard-active selectors tracked per pod (overflow = defer)
_BIG = 2**31 - 1


@dataclasses.dataclass
class RoundsResult:
    assignment: torch.Tensor  # i32 [P] node index or -1
    node_requested: torch.Tensor  # f32 [N, R] post-commit
    extra: Any  # final plugin state


def compact_window(P: int, compact: int = 8) -> int:
    """Row count of the compacted per-round view: the `P/compact`
    lowest-rank actives, padded to a multiple of 128."""
    return min(P, max(256, -(-P // compact) // 128 * 128))


def index_add_exact(target: torch.Tensor, idx: torch.Tensor,
                    rows: torch.Tensor) -> torch.Tensor:
    """target + (rows summed per index), with each index's sum taken in f64
    in a fixed order and rounded once: deterministic on every device, and
    equal to the reference's f32 one-hot product wherever that is exact."""
    if idx.numel() == 0:
        return target
    order = torch.argsort(idx, stable=True)
    s_idx = idx[order].long()
    s_rows = rows[order].to(torch.float64)
    cum = torch.cumsum(s_rows, dim=0)
    last = torch.ones_like(s_idx, dtype=torch.bool)
    last[:-1] = s_idx[1:] != s_idx[:-1]
    ends = cum[last]
    totals = ends - torch.cat([ends.new_zeros((1,) + ends.shape[1:]), ends[:-1]])
    return target.index_add(0, s_idx[last], totals.to(target.dtype))


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


def _seg_scan_tables(keys, pods, counts: dict[str, torch.Tensor]):
    """Entries sorted by (key, rank): for each 0/1 indicator column, the
    in-segment count strictly before each entry's POD (one pod's own
    entries never block each other)."""
    L = keys.shape[0]
    i = torch.arange(L, device=keys.device)
    first = torch.ones((1,), dtype=torch.bool, device=keys.device)
    seg_start = torch.cat([first, keys[1:] != keys[:-1]])
    run_start = seg_start | torch.cat([first, pods[1:] != pods[:-1]])
    seg_first = torch.cummax(torch.where(seg_start, i, -1), dim=0).values
    run_first = torch.cummax(torch.where(run_start, i, -1), dim=0).values
    names = list(counts)
    x = torch.stack([counts[n] for n in names], dim=1).to(torch.int64)
    before = torch.cumsum(x, dim=0) - x
    delta = before[run_first] - before[seg_first]
    return {n: delta[:, c] for c, n in enumerate(names)}


def rounds_commit(
    *,
    snap,
    sbase: torch.Tensor,  # f32 [P, N] static base (NEG_INF where infeasible)
    m_pending: torch.Tensor,  # bool [S, P]
    dyn_batched_view_fn: Callable,  # (vsnap, vmp, node_req, ext, vsmask) -> (mask, score)
    update_batched_view_fn: Callable,  # (vsnap, vmp, ext, accepted, node_of) -> ext
    extra: Any,
    max_rounds: int = 64,
    compact: int = 8,
    passes: int = 6,
    passes_round0: int = 10,
    score_anchor_fn: Callable | None = None,  # node_requested -> f32 [N]
    claim_pass_fn: Callable = claim_pass,
) -> RoundsResult:
    if snap.has_inter_pod_affinity or snap.has_topology_spread:
        raise NotImplementedError(
            "rounds guards for inter-pod affinity / topology spread are not "
            "ported yet (ROADMAP A4)"
        )
    if snap.has_volumes:
        raise NotImplementedError(
            "the rounds engine's static-PV guard is not ported yet (ROADMAP A4)"
        )
    P, N = sbase.shape
    dev = sbase.device
    S = m_pending.shape[0]
    D = snap.domain_key.shape[0]
    Q = snap.num_distinct_ports
    V = snap.pv_avail.shape[0]
    MPorts = snap.pod_port_ids.shape[1]
    rank_g = snap.pod_order.to(torch.int32)  # [P] lower = earlier
    rank_space = 1 << int(P - 1).bit_length()  # active ranks are < P

    anti_active, spread_active = interpod_ops.selector_activity(snap)
    active_sel = anti_active | spread_active | interpod_ops.affinity_used(snap)
    # the per-pod matched-selector lists feed the anti-affinity/spread guard
    # roles (A4); this slice reads only their overflow flags
    _, overflow_g = _matched_active(m_pending, active_sel, MS_MATCH)

    # group-key space as in the reference: domain groups, per-selector
    # global groups, (node, port) groups, static-PV groups, invalid
    GK_PORT = S * (D + 1) + S
    GK_INVALID = GK_PORT + N * Q + V + 1

    alloc = snap.node_allocatable  # [N, R]
    slack = fit_slack(alloc)

    def guards_ok(vsnap, vrank, choice, live):
        """Participant-table sweep over the round's accepted claims: within
        a (node, port) group the lowest rank wins. ok bool [B]."""
        B = vrank.shape[0]
        nsafe = choice.clamp(0, N - 1).to(torch.int64)
        keys = []
        for j in range(MPorts):
            ids = vsnap.pod_port_ids[:, j]
            key = GK_PORT + nsafe * Q + ids.clamp(0, Q - 1).to(torch.int64)
            keys.append(torch.where((ids >= 0) & live, key, GK_INVALID))
        keys_c = torch.stack(keys, dim=0).reshape(-1)
        ranks_c = vrank.clamp(max=rank_space - 1).to(torch.int64).repeat(len(keys))
        order = torch.argsort(keys_c * rank_space + ranks_c, stable=True)
        keys_s = keys_c[order]
        pods_s = order % B
        before = _seg_scan_tables(
            keys_s, pods_s, {"port": torch.ones_like(keys_s)}
        )
        ok_e = (before["port"] == 0) | (keys_s == GK_INVALID)
        ok = torch.ones(B, dtype=torch.bool, device=dev)
        ok[pods_s[~ok_e]] = False
        return ok

    def one_round(gid, act_v, node_req, ext, n_passes: int, identity: bool):
        B = gid.shape[0]
        if identity:
            vsnap, vmp, vsbase = snap, m_pending, sbase
            vrank, vovf = rank_g, overflow_g
        else:
            g = gid.long()
            vsnap = _pod_view(snap, gid)
            vmp = m_pending[:, g]
            vsbase = sbase[g]
            vrank, vovf = rank_g[g], overflow_g[g]
        vsmask = vsbase > NEG_INF * 0.5
        mask, score = dyn_batched_view_fn(vsnap, vmp, node_req, ext, vsmask)
        mask = mask & vsmask & act_v[:, None]
        base = vsbase + score
        anchor0 = score_anchor_fn(node_req) if score_anchor_fn is not None else None
        pid = torch.arange(B, device=dev)
        req = vsnap.pod_requested

        def resolve_capacity(live, best, node_req):
            """Rank-ordered capacity resolution of one pass's claims:
            (accepted bool [B], node_req')."""
            nkey = torch.where(live, best, N).to(torch.int64)
            rkey = vrank.clamp(max=rank_space - 1).to(torch.int64)
            s_key, order = torch.sort(nkey * rank_space + rkey, stable=True)
            s_node = s_key // rank_space
            s_live = s_node < N
            s_req = torch.where(s_live[:, None], req[order], 0.0)
            # segmented exclusive prefix within each node's run, in f64
            # (exact for request sums of any realistic size)
            cum = torch.cumsum(s_req.to(torch.float64), dim=0)
            before = cum - s_req.to(torch.float64)
            i = torch.arange(B, device=dev)
            seg_start = torch.ones(B, dtype=torch.bool, device=dev)
            seg_start[1:] = s_node[1:] != s_node[:-1]
            seg_first = torch.cummax(torch.where(seg_start, i, -1), dim=0).values
            seg_before = (before - before[seg_first]).to(torch.float32)
            nsafe = s_node.clamp(0, N - 1)
            free = (alloc[nsafe] - node_req[nsafe]) + slack[nsafe]
            fits = torch.all(seg_before + s_req <= free, dim=1) & s_live
            accepted = torch.zeros(B, dtype=torch.bool, device=dev)
            accepted[order] = fits
            node_req = index_add_exact(node_req, best[accepted], req[accepted])
            return accepted, node_req

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
        g_ok = guards_ok(vsnap, vrank, acc_node, acc)
        revoked = acc & ~g_ok
        node_req = index_add_exact(node_req, acc_node[revoked], -req[revoked])
        acc = acc & g_ok
        acc_node = torch.where(acc, acc_node, -1)
        ext = update_batched_view_fn(
            vsnap, vmp, ext, acc, torch.where(acc, acc_node, 0)
        )
        return acc, acc_node, node_req, ext

    # ---- round 0: full pending set ----
    gid0 = torch.arange(P, dtype=torch.int32, device=dev)
    acc0, node0, node_req, extra = one_round(
        gid0, snap.pod_valid, snap.node_requested, extra, passes_round0, True
    )
    placed = torch.where(acc0, node0, -1)
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
            gid, act_v, node_req, extra, passes, False
        )
        g = gid.long()
        placed[g] = torch.where(accepted, node_of, placed[g])
        active[g] = act_v & ~accepted
        skip = torch.where(accepted.any(), 0, skip + B)
        rnd += 1

    return RoundsResult(
        assignment=placed.to(torch.int32),
        node_requested=node_req,
        extra=extra,
    )
