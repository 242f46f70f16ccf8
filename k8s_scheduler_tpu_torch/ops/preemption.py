"""Preemption (`k8s_scheduler_tpu/ops/preemption.py`): the DefaultPreemption
PostFilter as a batched what-if program, run after the latency cycle.

The encoder's `node_pods` table lists each node's running pods ascending
by priority, so every candidate victim set is a PREFIX of that list: the
remove-then-re-add minimisation collapses to "the smallest prefix k whose
freed resources make the pod fit". Three device stages, each a function
passed to `run_preemption` (as `build_cycle_fn` takes K1-K6):

  1. prefilter (K7 `preempt_prefilter`): the `budget` lowest-rank
     unschedulable pods against the pristine post-cycle state, one
     [C, N, MPN+1] pass; a candidate with no feasible (node, prefix)
     never gains one, since contention only shrinks feasibility.
  2. what-if (K8 `preempt_whatif`): for the `scan_budget` lowest-rank
     survivors, bool [C2, N, MPN+1] — do the candidate's evictable
     non-resource constraints hold once the prefix is gone (required
     anti-affinity, required affinity or its bootstrap, symmetric anti-
     affinity owners, DoNotSchedule skew with a min1/argmin/min2 table,
     hostPorts held by victims; ports of this cycle's winners never
     clear)?
  3. claim loop (K9 `preempt_claim`): the survivors in rank order, one
     nomination each: PDB violations per prefix, prefix fit against what
     earlier nominations claimed, first feasible prefix per node, the
     node by (violations, highest victim priority, victim priority sum,
     victim count, latest start of the highest victim, lowest index).

The `*_plain` functions here are the plain torch versions the kernels are
held against, in the reference's algebra; gathers replace the reference's
one-hot products where those have one nonzero per row (exact either way).

Numerics: `prefix_freed` reproduces XLA's CPU cumsum order (sequential in
chunks of 16, chunk totals carried sequentially), so non-dyadic requests
give the reference's bits; the fit slack is `resources.fit_slack`'s fused
multiply-add; integer prefix sums wrap as i32."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..models import encoding as enc
from . import interpod as interpod_ops
from . import argsel
from .argsel import wrap_i32
from .resources import fit_slack

DEFAULT_BUDGET = 256  # candidates prefiltered per cycle
DEFAULT_SCAN_BUDGET = 64  # nominations per cycle
BIG_I32 = 2**31 - 1
_SCAN_CHUNK = 16  # XLA's CPU reduce-window scan chunk
MAX_PODS_PER_NODE = _SCAN_CHUNK * _SCAN_CHUNK  # one carry level


@dataclasses.dataclass
class PreemptionResult:
    nominated: torch.Tensor  # i32 [P] node nominated by preemption (-1 none)
    victims: torch.Tensor  # bool [E] running pods to evict
    num_preemptors: torch.Tensor  # i32 [] pods that got a nomination


@dataclasses.dataclass
class VictimTables:
    """Per-node victim tables, shared by every candidate."""

    node_pods: torch.Tensor  # i32 [N, MPN] running pods, ascending priority
    vict_prio: torch.Tensor  # i32 [N, MPN] (BIG_I32 at empty slots)
    vict_start: torch.Tensor  # f32 [N, MPN] start time (0 at empty slots)
    vict_pdb: torch.Tensor  # i32 [N, MPN, MB] covering PDB ids (-1 pad)
    prefix_freed: torch.Tensor  # f32 [N, MPN+1, R] freed by the first k
    prefix_prio: torch.Tensor  # i32 [N, MPN+1] priority sum of the first k


def prefix_sums_f32(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Inclusive f32 prefix sums along `dim` in XLA's CPU order for
    `jnp.cumsum`: left to right within chunks of 16 entries; from the second
    chunk on, each entry is (running total of the earlier chunks) + (its
    in-chunk prefix). Elementwise adds only, so every device gives the same
    bits."""
    L = x.shape[dim]
    if L > MAX_PODS_PER_NODE:
        raise ValueError(f"prefix_sums_f32: {L} entries > {MAX_PODS_PER_NODE}")
    cols = x.unbind(dim)
    out = []
    carry = None
    for c0 in range(0, L, _SCAN_CHUNK):
        s = None
        for j in range(c0, min(L, c0 + _SCAN_CHUNK)):
            s = cols[j] if s is None else s + cols[j]
            out.append(s if carry is None else carry + s)
        carry = s if carry is None else carry + s
    return torch.stack(out, dim=dim)


def victim_tables(snap) -> VictimTables:
    E = snap.exist_valid.shape[0]
    node_pods = snap.node_pods
    valid = node_pods >= 0
    safe = node_pods.clamp(0, E - 1).long()
    zero = torch.zeros((), device=snap.device)
    vict_prio = torch.where(valid, snap.exist_priority[safe], BIG_I32)
    vict_req = torch.where(valid[..., None], snap.exist_requested[safe], zero)
    vict_start = torch.where(valid, snap.exist_start[safe], zero)
    vict_pdb = torch.where(valid[..., None], snap.exist_pdb[safe], -1)
    prefix_freed = torch.cat(
        [torch.zeros_like(vict_req[:, :1]), prefix_sums_f32(vict_req, 1)], dim=1)
    prio = torch.where(valid, vict_prio, 0)
    prefix_prio = torch.cat(
        [torch.zeros_like(prio[:, :1]), wrap_i32(torch.cumsum(prio, dim=1))], dim=1)
    return VictimTables(node_pods, vict_prio, vict_start, vict_pdb,
                        prefix_freed, prefix_prio)


# --------------------------------------------------------------------------
# stage 1: batched prefilter
# --------------------------------------------------------------------------


def prefilter_plain(
    prio: torch.Tensor,  # i32 [C] candidate priorities
    req: torch.Tensor,  # f32 [C, R] candidate requests
    cand_ok: torch.Tensor,  # bool [C] real unschedulable candidate
    vict_prio: torch.Tensor,  # i32 [N, MPN]
    prefix_freed: torch.Tensor,  # f32 [N, MPN+1, R]
    free0: torch.Tensor,  # f32 [N, R] (alloc - node_requested) + slack
    gate: torch.Tensor,  # bool [C, N] static candidate gate
    node_valid: torch.Tensor,  # bool [N]
) -> torch.Tensor:  # bool [C]
    """Does any (node, prefix k in [1, elig]) fit the candidate against the
    post-cycle state? elig = victims strictly below its priority (empty
    slots hold BIG_I32 and never count)."""
    _, MPN = vict_prio.shape
    elig = (vict_prio[None] < prio[:, None, None]).sum(dim=2)  # [C, N]
    room = free0[:, None, :] + prefix_freed  # [N, MPN+1, R]
    fits = (req[:, None, None, :] <= room[None]).all(dim=-1)  # [C, N, MPN+1]
    ks = torch.arange(MPN + 1, device=prio.device)
    allowed = fits & (ks >= 1) & (ks <= elig[:, :, None])
    return (allowed & (gate & node_valid[None, :])[:, :, None]).any(dim=2).any(dim=1) & cand_ok


# --------------------------------------------------------------------------
# stage 2: non-resource what-if
# --------------------------------------------------------------------------


@dataclasses.dataclass
class WhatIfInputs:
    """Everything the what-if reads, gathered for the C2 scan candidates.
    The affinity/spread tables are None when the snapshot has neither."""

    node_pods: torch.Tensor  # i32 [N, MPN]
    node_domains: torch.Tensor  # i32 [N, K]
    ports: torch.Tensor  # i32 [C2, MPorts] candidate host ports (-1 pad)
    exist_ports: torch.Tensor  # i32 [E, MEP]
    winner_conf: torch.Tensor  # bool [C2, N] a placed pod holds a wanted port
    has_affinity: bool
    has_spread: bool
    anti: torch.Tensor | None = None  # i32 [C2, MA, 2] (selector, key)
    aff: torch.Tensor | None = None  # i32 [C2, MA, 2]
    tsc: torch.Tensor | None = None  # i32 [C2, MC, 3] (key, selector, when)
    tsc_skew: torch.Tensor | None = None  # i32 [C2, MC]
    counts: torch.Tensor | None = None  # f32 [S, D] final-state counts
    total: torch.Tensor | None = None  # f32 [S]
    mp_c: torch.Tensor | None = None  # bool [C2, S] candidate matches selector
    me: torch.Tensor | None = None  # bool [S, E] running pod matches selector
    exist_anti: torch.Tensor | None = None  # i32 [E, MA, 2]
    row_d: torch.Tensor | None = None  # f32 [C2, D] anti owners matching
    sp_min1: torch.Tensor | None = None  # f32 [K*S]
    sp_amin: torch.Tensor | None = None  # i32 [K*S]
    sp_min2: torch.Tensor | None = None  # f32 [K*S]


def whatif_inputs(ctx, cids, assignment, placed, node_of_placed) -> WhatIfInputs:
    """The what-if's inputs for scan candidates `cids` (i32 [C2]): the
    final-state affinity tables (K4 folds every placement into the initial
    state), the symmetric-owner row product (`torch.matmul` of 0/1 and
    integer counts, exact with TF32 off), spread's min1/argmin/min2, and
    the winner-port table as a scatter of placed pods."""
    snap = ctx.snap
    C2, N = cids.shape[0], snap.N
    dev = snap.device
    cl = cids.long()
    pp = snap.pod_ports[cl]  # [C2, MPorts]
    conflict = torch.zeros((C2, snap.P), dtype=torch.bool, device=dev)
    for m in range(pp.shape[1]):
        hit = (snap.pod_ports[None, :, :] == pp[:, m, None, None]).any(dim=2)
        conflict |= hit & (pp[:, m] >= 0)[:, None]
    conflict &= placed[None, :]
    wc = torch.zeros((C2, N), dtype=torch.float32, device=dev)
    wc.index_add_(1, node_of_placed.long(), conflict.to(torch.float32))
    x = WhatIfInputs(
        node_pods=snap.node_pods, node_domains=snap.node_domains, ports=pp,
        exist_ports=snap.exist_ports, winner_conf=wc > 0.5,
        has_affinity=bool(snap.has_inter_pod_affinity),
        has_spread=bool(snap.has_topology_spread),
    )
    if not (x.has_affinity or x.has_spread):
        return x
    mp = ctx.matched_pending
    state_f = ctx.kernels.affinity_update(
        snap, ctx.initial_affinity_state(), mp, placed, node_of_placed)
    x.counts, x.total = state_f.counts, state_f.total
    x.mp_c = mp[:, cl].T.contiguous()
    x.me = ctx.matched_existing
    if x.has_affinity:
        x.anti, x.aff = snap.pod_anti_terms[cl], snap.pod_aff_terms[cl]
        x.exist_anti = snap.exist_anti_terms
        x.row_d = x.mp_c.to(torch.float32) @ interpod_ops.anti_owner_counts(snap, assignment)
    if x.has_spread:
        x.tsc, x.tsc_skew = snap.pod_tsc[cl], snap.pod_tsc_skew[cl]
        x.sp_min1, x.sp_amin, x.sp_min2 = interpod_ops.spread_min2(snap, x.counts)
    return x


def nonresource_ok_plain(x: WhatIfInputs) -> torch.Tensor:  # bool [C2, N, MPN+1]
    C2 = x.ports.shape[0]
    N, MPN = x.node_pods.shape
    E = x.exist_ports.shape[0]
    dev = x.node_pods.device
    valid = x.node_pods >= 0
    safe = x.node_pods.clamp(0, E - 1).long()
    ok = torch.ones((C2, N, MPN + 1), dtype=torch.bool, device=dev)

    def cum3(v):  # [C2, N, MPN] small integers -> [C2, N, MPN+1] prefix sums
        return torch.cat([torch.zeros_like(v[:, :, :1]), torch.cumsum(v, dim=2)], dim=2)

    if x.has_affinity or x.has_spread:
        S, D = x.counts.shape
        K = x.node_domains.shape[1]
        nd = x.node_domains
        cbn = torch.cat([  # [K*S, N] count at each node's k-domain, -1 none
            torch.where(nd[:, k][None, :] >= 0, x.counts[:, nd[:, k].clamp(0, D - 1).long()],
                        torch.full((), -1.0, device=dev))
            for k in range(K)])
        me_vic = x.me[:, safe] & valid[None]  # [S, N, MPN]

        def term_m_vic(sel):  # [C2] -> f32 [C2, N, MPN] victim matches selector
            return me_vic[sel.clamp(0, S - 1).long()].to(torch.float32)

        def cnt_at(sel, key):  # [C2, N]
            return cbn[key.clamp(0, K - 1).long() * S + sel.clamp(0, S - 1).long()]

    if x.has_affinity:
        for a in range(x.anti.shape[1]):
            sel, key = x.anti[:, a, 0], x.anti[:, a, 1]
            cnt = cnt_at(sel, key)
            after = cnt[:, :, None] - cum3(term_m_vic(sel))
            ok &= (sel < 0)[:, None, None] | (cnt < -0.5)[:, :, None] | (after <= 0.5)
        rows = torch.arange(C2, device=dev)
        for a in range(x.aff.shape[1]):
            sel, key = x.aff[:, a, 0], x.aff[:, a, 1]
            scl = sel.clamp(0, S - 1).long()
            cnt = cnt_at(sel, key)
            cum = cum3(term_m_vic(sel))
            after = cnt[:, :, None] - cum
            boot = ((x.total[scl][:, None, None] - cum) <= 0.5) & x.mp_c[rows, scl][:, None, None]
            ok &= (sel < 0)[:, None, None] | boot | ((cnt > -0.5)[:, :, None] & (after > 0.5))
        # symmetric: every evictable OWNER of an anti term matching the
        # candidate must fall inside the prefix
        sym_tot = torch.zeros((C2, N), dtype=torch.float32, device=dev)
        for k in range(K):
            dn = nd[:, k]
            g = x.row_d[:, dn.clamp(0, D - 1).long()]
            sym_tot = sym_tot + torch.where(dn[None, :] >= 0, g, torch.zeros((), device=dev))
        terms_v = x.exist_anti[safe]  # [N, MPN, MA, 2]
        sel_v, key_v = terms_v[..., 0], terms_v[..., 1]
        MA = sel_v.shape[2]
        domk = nd.gather(1, key_v.clamp(0, K - 1).reshape(N, -1).long()).reshape(N, MPN, MA)
        valid_v = (sel_v >= 0) & (domk >= 0) & valid[:, :, None]
        owns = x.mp_c[:, sel_v.clamp(0, S - 1).reshape(-1).long()].reshape(C2, N, MPN, MA)
        w = (owns & valid_v[None]).to(torch.float32).sum(dim=3)
        ok &= (sym_tot[:, :, None] - cum3(w)) <= 0.5
    if x.has_spread:
        for c in range(x.tsc.shape[1]):
            key, sel, when = x.tsc[:, c, 0], x.tsc[:, c, 1], x.tsc[:, c, 2]
            skew = x.tsc_skew[:, c].to(torch.float32)
            hard = (key >= 0) & (when == enc.WHEN_DO_NOT_SCHEDULE)
            cnt = cnt_at(sel, key)
            after = cnt[:, :, None] - cum3(term_m_vic(sel))
            kcl = key.clamp(0, K - 1).long()
            row = kcl * S + sel.clamp(0, S - 1).long()
            dnc = nd.T[kcl]  # [C2, N]
            mexcl = torch.where(dnc == x.sp_amin[row][:, None], x.sp_min2[row][:, None],
                                x.sp_min1[row][:, None])
            min_after = torch.minimum(mexcl[:, :, None], after)
            viol = (after + 1.0 - min_after > skew[:, None, None]) | (cnt < -0.5)[:, :, None]
            ok &= torch.where(hard[:, None, None], ~viol, True)
    # hostPorts: every running holder of a wanted port must be in the
    # prefix; ports held by this cycle's winners never clear
    vic_ports = x.exist_ports[safe]  # [N, MPN, MEP]
    conf = torch.zeros((C2, N, MPN), dtype=torch.bool, device=dev)
    for m in range(x.ports.shape[1]):
        pm = x.ports[:, m]
        hit = (vic_ports[None] == pm[:, None, None, None]).any(dim=3)
        conf |= hit & (pm >= 0)[:, None, None]
    conf &= valid[None]
    cum_c = cum3(conf.to(torch.float32))
    ports_ok = (cum_c[:, :, -1:] - cum_c <= 0.5) & ~x.winner_conf[:, :, None]
    has_p = (x.ports >= 0).any(dim=1)
    return ok & torch.where(has_p[:, None, None], ports_ok, True)


# --------------------------------------------------------------------------
# stage 3: serial claim loop
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ClaimInputs:
    n_live: torch.Tensor  # i32 [1] live ranks (they sort first)
    live: torch.Tensor  # bool [C2]
    prio: torch.Tensor  # i32 [C2] candidate priority, by rank
    req: torch.Tensor  # f32 [C2, R]
    port_ids: torch.Tensor  # i32 [C2, MPorts] ids into Q (-1 pad)
    gate: torch.Tensor  # bool [C2, N]
    ok_nr: torch.Tensor  # bool [C2, N, MPN+1] what-if
    node_valid: torch.Tensor  # bool [N]
    alloc: torch.Tensor  # f32 [N, R]
    node_requested: torch.Tensor  # f32 [N, R] post-cycle
    slack: torch.Tensor  # f32 [N, R]
    pdb_allowed: torch.Tensor  # i32 [GP]
    tables: VictimTables
    num_existing: int  # E
    num_ports: int  # Q


@dataclasses.dataclass
class ClaimCarry:
    k_claimed: torch.Tensor  # i32 [N] victims already claimed per node
    nominated_req: torch.Tensor  # f32 [N, R] requests nominated per node
    victims: torch.Tensor  # bool [E]
    pdb_used: torch.Tensor  # i32 [GP] budget spent this cycle
    claimed_q: torch.Tensor  # bool [N, Q] ports nominated pods will hold


def claim_carry0(x: ClaimInputs) -> ClaimCarry:
    N = x.node_valid.shape[0]
    dev = x.node_valid.device
    return ClaimCarry(
        torch.zeros(N, dtype=torch.int32, device=dev),
        torch.zeros_like(x.node_requested),
        torch.zeros(x.num_existing, dtype=torch.bool, device=dev),
        torch.zeros_like(x.pdb_allowed),
        torch.zeros((N, x.num_ports), dtype=torch.bool, device=dev),
    )


def claim_loop_plain(x: ClaimInputs) -> tuple[torch.Tensor, ClaimCarry]:
    """(nominated node per rank i32 [C2], final carry): one nomination per
    live rank, in rank order, each against what earlier ranks claimed."""
    t = x.tables
    N, MPN = t.node_pods.shape
    E, Q = x.num_existing, x.num_ports
    GP = x.pdb_allowed.shape[0]
    dev = t.node_pods.device
    valid = t.node_pods >= 0
    safe = t.node_pods.clamp(0, E - 1).long()
    ks = torch.arange(MPN + 1, dtype=torch.int32, device=dev)
    pos = torch.arange(MPN, dtype=torch.int32, device=dev)
    gids = torch.arange(GP, dtype=torch.int32, device=dev)
    memb = (t.vict_pdb[:, :, :, None] == gids).any(dim=2) & valid[:, :, None]  # [N, MPN, GP]
    ordinal = torch.cumsum(memb.to(torch.int32), dim=1)  # inclusive, <= MPN
    inf = torch.full((), float("inf"), device=dev)
    room0 = x.alloc - x.node_requested
    cy = claim_carry0(x)
    noms = torch.full((x.live.shape[0],), -1, dtype=torch.int32, device=dev)
    for rank in range(int(x.n_live.item())):
        elig = (t.vict_prio < x.prio[rank]).sum(dim=1)  # [N]
        # a victim VIOLATES when its ordinal among the NEW victims of its
        # group exceeds the group's remaining budget
        budget_rem = x.pdb_allowed - cy.pdb_used
        claimed_cnt = (memb & (pos[None, :, None] < cy.k_claimed[:, None, None])).sum(dim=1)
        prot = (memb & (ordinal - claimed_cnt[:, None, :] > budget_rem)).any(dim=2) & valid
        cum_prot = torch.cat([torch.zeros((N, 1), dtype=torch.int64, device=dev),
                              torch.cumsum(prot.to(torch.int64), dim=1)], dim=1)
        free_base = (room0 - cy.nominated_req) + x.slack
        fits = (x.req[rank] <= free_base[:, None, :] + t.prefix_freed).all(dim=-1)
        qp = x.port_ids[rank]
        claimed_conf = (cy.claimed_q[:, qp.clamp(0, Q - 1).long()] & (qp >= 0)).any(dim=1)
        kc = cy.k_claimed
        allowed = (fits & x.ok_nr[rank] & ~claimed_conf[:, None]
                   & (ks >= kc[:, None]) & (ks <= elig[:, None]))
        exists = allowed.any(dim=1)
        k_min = torch.where(exists, torch.where(allowed, ks, MPN + 1).amin(dim=1), 0)
        candidate = x.gate[rank] & x.node_valid & exists & (k_min > kc)

        def pick(tab, idx):
            return tab.gather(1, idx.long()[:, None])[:, 0]

        last = (k_min - 1).clamp(0, MPN - 1)
        keys = (
            (pick(cum_prot, k_min) - pick(cum_prot, kc), BIG_I32),  # violations
            (pick(t.vict_prio, last), BIG_I32),  # highest victim priority
            (wrap_i32(pick(t.prefix_prio, k_min).long() - pick(t.prefix_prio, kc)),
             BIG_I32),  # victim priority sum
            (k_min - kc, BIG_I32),  # victim count
            (-pick(t.vict_start, last), inf),  # latest start of the highest
        )
        best = candidate
        for key, big in keys:
            kk = torch.where(best, key, big)
            best = best & (kk == kk.amin())
        b = argsel.argmax_first(best.to(torch.int32), dim=0).long()
        do = x.live[rank] & candidate.any()
        noms[rank] = torch.where(do, b.to(torch.int32), -1)
        kcb, kmb = kc[b], k_min[b]
        newly = do & (pos >= kcb) & (pos < kmb) & valid[b]
        vic = cy.victims.to(torch.int32)
        vic.index_add_(0, safe[b], newly.to(torch.int32))
        cy.victims = vic > 0
        for bb in range(t.vict_pdb.shape[2]):
            g = t.vict_pdb[b, :, bb]
            cy.pdb_used.index_add_(0, g.clamp(0, GP - 1).long(),
                                   (newly & (g >= 0)).to(torch.int32))
        cy.k_claimed[b] = torch.where(do, kmb, kcb)
        cy.nominated_req[b] = cy.nominated_req[b] + torch.where(do, x.req[rank], 0.0)
        row = cy.claimed_q[b].to(torch.int32)
        row.index_add_(0, qp.clamp(0, Q - 1).long(), (do & (qp >= 0)).to(torch.int32))
        cy.claimed_q[b] = row > 0
    return noms, cy


# --------------------------------------------------------------------------
# the pass
# --------------------------------------------------------------------------


def run_preemption(
    ctx,
    *,
    assignment: torch.Tensor,  # i32 [P] cycle placements (-1 unplaced)
    node_requested: torch.Tensor,  # f32 [N, R] post-cycle requests
    gate_rows: Callable,  # ids i32 [C] -> bool [C, N] static gate, no NodePorts
    prefilter_fn: Callable,
    whatif_fn: Callable,
    claim_fn: Callable,
    excluded: torch.Tensor | None = None,  # bool [P] never preempt (gang-dropped)
    budget: int = DEFAULT_BUDGET,
    scan_budget: int = DEFAULT_SCAN_BUDGET,
) -> PreemptionResult:
    snap = ctx.snap
    P = snap.P
    placed = snap.pod_valid & (assignment >= 0)
    node_of_placed = torch.where(placed, assignment, 0)
    vt = victim_tables(snap)
    slack = fit_slack(snap.node_allocatable)

    unsched = snap.pod_valid & (assignment < 0) & snap.pod_can_preempt
    if excluded is not None:
        unsched = unsched & ~excluded
    # the budgeted lowest-rank candidates, rank order kept (stable sort)
    C = min(P, budget)
    cand_key = torch.where(unsched, snap.pod_order, BIG_I32)
    cand_ids = torch.sort(cand_key, stable=True).indices[:C]
    gate_c = gate_rows(cand_ids.to(torch.int32))
    feasible = prefilter_fn(
        snap.pod_priority[cand_ids], snap.pod_requested[cand_ids], unsched[cand_ids],
        vt.vict_prio, vt.prefix_freed,
        (snap.node_allocatable - node_requested) + slack, gate_c, snap.node_valid)

    C2 = min(C, scan_budget)
    key2 = torch.where(feasible, snap.pod_order[cand_ids], BIG_I32)
    sel2 = torch.sort(key2, stable=True).indices[:C2]
    cids2 = cand_ids[sel2]
    live2 = feasible[sel2]
    ok_nr = whatif_fn(whatif_inputs(ctx, cids2.to(torch.int32), assignment, placed,
                                    node_of_placed))
    noms, carry = claim_fn(ClaimInputs(
        n_live=live2.sum().to(torch.int32).reshape(1), live=live2,
        prio=snap.pod_priority[cids2], req=snap.pod_requested[cids2],
        port_ids=snap.pod_port_ids[cids2], gate=gate_c[sel2], ok_nr=ok_nr,
        node_valid=snap.node_valid, alloc=snap.node_allocatable,
        node_requested=node_requested, slack=slack, pdb_allowed=snap.pdb_allowed,
        tables=vt, num_existing=snap.exist_valid.shape[0],
        num_ports=int(snap.num_distinct_ports)))
    nominated = torch.full((P,), -1, dtype=torch.int32, device=snap.device)
    nominated.scatter_reduce_(0, cids2, noms, reduce="amax")
    return PreemptionResult(
        nominated=nominated,
        victims=carry.victims & snap.exist_valid,
        num_preemptors=(nominated >= 0).sum().to(torch.int32),
    )
