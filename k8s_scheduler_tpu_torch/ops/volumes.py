"""VolumeBinding (`k8s_scheduler_tpu/ops/volumes.py`): per pod and node,
whether the pod's PVCs can be satisfied there, and which static PVs its
placement claims.

  - a BOUND PVC (mode 0) restricts the pod to nodes its PV's nodeAffinity
    admits;
  - an UNBOUND WaitForFirstConsumer PVC (mode 1) needs an available static
    PV of its class and size that the node admits, or dynamic provisioning
    whose class allowedTopologies admit the node;
  - a missing PVC or an unbound Immediate claim (mode 2) is unschedulable.

Multi-volume pods are admitted jointly by Hall's condition over their
unbound slots (`_hall_ok`) and claim with the SDR-safe choice
(`_sdr_safe_choice`); same-cycle contention for one static PV is
arbitrated by rank (`fold_pv_claims`, and the rounds engine's PV guard
keyed by `chosen_pv_slots`).

These are the plain versions, in the reference's algebra: the candidate
tests are dense [P, V] x [V, N] count products. Where the reference takes
the expression mask and builds the [Rq, N] requirement table inside each
function, these take the table (`req`), built once per cycle. Three of
them have hand-written kernels with the same function: K10
`ops/volume_mask.py` (`volume_mask` / `volume_mask_unbound`), K11
`ops/pv_choice.py` (`chosen_pv_slots`) and K12 `ops/pv_fold.py`
(`fold_pv_claims`); `VolumeTables` holds what they read."""

from __future__ import annotations

import dataclasses
import itertools

import torch

from . import labels as labels_ops

_CAP_EPS = 1e-3  # added in f32: a no-op at 400 GiB, as in the reference
_BIG = 2**31 - 1


def pv_node_table(snap, req):  # bool [V, N]
    """Per-PV node admissibility (nodeAffinity through the shared
    requirement table) AND pre-cycle availability."""
    return labels_ops.take_rows(req, snap.pv_req_id, True) & snap.pv_avail[:, None]


def pod_pv_cand(snap, j):  # bool [P, V] class+size candidacy for slot j
    cls = snap.pod_vol_class[:, j]
    size = snap.pod_vol_size[:, j]
    return (
        (snap.pv_class[None, :] == cls[:, None])
        & ((snap.pv_capacity[None, :] + _CAP_EPS) >= size[:, None])
        & (snap.pod_vol_mode[:, j] == 1)[:, None]
    )


def _hall_subsets(MVol: int):
    """Slot subsets (size >= 2) whose Hall condition the joint-admission
    check enumerates: all of them up to MVol = 6; beyond, the pairs and the
    full set, with the per-pod dominance groups covering the rest (exact
    for laminar candidate families)."""
    if MVol > 6:
        return [*itertools.combinations(range(MVol), 2), tuple(range(MVol))]
    return [s for r in range(2, MVol + 1)
            for s in itertools.combinations(range(MVol), r)]


def _membership(cands, a, t):
    """bool [...]: is slot t's candidate set contained in slot a's, per pod
    (the dominance-group membership test)."""
    return ~torch.any(cands[t] & ~cands[a], dim=-1)


def _hall_ok(pv_ok_f, cands, dyn_oks, modes, ok):
    """Joint feasibility across a pod's unbound slots: for every enumerated
    subset, the union of the slots' candidate PVs usable on the node has at
    least as many members as the subset has slots that need a static PV."""
    MVol = len(cands)
    for s in _hall_subsets(MVol):
        u = cands[s[0]]
        for j in s[1:]:
            u = u | cands[j]
        avail = u.to(torch.float32) @ pv_ok_f  # [P, N] counts
        need = sum(((modes[j] == 1)[:, None] & ~dyn_oks[j]).to(torch.int32)
                   for j in s)
        ok = ok & ((avail + 0.5) >= need.to(torch.float32))
    if MVol > 6:
        for a in range(MVol):
            need = None
            for t in range(MVol):
                member = _membership(cands, a, t)  # [P]
                n_t = (member[:, None] & (modes[t] == 1)[:, None]
                       & ~dyn_oks[t]).to(torch.int32)
                need = n_t if need is None else need + n_t
            avail = cands[a].to(torch.float32) @ pv_ok_f
            ok = ok & ((avail + 0.5) >= need.to(torch.float32))
    return ok


def _slot_masks(snap, req, pv_ok, unbound: bool):
    P, N = snap.P, snap.N
    pv_ok_f = pv_ok.to(torch.float32)
    MVol = snap.pod_vol_mode.shape[1]
    ok = torch.ones((P, N), dtype=torch.bool, device=snap.device)
    cands, dyn_oks, modes = [], [], []
    for j in range(MVol):
        mode = snap.pod_vol_mode[:, j]
        rid = snap.pod_vol_req[:, j]
        rid_rows = labels_ops.take_rows(req, rid, True)  # -1 -> all True
        cand = pod_pv_cand(snap, j)  # [P, V]
        static_ok = (cand.to(torch.float32) @ pv_ok_f) > 0.0
        dyn_ok = torch.where((rid == -2)[:, None], False, rid_rows)
        if unbound:
            row_ok = torch.where((mode == 1)[:, None], static_ok | dyn_ok, True)
        else:
            row_ok = torch.where(
                (mode == 0)[:, None], rid_rows,
                torch.where((mode == 1)[:, None], static_ok | dyn_ok, False))
            row_ok = torch.where((mode >= 0)[:, None], row_ok, True)
        ok = ok & row_ok
        cands.append(cand)
        dyn_oks.append(dyn_ok)
        modes.append(mode)
    if MVol >= 2 and snap.has_multi_volume:
        ok = _hall_ok(pv_ok_f, cands, dyn_oks, modes, ok)
    return ok


def volume_mask(snap, req, pv_claimed=None) -> torch.Tensor:
    """Conjunction over each pod's PVC constraints -> bool [P, N].
    `pv_claimed` (bool [V]) marks static PVs this cycle's placements
    claimed; None is the pre-cycle availability (the static mask)."""
    pv_ok = pv_node_table(snap, req)
    if pv_claimed is not None:
        pv_ok = pv_ok & ~pv_claimed[:, None]
    return _slot_masks(snap, req, pv_ok, unbound=False)


def volume_mask_unbound(snap, req, pv_claimed) -> torch.Tensor:
    """The claim-dependent residue of volume_mask: only unbound slots
    (mode 1) re-evaluate against the live `pv_claimed`."""
    pv_ok = pv_node_table(snap, req) & ~pv_claimed[:, None]
    return _slot_masks(snap, req, pv_ok, unbound=True)


def _sdr_other_subsets(MVol: int, j: int):
    """Subsets (size >= 1) of the slots other than `j` whose Hall margin
    the SDR-safe choice checks: all of them up to 6 other slots; beyond,
    singletons, pairs and the full rest (dominance groups cover the rest)."""
    others = [t for t in range(MVol) if t != j]
    if len(others) <= 6:
        return [s for r in range(1, len(others) + 1)
                for s in itertools.combinations(others, r)]
    return [*itertools.combinations(others, 1),
            *itertools.combinations(others, 2), tuple(others)]


def _sdr_safe_choice(cand_j, cands, needy, dyn_j, MVol, j):
    """SDR-preserving candidate choice for slot j, batched over pods: the
    lowest-index v in cand_j whose removal keeps Hall's condition over
    every enumerated subset of the other needy slots; with none safe, a
    dynamic-capable slot rides dynamic (-1) and a needy one takes its
    lowest candidate. i32 [P]."""
    P, V = cand_j.shape
    dev = cand_j.device
    unsafe = torch.zeros((P, V), dtype=torch.bool, device=dev)

    def mark(u, need):
        avail = u.sum(dim=1, dtype=torch.int32)
        return u & (avail <= need)[:, None]

    for s in _sdr_other_subsets(MVol, j):
        u = torch.zeros((P, V), dtype=torch.bool, device=dev)
        need = torch.zeros((P,), dtype=torch.int32, device=dev)
        for t in s:
            u = u | (cands[t] & needy[:, t][:, None])
            need = need + needy[:, t].to(torch.int32)
        unsafe = unsafe | mark(u, need)
    others = [t for t in range(MVol) if t != j]
    if len(others) > 6:
        for a in others:
            u = torch.zeros((P, V), dtype=torch.bool, device=dev)
            need = torch.zeros((P,), dtype=torch.int32, device=dev)
            for t in others:
                member = _membership(cands, a, t) & needy[:, t]
                u = u | (cands[t] & member[:, None])
                need = need + member.to(torch.int32)
            unsafe = unsafe | mark(u, need)
    safe = cand_j & ~unsafe
    ids = torch.arange(V, dtype=torch.int32, device=dev)[None, :]
    best_safe = torch.where(safe, ids, V).amin(dim=1).to(torch.int32)
    best_any = torch.where(cand_j, ids, V).amin(dim=1).to(torch.int32)
    minus1 = torch.full_like(best_safe, -1)
    return torch.where(
        best_safe < V, best_safe,
        torch.where(dyn_j, minus1, torch.where(best_any < V, best_any, minus1)))


def _dyn_at_node(snap, req, node_of):  # bool [P, MVol]
    """Whether each slot can ride dynamic provisioning at the pod's node."""
    Rq = req.shape[0]
    nsafe = node_of.clamp(0, snap.N - 1).long()
    req_at = req[:, nsafe].T  # [P, Rq]
    rid = snap.pod_vol_req  # [P, MVol]
    picked = torch.gather(req_at, 1, rid.clamp(0, Rq - 1).long())
    return torch.where(rid == -2, False, torch.where(rid >= 0, picked, True))


def _at_node(snap, req, pv_claimed, node_of):  # bool [P, V]
    pv_ok = pv_node_table(snap, req) & ~pv_claimed[:, None]
    return pv_ok[:, node_of.clamp(0, snap.N - 1).long()].T


def chosen_pv(snap, req, pv_claimed, node_of, active, j):
    """i32 [P]: the lowest-index compatible available unclaimed PV each
    active pod's slot j would claim at `node_of`, -1 for none (the single-
    volume path)."""
    V = snap.pv_avail.shape[0]
    cand = pod_pv_cand(snap, j) & _at_node(snap, req, pv_claimed, node_of)
    cand = cand & active[:, None]
    ids = torch.arange(V, dtype=torch.int32, device=cand.device)[None, :]
    best = torch.where(cand, ids, V).amin(dim=1).to(torch.int32)
    return torch.where(best < V, best, -1)


def chosen_pv_sdr(snap, req, pv_claimed, node_of, pending_slots, j, mine=None):
    """i32 [P]: the SDR-safe claim for slot j (multi-volume). `mine` (bool
    [P, V]) excludes PVs the pod already claimed in the same pass."""
    MVol = snap.pod_vol_mode.shape[1]
    at_node = _at_node(snap, req, pv_claimed, node_of)
    if mine is not None:
        at_node = at_node & ~mine
    dyn = _dyn_at_node(snap, req, node_of)  # [P, MVol]
    cands = [pod_pv_cand(snap, t) & at_node for t in range(MVol)]
    needy = pending_slots & (snap.pod_vol_mode == 1) & ~dyn
    active = pending_slots[:, j]
    ch = _sdr_safe_choice(cands[j] & active[:, None], cands, needy, dyn[:, j],
                          MVol, j)
    return torch.where(active, ch, -1)


def _multi(snap) -> bool:
    return snap.pod_vol_mode.shape[1] >= 2 and bool(snap.has_multi_volume)


def chosen_pv_slots(snap, req, pv_claimed, node_of, active):
    """i32 [P, MVol]: the claims a contention-free fold pass would make per
    active pod (slots in index order, SDR-safe when multi-volume, intra-pod
    distinctness by `mine`) — the rounds engine's PV guard key."""
    MVol = snap.pod_vol_mode.shape[1]
    V = snap.pv_avail.shape[0]
    P = node_of.shape[0]
    multi = _multi(snap)
    pending = active[:, None].expand(P, MVol) & (snap.pod_vol_mode == 1)
    mine = torch.zeros((P, V), dtype=torch.bool, device=node_of.device)
    rows = torch.arange(P, device=node_of.device)
    out = []
    for j in range(MVol):
        if multi:
            ch = chosen_pv_sdr(snap, req, pv_claimed, node_of, pending, j, mine=mine)
        else:
            ch = chosen_pv(snap, req, pv_claimed, node_of, pending[:, j], j)
        out.append(ch)
        has = ch >= 0
        mine = mine.clone()
        mine[rows[has], ch[has].long()] = True
        pending = pending.clone()
        pending[:, j] = False
    return torch.stack(out, dim=1)


def fold_pv_claims(snap, req, pv_claimed, accepted, node_of, rank):
    """Fold a batch of placements' static-PV claims into `pv_claimed` as a
    rank-ordered sequential pass would: each pass, slot by slot, every
    unresolved claimant picks its PV (lowest index, SDR-safe when
    multi-volume) against the current bitmap and the lowest rank per PV
    wins; losers retry next pass. The first pass always runs; the loop
    ends when a pass claims nothing or nothing is pending (the reference's
    `while_loop`, here a host loop)."""
    return fold_pv_claims_passes(snap, req, pv_claimed, accepted, node_of, rank)[0]


def fold_pv_claims_passes(snap, req, pv_claimed, accepted, node_of, rank):
    """`fold_pv_claims` and the number of passes it took: (bool [V], int)."""
    V = snap.pv_avail.shape[0]
    P = accepted.shape[0]
    MVol = snap.pod_vol_mode.shape[1]
    multi = _multi(snap)
    dev = accepted.device
    claimed = pv_claimed.clone()
    pending = accepted[:, None].expand(P, MVol) & (snap.pod_vol_mode == 1)
    passes = 0
    while True:
        passes += 1
        progress = torch.zeros((), dtype=torch.bool, device=dev)
        for j in range(MVol):
            if multi:
                ch = chosen_pv_sdr(snap, req, claimed, node_of, pending, j)
            else:
                ch = chosen_pv(snap, req, claimed, node_of, pending[:, j], j)
            has = ch >= 0
            chc = ch.clamp(0, V - 1).long()
            winner = torch.full((V,), _BIG, dtype=torch.int32, device=dev)
            winner = winner.scatter_reduce(
                0, chc, torch.where(has, rank, _BIG), "amin", include_self=True)
            won = has & (rank == winner[chc])
            claimed = claimed.clone()
            claimed[chc[won]] = True
            pending = pending.clone()
            pending[:, j] = pending[:, j] & ~won & has
            progress = progress | won.any()
        if not bool(progress & pending.any()):
            return claimed, passes


@dataclasses.dataclass
class VolumeTables:
    """What the volume kernels read besides the pod rows, built once per
    cycle (`volume_tables`): the requirement rows, and the available PVs as
    lists — per node (a CSR over nodes, ascending PV index) those whose
    nodeAffinity admits the node, and one global list of those without
    nodeAffinity. Claims made during the cycle are checked against the
    live bitmap, not removed from the lists."""

    req: torch.Tensor  # bool [Rq, N]
    node_off: torch.Tensor  # i32 [N + 1]
    node_pv: torch.Tensor  # i32 [L]
    global_pv: torch.Tensor  # i32 [G]


def volume_tables(snap, req) -> VolumeTables:
    dev = snap.device
    avail = snap.pv_avail
    aff = torch.nonzero(avail & (snap.pv_req_id >= 0), as_tuple=True)[0]
    rows = req[snap.pv_req_id[aff].clamp(0, req.shape[0] - 1).long()]  # [Va, N]
    nn, vv = torch.nonzero(rows.T, as_tuple=True)  # by node, then PV index
    counts = torch.bincount(nn, minlength=snap.N)
    node_off = torch.zeros(snap.N + 1, dtype=torch.int32, device=dev)
    node_off[1:] = torch.cumsum(counts, 0).to(torch.int32)
    glob = torch.nonzero(avail & (snap.pv_req_id < 0), as_tuple=True)[0]
    return VolumeTables(req=req, node_off=node_off,
                        node_pv=aff[vv].to(torch.int32).contiguous(),
                        global_pv=glob.to(torch.int32).contiguous())


# ---- the plain twins of K10-K12, on the kernels' signatures ----


def volume_mask_plain(snap, tables: VolumeTables, pv_claimed, unbound: bool):
    """K10's function: the static mask (`unbound` False, `pv_claimed` None)
    or the unbound residue against `pv_claimed`. bool [P, N]."""
    if unbound:
        return volume_mask_unbound(snap, tables.req, pv_claimed)
    return volume_mask(snap, tables.req, pv_claimed)


def pv_choice_plain(snap, tables: VolumeTables, pv_claimed, node_of, active):
    """K11's function: `chosen_pv_slots`. i32 [P, MVol]."""
    return chosen_pv_slots(snap, tables.req, pv_claimed, node_of, active)


def pv_fold_plain(snap, tables: VolumeTables, pv_claimed, accepted, node_of, rank):
    """K12's function: `fold_pv_claims`. bool [V]."""
    return fold_pv_claims(snap, tables.req, pv_claimed, accepted, node_of, rank)
