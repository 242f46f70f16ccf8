"""The rounds engine's per-round dynamic masks and claim base: the plain
versions of K14 `dyn_mask` and K15 `dyn_score` (`ops/dyn_round.py`), through
`Framework.dyn_batched` and `score_anchor`, against the reference's round
program (`k8s_scheduler_tpu/ops/rounds.py:577-581`), jitted as the round
jits it: `mask & vsmask & act_v` and `vsbase + score`, bit for bit.

Also NodePorts' batched fold (a scatter with no size read) against the
reference's, the seeded edge cases of `utils/kernel_cases.dyn_cases`
against the reference's plugin arithmetic composed as its Framework
composes it, and a numpy model of K15's term program (`dyn_round.
score_program`, the kernel's fold op for op) against the plain version."""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k8s_scheduler_tpu.config as ref_config
import k8s_scheduler_tpu.framework.interfaces as ref_if
import k8s_scheduler_tpu.framework.plugins as ref_plugins
import k8s_scheduler_tpu.framework.runtime as ref_rt
import k8s_scheduler_tpu.models as ref_models
import k8s_scheduler_tpu.ops.resources as ref_res
import k8s_scheduler_tpu.utils.synth as ref_synth
import k8s_scheduler_tpu_torch.config as port_config
from k8s_scheduler_tpu_torch.framework.interfaces import CycleContext, DynKernels
from k8s_scheduler_tpu_torch.framework.runtime import Framework
from k8s_scheduler_tpu_torch.models.encoding import AUX_FIELDS, snapshot_from_numpy
from k8s_scheduler_tpu_torch.ops import dyn_round as dr
from k8s_scheduler_tpu_torch.ops import rounds, static_base
from k8s_scheduler_tpu_torch.utils import kernel_cases as kc
from test_torch_commit import _c7_objects, _profile
from test_torch_encoding import fixture

NEG_INF = rounds.NEG_INF


def _hostports(m):
    """Pods naming one, two or three host ports (TCP and UDP), on nodes
    where running pods hold some of them."""
    nodes = [m.MakeNode(f"h{i}").capacity({"cpu": "16", "memory": "64Gi"}).obj()
             for i in range(9)]
    ports = [(7000,), (7000, 7001), (8080, 7001, 9090), (9090,), (), (7002,)]
    pods = []
    for j in range(40):
        b = m.MakePod(f"q{j}").req({"cpu": f"{1 + j % 3}", "memory": f"{1 + j % 5}Gi"})
        for k, p in enumerate(ports[j % len(ports)]):
            b = b.host_port(p, "UDP" if (j + k) % 7 == 0 else "TCP")
        pods.append(b.created(float(j)).obj())
    running = [(m.MakePod(f"r{i}").req({"cpu": "2"}).host_port(7000).obj(), f"h{i}")
               for i in range(3)]
    return nodes, pods, running, []


def _objects(name, models, synth):
    if name == "c7":
        return _c7_objects(models)
    return _hostports(models) if name == "hostports" else fixture(name, models, synth)


def _snapshots(name):
    nodes, pods, existing, groups = _objects(name, ref_models, ref_synth)
    ref = ref_models.SnapshotEncoder().encode(nodes, pods, existing, groups)
    port = snapshot_from_numpy(ref.array_fields(), {k: getattr(ref, k) for k in AUX_FIELDS},
                               device="cpu")
    return ref, port


def _round_state(ref, seed):
    """A round's operands: the pods placed so far (accepted, node_of), the
    requested resources they left, the active rows (act_v)."""
    rng = np.random.default_rng(seed)
    P, N = ref.P, ref.N
    accepted = (rng.random(P) < 0.3) & np.asarray(ref.pod_valid)
    node_of = rng.integers(0, max(int(ref.num_nodes), 1), P).astype(np.int32)
    nreq = np.asarray(ref.node_requested).copy()
    np.add.at(nreq, node_of[accepted], np.asarray(ref.pod_requested)[accepted])
    act = np.asarray(ref.pod_valid) & ~accepted & (rng.random(P) < 0.9)
    return accepted, node_of, nreq.astype(np.float32), act


FIXTURES = ["cfg2", "c1", "hostports", "cfg4"]
PROFILES = ["default", "most_cpu", "balanced_static", "fit_three_static",
            "three_resources", "weighted"]


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("name", FIXTURES)
def test_dyn_round_plain_matches_reference_round_program(name, profile):
    """`Framework.dyn_batched` on the plain versions (K14's and K15's) after
    a fold of earlier placements (NodePorts' claims, the affinity state):
    the round's mask and base bit for bit, and the score anchor."""
    _round_program_check(*_snapshots(name), profile)


@pytest.mark.parametrize("profile", PROFILES)
def test_one_resource_round_program_matches_reference(profile):
    """ROADMAP C7 through the framework: its cpu-only input cut to one
    resource (R = 1), where BalancedAllocation folds to a constant and the
    fit score is one product, under every profile."""
    ref, port = (kc.narrow_resources(s, 1) for s in _snapshots("c7"))
    assert port.node_allocatable.shape[1] == 1
    _round_program_check(ref, port, profile)


def _round_program_check(ref, port, profile):
    rfw = ref_rt.Framework.from_config(_profile(ref_config, profile))
    fw = Framework.from_config(_profile(port_config, profile))
    accepted, node_of, nreq, act = _round_state(ref, 7)
    score_calls = []

    def dyn_score(*args):
        score_calls.append(args)
        return dr.dyn_score_plain(*args)

    ctx = CycleContext(port, dyn_kernels=DynKernels(dr.dyn_mask_plain, dyn_score))
    vsbase = static_base.static_base_plain(static_base.static_base_inputs(fw, ctx))

    def ref_round(s, vsbase, nreq, act):
        c = ref_if.CycleContext(s)
        ext = rfw.extra_update_batched(c, rfw.extra_init(c), accepted, node_of)
        vsmask = vsbase > NEG_INF * 0.5
        m, score, _ = rfw.dyn_batched(c, nreq, ext, vsmask)
        return m & vsmask & act[:, None], vsbase + score, rfw.score_anchor(c, nreq)

    want = jax.tree_util.tree_map(np.asarray, jax.jit(ref_round)(
        ref, vsbase.numpy(), nreq, act))
    t = torch.from_numpy
    ext = fw.extra_update_batched(ctx, fw.extra_init(ctx), t(accepted), t(node_of))
    mask, base = fw.dyn_batched(ctx, t(nreq), ext, vsbase, t(act))
    assert mask.dtype == torch.bool and base.dtype == torch.float32
    np.testing.assert_array_equal(mask.numpy(), want[0])
    np.testing.assert_array_equal(base.numpy(), want[1])
    anchor = fw.score_anchor(ctx, t(nreq))
    assert (anchor is None) == (want[2] is None)
    if anchor is not None:
        np.testing.assert_array_equal(anchor.numpy(), want[2])
    # K15's program of the framework's own terms (the round's and the
    # anchor's), folded as the kernel folds it
    assert len(score_calls) == 1 + (anchor is not None)
    for args in score_calls:
        np.testing.assert_array_equal(_k15_model(*args), dr.dyn_score_plain(*args).numpy())


@pytest.mark.parametrize("name", ["hostports", "mixed", "cfg2"])
def test_nodeports_fold_matches_reference(name):
    """NodePorts' batched fold (a scatter of True with no size read) twice
    in a row: pad slots, several ports a pod, two pods on one node, Q = 0
    (cfg2 names no host port)."""
    ref, port = _snapshots(name)
    rfw, fw = ref_rt.Framework.from_config(), Framework.from_config()
    rng = np.random.default_rng(3)
    steps = [((rng.random(ref.P) < 0.4) & np.asarray(ref.pod_valid),
              rng.integers(0, ref.N, ref.P).astype(np.int32)) for _ in range(2)]

    def ref_fold(s):
        c = ref_if.CycleContext(s)
        ext = rfw.extra_init(c)
        for acc, node in steps:
            ext = rfw.extra_update_batched(c, ext, acc, node)
        return ext["NodePorts"]

    want = np.asarray(jax.jit(ref_fold)(ref))
    ctx = CycleContext(port)
    ext = fw.extra_init(ctx)
    for acc, node in steps:
        ext = fw.extra_update_batched(ctx, ext, torch.from_numpy(acc), torch.from_numpy(node))
    np.testing.assert_array_equal(ext["NodePorts"].numpy(), want)
    if name == "hostports":
        assert want.sum() > 0


def _ref_case(raw):
    """The reference's arithmetic for one edge case, composed as its
    Framework composes a round (`dyn_batched`, `score_anchor`), jitted:
    (mask, feasible, base, anchor)."""
    B, N = raw["vsbase"].shape
    terms = raw["terms"]

    def f(vsbase, preq, alloc, nreq, ids, claimed, mplanes, splanes, act):
        m = vsbase > NEG_INF * 0.5
        if raw["fit"]:
            m = m & ref_res.fit_mask(preq, alloc, nreq)
        if ids is not None:
            oh = ref_plugins.NodePorts._port_onehot(SimpleNamespace(
                P=B, num_distinct_ports=claimed.shape[1], pod_port_ids=ids))
            m = m & ~((oh.astype(jnp.float32) @ claimed.T.astype(jnp.float32)) > 0.0)
        for p in mplanes:
            m = m & p
        score = jnp.zeros((B, N), jnp.float32)
        anchor = None
        zero = jnp.zeros_like(alloc[:1, :1])
        for term in terms:
            kind, w = term[0], term[1]
            if kind in ("fit", "balanced"):
                wc = jnp.asarray(np.array(term[2], np.float32))
                fn = (ref_res.balanced_allocation_score if kind == "balanced" else
                      ref_res.most_requested_score if term[3] else
                      ref_res.least_requested_score)
                v = fn(preq[:, None, :], alloc, nreq, wc)
                a = fn(zero, alloc, nreq, wc)
                anchor = w * a if anchor is None else anchor + w * a
            else:
                v = splanes[term[2]]
            score = score + w * v
        final = m if act is None else m & act[:, None]
        return final, m, vsbase + score, anchor

    args = [raw[k] for k in ("vsbase", "preq", "alloc", "nreq", "ids", "claimed")]
    return jax.tree_util.tree_map(np.asarray, jax.jit(f)(
        *args, raw["mplanes"], raw["splanes"], raw["act"]))


@pytest.mark.parametrize("tag", kc.DYN_TAGS)
def test_dyn_cases_plain_match_reference(tag):
    """`dyn_mask_plain` and `dyn_score_plain` (and the anchor) on each
    seeded edge case against the reference's arithmetic, bit for bit."""
    raw = kc.dyn_raw_cases()[tag]
    want_mask, want_feas, want_base, want_anchor = _ref_case(raw)
    x = kc.dyn_inputs(raw, "cpu")
    mask, feas = dr.dyn_mask_plain(*x["mask"])
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    np.testing.assert_array_equal(feas.numpy(), want_feas)
    np.testing.assert_array_equal(dr.dyn_score_plain(*x["score"]).numpy(), want_base)
    if x["anchor"] is None:
        assert want_anchor is None
    else:
        np.testing.assert_array_equal(dr.dyn_score_plain(*x["anchor"]).numpy()[0],
                                      want_anchor.reshape(-1))
    # the dispatching wrappers take the plain versions for CPU tensors
    assert torch.equal(dr.dyn_mask(*x["mask"])[0], mask)


def _fma(a, b, c):
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _k15_model(vsbase, terms):
    """K15's per-element arithmetic (csrc/dyn_round.cu dyn_score_kernel) in
    numpy from the program `score_program` hands the launcher; an fma is
    an f64 product and sum rounded once."""
    prog, planes, res, flags, w100, bal, rn = dr.score_program(terms)
    f32 = np.float32
    fx = bx = None
    if res is not None:
        preq, alloc, nreq = (t.numpy() for t in res)
        R = alloc.shape[1]
        after = nreq[None, :, :] + preq[:, None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = np.where(alloc > 0, after / np.maximum(alloc, f32(1e-9)), f32(1.0))
        frac = np.minimum(np.maximum(frac, f32(0.0)), f32(1.0)).astype(f32)
        fx, first = np.zeros(frac.shape[:2], f32), True
        for r in range(R):
            if not w100 or w100[r] == 0.0:
                continue
            x = frac[..., r] if flags & dr.S_MOST else f32(1.0) - frac[..., r]
            if first:
                fx = x * f32(w100[r])
            elif flags & dr.S_FIT_ONES:
                fx = fx + x * f32(w100[r])
            else:
                fx = _fma(x, f32(w100[r]), fx)
            first = False
        cols = [r for r in range(R) if (bal >> r) & 1]
        tot = np.zeros(frac.shape[:2], f32)
        for r in cols:
            tot = tot + frac[..., r]
        mean = tot * f32(rn)
        var = np.zeros_like(tot)
        for r in cols:
            d = frac[..., r] - mean
            var = _fma(d, d, var) if flags & dr.S_BAL_ALL else var + d * d
        bx = f32(1.0) - np.sqrt(np.float64(var * f32(rn))).astype(f32)
    acc, have, held, hx, hc = None, False, False, None, None
    for code, plane, c, prod in prog:
        c = f32(c)
        x = (fx if code == dr.T_FIT else bx if code == dr.T_BALANCED else
             np.full(fx.shape, c, f32) if code == dr.T_CONST else planes[plane].numpy())
        if not have:
            have = True
            if prod:
                held, hx, hc = True, x, c
            else:
                acc = x
        elif held and prod == dr.P_PREFERRED:
            acc, held = _fma(x, c, hx * hc), False
        elif held:
            acc, held = _fma(hx, hc, x * c if prod else x), False
        elif prod:
            acc = _fma(x, c, acc)
        else:
            acc = acc + x
    if vsbase is None:
        return hx * hc if held else acc
    sb = vsbase.numpy()
    if held:
        return _fma(hx, hc, sb)
    return sb + (np.zeros_like(sb) if acc is None else acc)


_FIT = ("fit", 1.0, (1.0,), False)
_BAL = ("balanced", 1.0, (1.0,))
# ROADMAP C7's term programs: one resource, in both orders, with weights,
# MostAllocated, beside planes; the fit score alone (no constant to fuse
# into: its product rounded, the weight folded into it); and
# BalancedAllocation weighting one of four resources (not folded)
ONE_RESOURCE = {
    "fit, balanced": (1, [_FIT, _BAL]),
    "balanced, fit": (1, [_BAL, _FIT]),
    "fit 5, balanced 3": (1, [("fit", 5.0, (1.0,), False), ("balanced", 3.0, (1.0,))]),
    "most, balanced": (1, [("fit", 1.0, (1.0,), True), _BAL]),
    "plane, balanced, fit": (1, [("plane", 1.0, 0), _BAL, _FIT]),
    "weighted profile's order": (1, [("balanced", 3.0, (1.0,)), ("plane", 2.0, 0),
                                     ("fit", 5.0, (1.0,), False), ("plane", 1.0, 1)]),
    "balanced weight 0, fit": (1, [_FIT, ("balanced", 1.0, (0.0,))]),
    "fit 5 alone": (1, [("fit", 5.0, (1.0,), False)]),
    "fit 5, plane": (1, [("fit", 5.0, (1.0,), False), ("plane", 1.0, 0)]),
    "one of four balanced, fit": (4, [("balanced", 1.0, (1.0, 0.0, 0.0, 0.0)),
                                      ("fit", 1.0, (1.0, 1.0, 0.0, 0.0), False)]),
    "fit, one of four balanced 3": (4, [("fit", 1.0, (1.0, 0.0, 0.0, 0.0), False),
                                        ("balanced", 3.0, (0.0, 1.0, 0.0, 0.0))]),
}


@pytest.mark.parametrize("name", list(ONE_RESOURCE))
def test_one_resource_scores_match_reference(name):
    """ROADMAP C7: `dyn_score_plain` and the anchor against the reference's
    jitted arithmetic on C7's input (a seed-1411 draw at R = 1) under each
    term program, and K15's program model against the plain version."""
    R, terms = ONE_RESOURCE[name]
    n_planes = 1 + max([t[2] for t in terms if t[0] == "plane"], default=-1)
    raw = kc._dyn_raw(np.random.default_rng(1411), 40, 64, R, terms=terms,
                      n_splanes=n_planes)
    _, _, want_base, want_anchor = _ref_case(raw)
    x = kc.dyn_inputs(raw, "cpu")
    base = dr.dyn_score_plain(*x["score"]).numpy()
    np.testing.assert_array_equal(base, want_base)
    np.testing.assert_array_equal(_k15_model(*x["score"]), base)
    if any(t[0] != "plane" for t in terms):
        anchor = dr.dyn_score_plain(*x["anchor"]).numpy()
        np.testing.assert_array_equal(anchor[0], want_anchor.reshape(-1))
        np.testing.assert_array_equal(_k15_model(*x["anchor"]), anchor)


@pytest.mark.parametrize("tag", kc.DYN_TAGS)
def test_k15_program_model_matches_plain(tag):
    """The kernel's term program, folded as the kernel folds it, equals
    `dyn_score_plain` on every edge case (base and anchor)."""
    x = kc.dyn_cases("cpu")[tag]
    np.testing.assert_array_equal(_k15_model(*x["score"]), dr.dyn_score_plain(*x["score"]).numpy())
    if x["anchor"] is not None:
        np.testing.assert_array_equal(_k15_model(*x["anchor"]),
                                      dr.dyn_score_plain(*x["anchor"]).numpy())


def test_port_onehot_names_each_port_once():
    ids = torch.tensor([[-1, 3, -1], [0, 0, 2], [-1, -1, -1]], dtype=torch.int32)
    want = torch.tensor([[0, 0, 0, 1], [1, 0, 1, 0], [0, 0, 0, 0]], dtype=torch.bool)
    assert torch.equal(dr.port_onehot(ids, 4), want)
    assert dr.port_onehot(ids[:, :0], 0).shape == (3, 0)
