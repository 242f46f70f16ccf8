"""Trace shrinking: reduce a failing trace to a minimal repro (the port's
copy of `k8s_scheduler_tpu/fuzz/shrink.py`).

Greedy delta-debugging over the PLAIN-DATA trace, re-checking the
failure at every step and accepting a reduction ONLY when the failure
CLASS is preserved (`Failure.cls`) — shrinking to a *different* bug is
a rejected step, so the committed repro always reproduces the bug that
was found, not whichever one is easiest to trigger.

Stages, coarsest first (each runs to fixpoint before the next):

1. truncate cycles after the first failing cycle;
2. drop whole cycles (their events merge away; empty cycles stay as
   scheduling ticks only at the tail);
3. drop individual events (pod arrivals, churn);
4. drop initial objects (nodes, PVs, PVCs, classes, PDBs, groups);
5. simplify surviving pods one attribute at a time (affinity, anti,
   spread, tolerations, selector, volumes, priority, gang, ports);
6. drop fault-plan rules (chaos traces).

The `check` callable is injected — `run_case`-shaped for the real
harness, synthetic for the shrinker's own unit tests — and the whole
search is budgeted by `max_evals` (each eval of the real checker costs
a full replay)."""

from __future__ import annotations

import copy
from typing import Callable, Optional

from .replay import Failure
from .trace import Trace, trace_from_dict, trace_to_dict

Check = Callable[[Trace], Optional[Failure]]


class _Budget:
    def __init__(self, n: int) -> None:
        self.left = n

    def spend(self) -> bool:
        if self.left <= 0:
            return False
        self.left -= 1
        return True


def _clone(t: Trace) -> Trace:
    # dataclasses.asdict already rebuilds every nested container fresh
    return trace_from_dict(trace_to_dict(t))


def _same_class(check: Check, cand: Trace, cls: str,
                budget: _Budget) -> "Failure | None":
    if not budget.spend():
        return None
    f = check(cand)
    return f if f is not None and f.cls == cls else None


def _strip_variants(pod: dict):
    """Candidate one-attribute simplifications of a serialized pod
    (state/codec dialect), most-structure-first."""
    s = pod.get("s", {})
    for key in ("af", "tsc", "tol", "sel", "vol", "pg", "pp"):
        if key in s:
            v = copy.deepcopy(pod)
            del v["s"][key]
            yield v
    if s.get("pri"):
        v = copy.deepcopy(pod)
        del v["s"]["pri"]
        yield v
    for ci, c in enumerate(s.get("c", ())):
        if c.get("p"):
            v = copy.deepcopy(pod)
            del v["s"]["c"][ci]["p"]
            yield v


def shrink_trace(
    trace: Trace,
    failure: Failure,
    check: Check,
    *,
    max_evals: int = 250,
) -> tuple[Trace, Failure]:
    """Minimize `trace` while `check` keeps returning a failure of
    `failure.cls`. Returns (minimal trace, its failure). The input
    trace is not mutated."""
    cls = failure.cls
    budget = _Budget(max_evals)
    best = _clone(trace)
    best_failure = failure

    def accept(cand: Trace) -> bool:
        nonlocal best, best_failure
        f = _same_class(check, cand, cls, budget)
        if f is None:
            return False
        best, best_failure = cand, f
        return True

    # 1. truncate after the failing cycle (binary back-off from there)
    if failure.cycle >= 0 and failure.cycle + 1 < len(best.cycles):
        cand = _clone(best)
        cand.cycles = cand.cycles[: failure.cycle + 1]
        accept(cand)

    changed = True
    while changed and budget.left > 0:
        changed = False
        # 2. whole cycles, last to first
        for i in range(len(best.cycles) - 1, -1, -1):
            if len(best.cycles) <= 1:
                break
            cand = _clone(best)
            del cand.cycles[i]
            if accept(cand):
                changed = True
        # 3. individual events
        for ci in range(len(best.cycles) - 1, -1, -1):
            for ei in range(len(best.cycles[ci]) - 1, -1, -1):
                cand = _clone(best)
                del cand.cycles[ci][ei]
                if accept(cand):
                    changed = True
        # 4. initial objects
        for field in ("nodes", "pvs", "pvcs", "storage_classes", "pdbs",
                      "pod_groups"):
            lst = getattr(best, field)
            for i in range(len(lst) - 1, -1, -1):
                if field == "nodes" and len(lst) <= 1:
                    break
                cand = _clone(best)
                del getattr(cand, field)[i]
                if accept(cand):
                    changed = True
                    lst = getattr(best, field)
        # 5. pod simplification
        for ci in range(len(best.cycles)):
            for ei in range(len(best.cycles[ci])):
                ev = best.cycles[ci][ei]
                if "pod" not in ev:
                    continue
                for variant in _strip_variants(ev["pod"]):
                    cand = _clone(best)
                    cand.cycles[ci][ei]["pod"] = variant
                    if accept(cand):
                        changed = True
                        break
        # 6. fault rules (chaos)
        if best.fault_spec:
            rules = [r for r in best.fault_spec.split(";") if r]
            for i in range(len(rules) - 1, -1, -1):
                if rules[i].startswith("seed="):
                    continue
                cand = _clone(best)
                kept = rules[:i] + rules[i + 1:]
                if not any(
                    not r.startswith("seed=") for r in kept
                ):
                    continue  # a chaos trace needs >=1 rule
                cand.fault_spec = ";".join(kept)
                if accept(cand):
                    changed = True
                    rules = [
                        r for r in best.fault_spec.split(";") if r
                    ]
    return best, best_failure
