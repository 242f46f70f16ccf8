"""The repo's static analysis (`k8s_scheduler_tpu.analysis`, schedlint) over
the port, `k8s_scheduler_tpu_torch/`, with no baseline: every pass that
applies to eager code finds nothing unsuppressed.

The passes are LOCK-DISCIPLINE, JOURNAL-EMIT-ONCE, DURABILITY-ORDER,
THREADS, RACES, ROBUSTNESS, HYGIENE and INVENTORY-DRIFT. TRACE-SAFETY,
JIT-PURITY, SHARD-SAFETY and TENANCY-ISOLATION model jit tracing, meshes
and the tenant arena, which the port does not have. A suppression in the
port carries the reference's own text where the line is the reference's
copy, or says why the rule does not hold (the kernel cache's key, ID006).
The analysis package is imported, never edited."""

from __future__ import annotations

import os

import pytest

from k8s_scheduler_tpu.analysis import run_lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EAGER_PASSES = ("LOCK-DISCIPLINE", "JOURNAL-EMIT-ONCE", "DURABILITY-ORDER", "THREADS",
                "RACES", "ROBUSTNESS", "HYGIENE", "INVENTORY-DRIFT")


@pytest.mark.parametrize("name", EAGER_PASSES)
def test_port_is_clean_under(name):
    res = run_lint(REPO, paths=["k8s_scheduler_tpu_torch"], passes=[name])
    assert res.files_scanned > 80
    assert res.findings == [], "\n".join(
        f"{f.file}:{f.line} {f.code} {f.message}" for f in res.findings)


def test_suppressions_give_their_reason():
    """Every suppression in the port names its reason after `--`."""
    res = run_lint(REPO, paths=["k8s_scheduler_tpu_torch"], passes=list(EAGER_PASSES))
    assert res.suppressed, "the reference's reasoned suppressions are expected"
    bad = []
    for root, _, files in os.walk(os.path.join(REPO, "k8s_scheduler_tpu_torch")):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(root, f), encoding="utf-8") as fh:
                for i, line in enumerate(fh, 1):
                    if "schedlint: disable" in line and " -- " not in line and \
                            "schedlint: disable=RB001 -- deliberately silent:" not in line:
                        bad.append(f"{f}:{i}")
    assert bad == []
