"""The committed-corpus artifact format (the port's copy of
`k8s_scheduler_tpu/fuzz/corpus.py`: it reads the committed
`tests/corpus/*.json` unchanged; `replay_artifact` takes the engine's
device).

One JSON file per minimal repro, written by the soak's shrink-on-
failure path (scripts/fuzz_scheduler.py) and replayed by the fast tier
(tests/test_fuzz.py over `tests/corpus/`). Every artifact is stamped
with everything needed to reproduce the run from the file alone:
generator seed + kwargs, fault spec, the engine-bug name (for harness
self-test repros like the seeded tie-break mutation), and the failure
class the shrinker preserved.

Corpus contract: replayed CLEAN (no failures) against the current
engine — each file is the regression test for a bug class the
differential once caught — and replayed FAILING with the recorded
class when its `bug` mutation is re-injected (the proof the oracle
still catches that class; tests/test_fuzz.py asserts both)."""

from __future__ import annotations

import dataclasses
import json

from .replay import Failure, run_case
from .trace import Trace, trace_from_dict, trace_to_dict

ARTIFACT_VERSION = 1


def save_artifact(
    path: str,
    trace: Trace,
    failure: Failure,
    *,
    bug: "str | None" = None,
    note: str = "",
) -> None:
    with open(path, "w") as f:
        json.dump({
            "version": ARTIFACT_VERSION,
            "seed": trace.seed,
            "fault_spec": trace.fault_spec,
            "failure": dataclasses.asdict(failure),
            "bug": bug or "",
            "note": note,
            "trace": trace_to_dict(trace),
        }, f, indent=1, sort_keys=True)
        f.write("\n")


def load_artifact(path: str) -> dict:
    with open(path) as f:
        d = json.load(f)
    if int(d.get("version", 1)) != ARTIFACT_VERSION:
        raise ValueError(f"artifact version {d.get('version')!r}")
    d["trace"] = trace_from_dict(d["trace"])
    d["failure"] = Failure(**d["failure"])
    return d


def replay_artifact(path: str, *, with_bug: bool = False, device=None) -> list[Failure]:
    """Replay one corpus file on `device` (None = the card). `with_bug=False`
    is the regression direction (must come back clean); `with_bug=True`
    re-injects the recorded engine mutation (must reproduce the recorded
    class)."""
    art = load_artifact(path)
    bug = art["bug"] or None if with_bug else None
    if with_bug and not art["bug"]:
        raise ValueError(f"{path} records no engine bug to re-inject")
    return run_case(art["trace"], bug=bug, device=device)
