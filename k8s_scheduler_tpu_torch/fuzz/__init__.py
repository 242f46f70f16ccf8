"""Scenario fuzzer + trace-level differential oracle (the port of
`k8s_scheduler_tpu/fuzz/`).

A seeded generator (`trace.py`) emits multi-cycle cluster traces — pod
arrivals/deletions, node add/drain/churn, gangs, priority bands with
preemption pressure, taints/tolerations, PV topology, zone spreads,
disruption budgets — which `replay.py` drives through BOTH the port's
live `Scheduler` (on the card, or `device="cpu"`) and the slow sequential
oracle extended with trace semantics (`oracle.schedule_cycle_trace`),
asserting bit-equal bind streams plus standing per-cycle invariants.
`shrink.py` reduces failing traces to minimal repros; `corpus.py` reads
and writes the committed format `tests/corpus/` holds.
"""

from .corpus import load_artifact, replay_artifact, save_artifact  # noqa: F401
from .replay import (  # noqa: F401
    Failure,
    engine_bug,
    replay_engine,
    replay_oracle,
    run_api_case,
    run_case,
    run_tenant_case,
)
from .shrink import shrink_trace  # noqa: F401
from .trace import (  # noqa: F401
    Trace,
    generate_multitenant_trace,
    generate_trace,
    trace_from_dict,
    trace_to_dict,
)
