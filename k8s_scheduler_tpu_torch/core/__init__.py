from .cycle import (  # noqa: F401
    CycleDecision,
    CycleResult,
    build_carry_fns,
    build_cycle_fn,
    build_diagnosis_fn,
    build_packed_cycle_carry_fn,
    build_packed_cycle_fn,
    build_packed_preemption_fn,
    build_preemption_fn,
    build_stable_state_fn,
)
from .flight_recorder import (  # noqa: F401
    FlightRecorder,
    to_chrome_trace,
)
from .observe import (  # noqa: F401
    ANOMALY_CLASSES,
    PHASES,
    CycleObserver,
    SloEngine,
    classify_latency_series,
    phase_seconds,
)
from .pipeline import ServingPipeline, build_decision_slim_fn  # noqa: F401
from .scheduler import CycleStats, Scheduler  # noqa: F401
