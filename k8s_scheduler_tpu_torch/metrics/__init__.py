from .metrics import SchedulerMetrics, global_metrics  # noqa: F401
