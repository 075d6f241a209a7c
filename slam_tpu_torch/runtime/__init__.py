"""Run loop and metrics."""

from slam_tpu_torch.runtime.loop import RunResult, Runner
from slam_tpu_torch.runtime.metrics import (
    RunMetrics,
    compute_metrics,
    position_errors,
    write_report,
)

__all__ = ["RunMetrics", "RunResult", "Runner", "compute_metrics",
           "position_errors", "write_report"]
