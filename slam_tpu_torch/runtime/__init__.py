"""Run loop, metrics, checkpoints."""

from slam_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
from slam_tpu_torch.runtime.loop import RunResult, Runner
from slam_tpu_torch.runtime.metrics import (
    RunMetrics,
    compute_metrics,
    position_errors,
    write_report,
)

__all__ = ["RunMetrics", "RunResult", "Runner", "compute_metrics",
           "load_checkpoint", "position_errors", "save_checkpoint",
           "write_report"]
