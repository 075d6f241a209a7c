"""Pose-graph refinement: batch Gauss-Newton bundle adjustment with
Schur-complement landmark elimination (counterpart:
slam_tpu.posegraph)."""

from slam_tpu_torch.posegraph.ba import (
    BAProblem,
    problem_from_run,
    solve_ba,
    solve_ba_device,
)
from slam_tpu_torch.posegraph.distributed import solve_ba_sharded

__all__ = ["BAProblem", "problem_from_run", "solve_ba", "solve_ba_device",
           "solve_ba_sharded"]
