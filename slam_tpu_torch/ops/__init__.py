"""Estimation math: plane algebra, resampling, and the CUDA kernels
(counterpart: slam_tpu.ops, whose names this package exports)."""

from slam_tpu_torch.ops.jacobians import compute_jacobians
from slam_tpu_torch.ops.kalman import (
    add_feature_init,
    cholesky_update,
    feature_update_2x2,
    joseph_update,
)
from slam_tpu_torch.ops.resampling import (
    effective_particles,
    normalize_log_weights,
    resample_particles,
    stratified_indices,
)

__all__ = [
    "compute_jacobians",
    "cholesky_update",
    "feature_update_2x2",
    "joseph_update",
    "add_feature_init",
    "effective_particles",
    "normalize_log_weights",
    "resample_particles",
    "stratified_indices",
]
