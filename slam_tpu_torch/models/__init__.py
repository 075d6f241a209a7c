"""Estimators of the port. FastSLAM 1.0 (eager and with deferred
resampling) and FastSLAM 2.0 are ported; the others are queued in
ROADMAP.md (Queue 1)."""

from slam_tpu_torch.models.fastslam1 import FastSlam1, FastSlam1Deferred
from slam_tpu_torch.models.fastslam2 import FastSlam2
from slam_tpu_torch.models.particles import (
    DeferredState,
    ParticleState,
    deferred_state_from_numpy,
    deferred_state_to_numpy,
    estimate_position,
    gather_particles,
    init_particles,
    state_from_numpy,
    state_to_numpy,
)

ESTIMATORS = {"FASTSLAM1": FastSlam1, "FASTSLAM2": FastSlam2}


def make_estimator(method: str, config, n_map_landmarks: int, device=None):
    """Method-string dispatch (the reference's ``-method``); the
    estimator runs on the card unless ``device`` names another."""
    cls = ESTIMATORS.get(method.upper())
    if cls is None:
        raise NotImplementedError(
            f"method {method!r} is not ported to slam_tpu_torch yet; "
            "ROADMAP.md (Queue 1) lists the order of the remaining "
            "estimators")
    return cls(config, n_map_landmarks, device=device)


__all__ = ["ESTIMATORS", "DeferredState", "FastSlam1", "FastSlam1Deferred",
           "FastSlam2", "ParticleState", "deferred_state_from_numpy",
           "deferred_state_to_numpy", "estimate_position",
           "gather_particles", "init_particles", "make_estimator",
           "state_from_numpy", "state_to_numpy"]
