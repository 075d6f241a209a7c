"""Estimators of the port: EKF-SLAM, FastSLAM 1.0 (eager and with
deferred resampling) and FastSLAM 2.0 (counterpart:
slam_tpu.models)."""

from slam_tpu_torch.models.ekf import (
    EkfSlam,
    EKFState,
    ekf_augment,
    ekf_batch_update,
    ekf_data_associate,
    ekf_data_associate_known,
    ekf_init,
    ekf_observe_heading,
    ekf_predict,
    ekf_state_from_numpy,
    ekf_state_to_numpy,
    ekf_step,
)
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

ESTIMATORS = {
    "EKF1": EkfSlam,
    "EKF": EkfSlam,
    "FASTSLAM1": FastSlam1,
    "FASTSLAM2": FastSlam2,
}


def make_estimator(method: str, config, n_map_landmarks: int, device=None):
    """Method-string dispatch (the reference's ``-method``: FASTSLAM1,
    FASTSLAM2, anything else the EKF); the estimator runs on the card
    unless ``device`` names another."""
    cls = ESTIMATORS.get(method.upper(), EkfSlam)
    return cls(config, n_map_landmarks, device=device)


__all__ = [
    "EkfSlam",
    "EKFState",
    "ekf_init",
    "ekf_predict",
    "ekf_observe_heading",
    "ekf_data_associate",
    "ekf_data_associate_known",
    "ekf_batch_update",
    "ekf_augment",
    "ekf_step",
    "ekf_state_from_numpy",
    "ekf_state_to_numpy",
    "ParticleState",
    "init_particles",
    "estimate_position",
    "gather_particles",
    "FastSlam1",
    "FastSlam1Deferred",
    "FastSlam2",
    "DeferredState",
    "deferred_state_from_numpy",
    "deferred_state_to_numpy",
    "state_from_numpy",
    "state_to_numpy",
    "ESTIMATORS",
    "make_estimator",
]
