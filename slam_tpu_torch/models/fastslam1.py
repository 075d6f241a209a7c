"""FastSLAM 1.0 on the particle planes (counterpart:
slam_tpu.models.fastslam1, the eager ``FastSlam1``).

Per observe tick: noisy motion sample per particle (noise forced on),
the heading observe, known data association, likelihood weighting,
per-landmark 2x2 EKF updates, new-feature initialization, and the
Neff-gated stratified resample.

The update dispatches as the JAX package does on a TPU:

- P % 128 == 0: K4, one in-place pass over the landmark state; the id
  table and the live count stay out here.
- otherwise: gather the matched slots, K2 on the gathered planes,
  scatter back, then ``add_new_features``.
- resample: G2 from the offspring bounds when P % 512 == 0, else G1.

The kernel wrappers run their plain twins for CPU tensors, so the same
dispatch runs in the CPU tests.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.models import rbpf
from slam_tpu_torch.models.particles import (
    ParticleState,
    estimate_position,
    init_particles,
)
from slam_tpu_torch.ops import resampling as rs
from slam_tpu_torch.ops.kernels import fused_update, observe

FUSED_ALIGN = 128     # K4 when P is a multiple of this


def fs1_predict(state: ParticleState, generator: torch.Generator, vn, gn,
                Q, *, wheelbase: float, dt: float,
                add_noise: bool = True) -> ParticleState:
    """Sample per-particle controls and propagate the poses."""
    V, G = rbpf.sample_controls(vn, gn, Q, state.n_particles, generator,
                                add_noise)
    return state._replace(xv=rbpf.propagate_poses(state.xv, V, G,
                                                  wheelbase, dt))


def fs1_observe(state: ParticleState, z, slot, matched, R
                ) -> ParticleState:
    """Gather the matched landmark planes, run K2 on them, scatter the
    updated planes back (in place) and apply the weight delta."""
    gathered = rbpf.gather_landmarks(state, slot)
    dlogw, nx, ny, np00, np01, np11 = observe(state.xv, *gathered, z,
                                              matched, R)
    rbpf.scatter_slots(state.lm, slot, torch.stack([nx, ny]), matched)
    rbpf.scatter_slots(state.lm_P, slot, torch.stack([np00, np01, np11]),
                       matched)
    return state._replace(logw=state.logw + dlogw)


def fs1_update(state: ParticleState, z, ids, zmask, R, n_min: float,
               uniform_at: rs.UniformAt, *, do_resample: bool = True
               ) -> ParticleState:
    """Weight, per-landmark EKF update, new features, resample. Updates
    the landmark planes of ``state`` in place. ``R`` is a host 2x2;
    ``uniform_at`` the stratified dither (resampling.UniformAt)."""
    assoc, is_new = rbpf.associate_known(state, ids, zmask)
    matched = assoc >= 0
    slot = torch.where(matched, assoc, 0).to(torch.int32)

    if state.n_particles % FUSED_ALIGN == 0:
        slot_new, ok = rbpf.new_slots(state, is_new)
        fused_update(state.xv, state.logw, state.lm, state.lm_P, z, slot,
                     matched, slot_new, ok, R)
        rbpf.set_table(state.da_table, ids, slot_new, ok)
        state = state._replace(n=state.n + ok.sum(dtype=torch.int32))
    else:
        state = fs1_observe(state, z, slot, matched, R)
        state = rbpf.add_new_features(state, z, ids, is_new, R)
    return rbpf.resample(state, n_min, do_resample, uniform_at)


class FastSlam1:
    """Config-bound FastSLAM 1.0 on one device."""

    def __init__(self, config: SlamConfig, n_map_landmarks: int,
                 device=None):
        self.config = config
        self.n_map = n_map_landmarks
        self.device = torch.device(device or "cpu")
        cap = config.max_landmarks or n_map_landmarks
        self.capacity = -(-cap // 8) * 8
        self.Q = np.diag(np.asarray(config.Qe, np.float32))
        self.R = np.diag(np.asarray(config.Re, np.float32))

    def init(self, n_particles: int | None = None) -> ParticleState:
        n = n_particles or self.config.NPARTICLES
        return init_particles(n, self.capacity, self.n_map,
                              device=self.device)

    def predict(self, state, generator, vn, gn, phi_true) -> ParticleState:
        """One control tick: noisy motion sample (FS1 forces noise on);
        under SWITCH_HEADING_KNOWN also the per-particle heading update
        against the true heading."""
        cfg = self.config
        state = fs1_predict(state, generator, vn, gn, self.Q,
                            wheelbase=cfg.WHEELBASE, dt=cfg.DT_CONTROLS,
                            add_noise=True)
        if cfg.SWITCH_HEADING_KNOWN:
            state = rbpf.observe_heading_particles(state, phi_true,
                                                   cfg.sigmaT)
        return state

    def update(self, state, generator, z, ids, zmask) -> ParticleState:
        cfg = self.config
        P = state.n_particles
        n_min = (cfg.NEFFECTIVE * P / cfg.NPARTICLES if cfg.NPARTICLES
                 else cfg.NEFFECTIVE)
        uniform_at = rs.uniform_from_generator(P, generator, self.device)
        return fs1_update(state, z, ids, zmask, self.R, float(n_min),
                          uniform_at,
                          do_resample=bool(cfg.SWITCH_RESAMPLE))

    def pose(self, state) -> torch.Tensor:
        return estimate_position(state, self.config.POSE_ESTIMATE)
