"""FastSLAM 1.0 on the particle planes (counterpart:
slam_tpu.models.fastslam1): the eager ``FastSlam1`` and the
deferred-resample ``FastSlam1Deferred``.

Per observe tick: noisy motion sample per particle (noise forced on),
the heading observe, known data association, likelihood weighting,
per-landmark 2x2 EKF updates, new-feature initialization, and the
Neff-gated stratified resample.

The eager update dispatches as the JAX package does on a TPU:

- the weights, the matched landmarks' EKF updates and the new features
  in one in-place kernel launch: K4 (1 or 4 threads per particle, by
  P) when P % 128 == 0, otherwise K2 (the same function at any P, one thread per
  (observation, particle) pair); the id table and the live count stay
  out here.
- resample: G2 from the offspring bounds when P % 512 == 0, else G1.

The deferred path (P % 512 == 0) leaves the resample's landmark gather
pending and runs it inside the next update (K5), and predicts all the
control ticks of a superstep in one launch (K6).

The kernel wrappers run their plain twins for CPU tensors, so the same
dispatch runs in the CPU tests.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.device import default_device
from slam_tpu_torch.models import rbpf
from slam_tpu_torch.models.particles import (
    DeferredState,
    ParticleState,
    estimate_position,
    init_particles,
)
from slam_tpu_torch.ops import resampling as rs
from slam_tpu_torch.ops.kernels import (
    bounds_gather_multi,
    fs1_predict_multi,
    fused_update,
    observe,
    resample_update,
)

FUSED_ALIGN = 128     # K4 when P is a multiple of this
DEFERRED_ALIGN = 512  # FastSlam1Deferred takes only multiples of this


def fs1_predict(state: ParticleState, generator: torch.Generator, vn, gn,
                Q, *, wheelbase: float, dt: float,
                add_noise: bool = True) -> ParticleState:
    """Sample per-particle controls and propagate the poses."""
    V, G = rbpf.sample_controls(vn, gn, Q, state.n_particles, generator,
                                add_noise)
    return state._replace(xv=rbpf.propagate_poses(state.xv, V, G,
                                                  wheelbase, dt))


def fs1_observe(state: ParticleState, z, ids, slot, matched, is_new, R
                ) -> ParticleState:
    """Weight, per-landmark EKF update and new features, in place on
    logw, lm and lm_P: K4 when P % 128 == 0, else K2; then the id table
    (in place) and the live count."""
    update = fused_update if state.n_particles % FUSED_ALIGN == 0 else observe
    slot_new, ok = rbpf.new_slots(state, is_new)
    update(state.xv, state.logw, state.lm, state.lm_P, z, slot, matched,
           slot_new, ok, R)
    rbpf.set_table(state.da_table, ids, slot_new, ok)
    return state._replace(n=state.n + ok.sum(dtype=torch.int32))


def fs1_update(state: ParticleState, z, ids, zmask, R, n_min: float,
               uniform_at: rs.UniformAt, *, do_resample: bool = True
               ) -> ParticleState:
    """Weight, per-landmark EKF update, new features, resample. Updates
    the landmark planes of ``state`` in place. ``R`` is a host 2x2;
    ``uniform_at`` the stratified dither (resampling.UniformAt)."""
    assoc, is_new = rbpf.associate_known(state, ids, zmask)
    matched = assoc >= 0
    slot = torch.where(matched, assoc, 0).to(torch.int32)
    return update_at_pose(state, z, ids, slot, matched, is_new, R, n_min,
                          uniform_at, do_resample=do_resample)


def update_at_pose(state: ParticleState, z, ids, slot, matched, is_new, R,
                   n_min: float, uniform_at: rs.UniformAt, *,
                   do_resample: bool = True) -> ParticleState:
    """The eager update at the state's poses, after the association:
    ``fs1_observe``, then the Neff-gated resample. Shared by FastSLAM 1
    and 2."""
    state = fs1_observe(state, z, ids, slot, matched, is_new, R)
    return rbpf.resample(state, n_min, do_resample, uniform_at)


class FastSlam1:
    """Config-bound FastSLAM 1.0 on one device: the card, unless
    ``device`` names another (``default_device``)."""

    def __init__(self, config: SlamConfig, n_map_landmarks: int,
                 device=None):
        self.config = config
        self.n_map = n_map_landmarks
        self.device = default_device(device)
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

    def n_min(self, n_particles: int) -> float:
        """The Neff threshold, NEFFECTIVE scaled to the particle count."""
        cfg = self.config
        return float(cfg.NEFFECTIVE * n_particles / cfg.NPARTICLES
                     if cfg.NPARTICLES else cfg.NEFFECTIVE)

    def update(self, state, generator, z, ids, zmask) -> ParticleState:
        P = state.n_particles
        uniform_at = rs.uniform_from_generator(P, generator, self.device)
        return fs1_update(state, z, ids, zmask, self.R, self.n_min(P),
                          uniform_at,
                          do_resample=bool(self.config.SWITCH_RESAMPLE))

    def pose(self, state) -> torch.Tensor:
        return estimate_position(state, self.config.POSE_ESTIMATE)


# ---------------------------------------------------------------------------
# Deferred resampling
# ---------------------------------------------------------------------------

def deferred_resample_bounds(logw, n_min: float, do_resample: bool,
                             uniform_at: rs.UniformAt):
    """The Neff-gated stratified resample decision as offspring bounds:
    (S [P] int32, fired, new logw). S is arange(1, P + 1) when the gate
    holds. The permutation is not applied here. The gate is read on the
    host (``rbpf.resample_gate``); the prefix sum and the bounds run only
    when it fires, through ``rs.cumulative_weights`` and
    ``rs.offspring_bounds``."""
    n = logw.shape[-1]
    logw_n, fired = rbpf.resample_gate(logw, n_min, do_resample)
    if not fired:
        return (torch.arange(1, n + 1, dtype=torch.int32,
                             device=logw.device), False, logw_n)
    S = rs.offspring_bounds(rs.cumulative_weights(logw_n), n, uniform_at)
    return S, True, torch.full_like(logw_n, -math.log(n))


def fs1_update_deferred(dstate: DeferredState, z, ids, zmask, R,
                        n_min: float, uniform_at: rs.UniformAt, *,
                        do_resample: bool = True) -> DeferredState:
    """The FastSLAM 1 update with the resample's landmark gather
    deferred into the next update (counterpart: JAX
    ``fs1_update_deferred``).

    When a resample is pending, K5 gathers the landmark planes by its
    bounds and updates them into fresh buffers; when none is, K4
    updates them in place, with no copy. This update's own decision
    becomes the next pending bounds; when it fires, only the 9 pose rows
    [xv; Pv] are gathered now (G2), because the predict reads them
    before the next update, and the weights are reset to uniform.
    Equal to ``fs1_update`` followed by its gather, up to the one-update
    delay of the landmark gather, which ``finalize_deferred`` applies.

    Unlike JAX, the gate is a host ``if`` (one counted sync per call)
    where JAX uses ``lax.cond``, so K5 launches exactly once per fired
    gate."""
    state, S = dstate.ps, dstate.S
    assoc, is_new = rbpf.associate_known(state, ids, zmask)
    matched = assoc >= 0
    slot = torch.where(matched, assoc, 0).to(torch.int32)
    slot_new, ok = rbpf.new_slots(state, is_new)
    if dstate.pending:
        lm, lm_P = resample_update(state.xv, state.logw, state.lm,
                                   state.lm_P, S, z, slot, matched,
                                   slot_new, ok, R)
        state = state._replace(lm=lm, lm_P=lm_P)
    else:
        fused_update(state.xv, state.logw, state.lm, state.lm_P, z, slot,
                     matched, slot_new, ok, R)
    rbpf.set_table(state.da_table, ids, slot_new, ok)
    state = state._replace(n=state.n + ok.sum(dtype=torch.int32))

    S_next, fired, logw = deferred_resample_bounds(state.logw, n_min,
                                                   do_resample, uniform_at)
    if fired:
        (small,) = bounds_gather_multi([torch.cat([state.xv, state.Pv])],
                                       S_next)
        state = state._replace(xv=small[:3], Pv=small[3:])
    return DeferredState(ps=state._replace(logw=logw), S=S_next,
                         pending=fired)


def finalize_deferred(dstate: DeferredState) -> ParticleState:
    """The particle state with the pending landmark gather applied
    (through G2); call once after a run. Nothing pending: the state as
    it is, where JAX gathers by the identity."""
    state = dstate.ps
    if not dstate.pending:
        return state
    P, L = state.n_particles, state.capacity
    lm_g, lmP_g = bounds_gather_multi(
        [state.lm.reshape(2 * L, P), state.lm_P.reshape(3 * L, P)],
        dstate.S)
    return state._replace(lm=lm_g.reshape(2, L, P),
                          lm_P=lmP_g.reshape(3, L, P))


class FastSlam1Deferred(FastSlam1):
    """FastSLAM 1.0 with the resample's landmark gather deferred into
    the next update's kernel (K5), so a fired resample moves the
    landmark state through device memory once, in the pass the update
    makes anyway. P must be a multiple of 512, as in JAX.

    With ``fused_predict`` (the default) the estimator has
    ``predict_multi``, which the runner calls once per superstep with
    all the control ticks' nominal controls: K6 on the card, its twin on
    the CPU. It skips the heading observe, which is exact: FastSLAM 1
    never makes Pv nonzero, and the observe is a no-op at Pv == 0.

    Differences from JAX: the gate is read on the host (one sync per
    superstep); the carry is (ps, S, pending), without the TPU kernel's
    window metadata; with nothing pending the update is K4 in place; no
    pair scan or buffer donation is needed, as the caller keeps only the
    old and the new state alive and the allocator reuses the freed one.
    """

    # The fields the per-tick predict writes (JAX's run-loop hint).
    PREDICT_TOUCHED = ("xv",)

    def __init__(self, config: SlamConfig, n_map_landmarks: int,
                 device=None, fused_predict: bool = True):
        super().__init__(config, n_map_landmarks, device=device)
        if fused_predict:
            self.predict_multi = self._predict_multi

    def init(self, n_particles: int | None = None) -> DeferredState:
        ps = super().init(n_particles)
        P = ps.n_particles
        if P % DEFERRED_ALIGN:
            raise ValueError(f"FastSlam1Deferred needs a particle count "
                             f"that is a multiple of {DEFERRED_ALIGN}, "
                             f"got {P}")
        return DeferredState(
            ps=ps, S=torch.arange(1, P + 1, dtype=torch.int32,
                                  device=self.device),
            pending=False)

    def predict(self, state: DeferredState, generator, vn, gn, phi_true
                ) -> DeferredState:
        return state._replace(ps=super().predict(state.ps, generator, vn,
                                                 gn, phi_true))

    def _predict_multi(self, state: DeferredState, generator,
                       controls) -> DeferredState:
        """All T ticks of a superstep, controls [T, 2] (vn, gn), in one
        K6 launch, in place on the poses. The kernel's Philox key is two
        int32 words drawn on the device from ``generator``."""
        cfg = self.config
        seed = torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32,
                             generator=generator, device=generator.device)
        fs1_predict_multi(state.ps.xv, seed, controls, self.Q,
                          wheelbase=cfg.WHEELBASE, dt=cfg.DT_CONTROLS,
                          add_noise=True)
        return state

    def update(self, state: DeferredState, generator, z, ids, zmask
               ) -> DeferredState:
        P = state.ps.n_particles
        uniform_at = rs.uniform_from_generator(P, generator, self.device)
        return fs1_update_deferred(
            state, z, ids, zmask, self.R, self.n_min(P), uniform_at,
            do_resample=bool(self.config.SWITCH_RESAMPLE))

    def pose(self, state: DeferredState) -> torch.Tensor:
        return estimate_position(state.ps, self.config.POSE_ESTIMATE)

    def finalize(self, state: DeferredState) -> ParticleState:
        return finalize_deferred(state)
