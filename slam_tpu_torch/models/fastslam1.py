"""FastSLAM 1.0 on the particle planes (counterpart:
slam_tpu.models.fastslam1): the eager ``FastSlam1`` and the
deferred-resample ``FastSlam1Deferred``.

Per observe tick: noisy motion sample per particle (noise forced on),
the heading observe, known data association, likelihood weighting,
per-landmark 2x2 EKF updates, new-feature initialization, and the
Neff-gated stratified resample.

The eager update runs the weights, the matched landmarks' EKF updates
and the new features in one in-place launch of the kernel that
``ops.kernels.kernels.landmark_update`` picks (the id table and the live
count stay out here), then the resample (``rbpf.resample``).

The deferred path (at a P that ``FastSlam1Deferred.fits``) leaves the
resample's landmark gather pending and runs it inside the next update
(K5), and predicts all the control ticks of a superstep in one launch
(K6).

The kernel wrappers run their plain twins for CPU tensors, so the same
dispatch runs in the CPU tests.
"""

from __future__ import annotations

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
from slam_tpu_torch.ops.kernels import bounds_gather_multi, fs1_predict_multi
from slam_tpu_torch.ops.kernels.kernels import landmark_update


def fs1_predict(state: ParticleState, generator: torch.Generator, vn, gn,
                Q, *, wheelbase: float, dt: float,
                add_noise: bool = True) -> ParticleState:
    """Sample per-particle controls and propagate the poses."""
    V, G = rbpf.sample_controls(vn, gn, Q, state.n_particles, generator,
                                add_noise)
    return state._replace(xv=rbpf.propagate_poses(state.xv, V, G,
                                                  wheelbase, dt))


def fs1_observe(state: ParticleState, z, ids, slot, matched, is_new, R,
                S=None) -> ParticleState:
    """Weight, per-landmark EKF update and new features on logw, lm and
    lm_P (``landmark_update``; with ``S``, pending offspring bounds, into
    fresh planes), then the id table (in place) and the live count."""
    slot_new, ok = rbpf.new_slots(state, is_new)
    lm, lm_P = landmark_update(state.xv, state.logw, state.lm, state.lm_P,
                               z, slot, matched, slot_new, ok, R, S=S)
    rbpf.set_table(state.da_table, ids, slot_new, ok)
    return state._replace(lm=lm, lm_P=lm_P,
                          n=state.n + ok.sum(dtype=torch.int32))


def fs1_update(state: ParticleState, z, ids, zmask, R, n_min: float,
               uniform_at: rs.UniformAt, *, do_resample: bool = True
               ) -> ParticleState:
    """Weight, per-landmark EKF update, new features, resample. Updates
    the landmark planes of ``state`` in place. ``R`` is a host 2x2;
    ``uniform_at`` the stratified dither (resampling.UniformAt). The
    sharded filters (``parallel.filter``) run the same ``fs1_observe``
    with their collective resample in place of ``rbpf.resample``."""
    slot, matched, is_new = rbpf.associate_slots(state, ids, zmask)
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

def _identity_bounds(P: int, device) -> torch.Tensor:
    """The offspring bounds of no resample: arange(1, P + 1)."""
    return torch.arange(1, P + 1, dtype=torch.int32, device=device)


def deferred_resample_bounds(logw, n_min: float, do_resample: bool,
                             uniform_at: rs.UniformAt):
    """The Neff-gated stratified resample decision as offspring bounds:
    (S [P] int32, fired, new logw). S is arange(1, P + 1) when the gate
    holds (``rbpf.resample_bounds``). The permutation is not applied
    here."""
    logw, S, _ = rbpf.resample_bounds(logw, n_min, do_resample, uniform_at)
    if S is None:
        return _identity_bounds(logw.shape[-1], logw.device), False, logw
    return S, True, logw


def fs1_update_deferred(dstate: DeferredState, z, ids, zmask, R,
                        n_min: float, uniform_at: rs.UniformAt, *,
                        do_resample: bool = True) -> DeferredState:
    """The FastSLAM 1 update with the resample's landmark gather
    deferred into the next update (counterpart: JAX
    ``fs1_update_deferred``).

    ``fs1_observe`` gets the pending bounds, if any. This update's own
    decision becomes the next pending bounds (``rbpf.resample_bounds``;
    arange(1, P + 1) when the gate holds); when it fires, only the 9 pose
    rows [xv; Pv] are gathered now (G2), because the predict reads them
    before the next update.
    Equal to ``fs1_update`` followed by its gather, up to the one-update
    delay of the landmark gather, which ``finalize_deferred`` applies.

    Unlike JAX, the gate is a host ``if`` (one counted sync per call)
    where JAX uses ``lax.cond``, so K5 launches exactly once per fired
    gate."""
    state = dstate.ps
    slot, matched, is_new = rbpf.associate_slots(state, ids, zmask)
    state = fs1_observe(state, z, ids, slot, matched, is_new, R,
                        S=dstate.S if dstate.pending else None)
    logw, S, poses = rbpf.resample_bounds(
        state.logw, n_min, do_resample, uniform_at,
        lambda S: bounds_gather_multi([torch.cat([state.xv, state.Pv])],
                                      S)[0])
    fired = S is not None
    if fired:
        state = state._replace(xv=poses[:3], Pv=poses[3:])
    else:
        S = _identity_bounds(state.n_particles, logw.device)
    return DeferredState(ps=state._replace(logw=logw), S=S, pending=fired)


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


# FastSlam1Deferred's particle counts are multiples of this, as the JAX
# package's (its deferred kernel takes whole 512-particle blocks).
DEFERRED_ALIGN = 512


class FastSlam1Deferred(FastSlam1):
    """FastSLAM 1.0 with the resample's landmark gather deferred into
    the next update's kernel (K5), so a fired resample moves the
    landmark state through device memory once, in the pass the update
    makes anyway. P must be one that ``fits`` accepts.

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

    @staticmethod
    def fits(n_particles: int) -> bool:
        """Whether the filter takes ``n_particles``."""
        return n_particles % DEFERRED_ALIGN == 0

    def init(self, n_particles: int | None = None) -> DeferredState:
        ps = super().init(n_particles)
        P = ps.n_particles
        if not self.fits(P):
            raise ValueError(f"FastSlam1Deferred needs a particle count "
                             f"that is a multiple of {DEFERRED_ALIGN}, "
                             f"got {P}")
        return DeferredState(ps=ps, S=_identity_bounds(P, self.device),
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
