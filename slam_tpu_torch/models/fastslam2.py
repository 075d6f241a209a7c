"""FastSLAM 2.0 on the particle planes (counterpart:
slam_tpu.models.fastslam2).

Per control tick: pose and pose-covariance propagation,
Pv <- Gv Pv Gv' + Gu Q Gu', with the control noise switched by
SWITCH_PREDICT_NOISE; under SWITCH_HEADING_KNOWN then the per-particle
heading Joseph update against the true heading.

Per observe tick (``fs2_update``), as the JAX package runs it on a TPU:

- known association; the matched landmark planes gathered once;
- K3: the sequential proposal refinement over the matched observations,
  in covariance form (``ops.planes.refine_pose_planes``);
- the proposal sample xvs ~ N(xv_r, Pv_r), the importance weight
  prior / proposal, and Pv zeroed;
- the likelihood, the feature updates and the new features at the
  sampled pose, in place, by the kernel that
  ``ops.kernels.landmark_update`` picks (K4 or K2), reading the
  landmark planes by slot (``fastslam1.fs1_observe``);
- the Neff-gated resample (``rbpf.resample``: G2 or G1).

With no observation at all the sample, the weight term and the Pv reset
are switched off by ``torch.where`` on the device, not by a host branch:
FastSLAM 2 adds no host sync to FastSLAM 1's one per superstep (the
resample gate).

With the heading unknown, ``FastSlam2`` has ``predict_multi``, all the
control ticks of a superstep in one K6b launch (its twin on the CPU).
With the heading known it has none: the per-tick heading update is not
a no-op for FastSLAM 2 (Pv != 0 between observations), and the runner
would skip it on the multi-tick path. Its per-tick ``predict`` is then
one F2 launch on the card (``ops.kernels.fs2_predict_tick``, after one
``torch.randn`` for the tick's control normals, the draw the eager tick
makes) and the eager tick elsewhere (``FastSlam2._predict_plain``, F2's
twin); ``fs2_predict_ticks`` counts the ticks each ran.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.geometry import wrap_angle
from slam_tpu_torch.models import rbpf
from slam_tpu_torch.models.fastslam1 import FastSlam1, fs1_observe
from slam_tpu_torch.models.particles import ParticleState
from slam_tpu_torch.ops import planes as pk
from slam_tpu_torch.ops import resampling as rs
from slam_tpu_torch.ops.kernels import (
    fs2_predict_multi,
    fs2_predict_tick,
    fs2_refine,
)
from slam_tpu_torch.spans import span

_PV_JITTER = 1e-9

# ``FastSlam2.predict``'s ticks: one F2 launch each (``fused``, on the
# card) or the eager twin's (``eager``, elsewhere).
fs2_predict_ticks = SimpleNamespace(fused=0, eager=0)


def propagate_pose_covariance(xv, Pv, V, G, Q, wheelbase: float,
                              dt: float):
    """One tick of the FastSLAM 2 predict for given controls V, G [P]:
    (xv [3, P] after the bicycle step, Pv [6, P] <- Gv Pv Gv' + Gu Q
    Gu'), the packed-symmetric expansion of the JAX package's
    ``fs2_predict``. ``Q`` is a host 2x2."""
    theta = xv[2]
    sgt, cgt = torch.sin(G + theta), torch.cos(G + theta)
    al = -V * dt * sgt          # Gv[0, 2]
    be = V * dt * cgt           # Gv[1, 2]

    a, b, c, d, e, f = Pv
    # Gv Pv Gv' with Gv = I + al e0 e2' + be e1 e2'.
    n00 = a + 2.0 * al * c + al * al * f
    n01 = b + al * e + be * c + al * be * f
    n02 = c + al * f
    n11 = d + 2.0 * be * e + be * be * f
    n12 = e + be * f
    n22 = f

    # + Gu Q Gu', Gu rows g0 = (dt cgt, al), g1 = (dt sgt, be),
    # g2 = (dt sin(G) / WB, V dt cos(G) / WB).
    q00, q01, q11 = pk.sym2_host(Q)
    g00, g01 = dt * cgt, al
    g10, g11 = dt * sgt, be
    g20 = dt * torch.sin(G) / wheelbase
    g21 = V * dt * torch.cos(G) / wheelbase

    def gq(gi0, gi1, gj0, gj1):
        return (gi0 * (q00 * gj0 + q01 * gj1)
                + gi1 * (q01 * gj0 + q11 * gj1))

    Pv = torch.stack([
        n00 + gq(g00, g01, g00, g01),
        n01 + gq(g00, g01, g10, g11),
        n02 + gq(g00, g01, g20, g21),
        n11 + gq(g10, g11, g10, g11),
        n12 + gq(g10, g11, g20, g21),
        n22 + gq(g20, g21, g20, g21),
    ])
    return rbpf.propagate_poses(xv, V, G, wheelbase, dt), Pv


def fs2_predict(state: ParticleState, generator: torch.Generator, vn, gn,
                Q, *, wheelbase: float, dt: float, add_noise: bool
                ) -> ParticleState:
    """Sample per-particle controls (the nominal ones unless
    ``add_noise``) and propagate poses and pose covariances."""
    V, G = rbpf.sample_controls(vn, gn, Q, state.n_particles, generator,
                                add_noise)
    xv, Pv = propagate_pose_covariance(state.xv, state.Pv, V, G, Q,
                                       wheelbase, dt)
    return state._replace(xv=xv, Pv=Pv)


def _refine_proposal(state: ParticleState, z, matched, gathered, R):
    """K3 on the state's pose and covariance: (xv_r [3, P], Pv_r [6, P]).
    ``gathered``: the (lmx, lmy, p00, p01, p11) [K, P] planes of
    ``rbpf.gather_landmarks``."""
    return fs2_refine(state.xv, state.Pv, *gathered, z, matched, R)


def _log_likelihood_at(xvs, z, matched, gathered, R):
    """Sum over the matched observations of log N(v; 0, Hf Pf Hf' + R)
    at poses ``xvs`` [3, P]: the weight term that K2 and K4 evaluate at
    the sampled pose, in plain form."""
    J = pk.jacobians_planes(xvs[0:1], xvs[1:2], xvs[2:3], *gathered,
                            *pk.sym2_host(R))
    v0 = z[:, 0:1] - J.zr
    v1 = wrap_angle(z[:, 1:2] - J.zb)
    logl = torch.where(matched[:, None],
                       pk.log_gauss2_planes(v0, v1, J.s00, J.s01, J.s11),
                       0.0)
    return logl.sum(dim=0)


def proposal_noise(n: int, generator: torch.Generator) -> torch.Tensor:
    """The proposal sample's standard normal draw, eps [3, n]."""
    return torch.randn((3, n), generator=generator, device=generator.device)


def fs2_propose(state: ParticleState, z, zmask, matched, gathered, R, eps
                ) -> ParticleState:
    """The proposal: K3's refinement at the state's pose over the
    matched observations (``gathered``: their landmark planes, each
    [K, P]), the sample xvs ~ N(xv_r, Pv_r) from ``eps`` [3, P], the
    importance weight prior / proposal added to logw, and Pv zeroed;
    with no observation at all (``zmask``) the state as it was, chosen
    on the device."""
    any_obs = torch.any(zmask)
    xv0, Pv0 = state.xv, state.Pv
    xv_r, Pv_r = _refine_proposal(state, z, matched, gathered, R)
    Pv_r_t = tuple(Pv_r)

    # Sample the proposal.
    Lch = pk.sym3_chol(Pv_r_t, _PV_JITTER)
    s0, s1, s2 = pk.chol3_mul_vec(Lch, eps[0], eps[1], eps[2])
    xvs = torch.stack([xv_r[0] + s0, xv_r[1] + s1,
                       wrap_angle(xv_r[2] + s2)])
    xvs = torch.where(any_obs, xvs, xv0)

    # Importance weight: prior / proposal, in log space.
    dp2 = wrap_angle(xv0[2] - xvs[2])
    log_prior = pk.log_gauss3_planes(tuple(Pv0), xv0[0] - xvs[0],
                                     xv0[1] - xvs[1], dp2, _PV_JITTER)
    dq2 = wrap_angle(xv_r[2] - xvs[2])
    log_prop = pk.log_gauss3_planes(Pv_r_t, xv_r[0] - xvs[0],
                                    xv_r[1] - xvs[1], dq2, _PV_JITTER)
    corr = torch.where(any_obs, log_prior - log_prop, 0.0)
    return state._replace(
        logw=state.logw + corr, xv=xvs,
        Pv=torch.where(any_obs, torch.zeros_like(Pv0), Pv0))


def fs2_observe(state: ParticleState, z, ids, zmask, R, eps
                ) -> ParticleState:
    """The FastSLAM 2 update up to the resample: association, the
    proposal (``fs2_propose``), then the likelihood, the feature updates
    and the new features at the sampled pose (``fastslam1.fs1_observe``,
    in place), in the spans ``fs2.associate``, ``fs2.propose`` and
    ``fs2.map``. The sharded filter (``parallel.filter``) follows it with
    its collective resample."""
    with span("fs2.associate"):
        slot, matched, is_new = rbpf.associate_slots(state, ids, zmask)
        gathered = rbpf.gather_landmarks(state, slot)
    with span("fs2.propose"):
        state = fs2_propose(state, z, zmask, matched, gathered, R, eps)
    with span("fs2.map"):
        return fs1_observe(state, z, ids, slot, matched, is_new, R)


def fs2_update(state: ParticleState, z, ids, zmask, R, n_min: float, eps,
               uniform_at: rs.UniformAt, *, do_resample: bool = True
               ) -> ParticleState:
    """Proposal refinement and sample, weighting, map update, resample.
    Updates the landmark planes of ``state`` in place. ``R`` is a host
    2x2; ``eps`` [3, P] the proposal's normal draw (``proposal_noise``);
    ``uniform_at`` the stratified dither (resampling.UniformAt)."""
    state = fs2_observe(state, z, ids, zmask, R, eps)
    return rbpf.resample(state, n_min, do_resample, uniform_at)


class FastSlam2(FastSlam1):
    """Config-bound FastSLAM 2.0 on one device: FastSlam1's state,
    capacity, Neff threshold and pose estimate, with the FastSLAM 2
    predict and update. ``predict_multi`` (K6b) exists only when
    SWITCH_HEADING_KNOWN is 0, on any device, as in JAX on a TPU."""

    def __init__(self, config: SlamConfig, n_map_landmarks: int,
                 device=None):
        super().__init__(config, n_map_landmarks, device=device)
        if not config.SWITCH_HEADING_KNOWN:
            self.predict_multi = self._predict_multi
        # F2's host floats: chol(Q) and Q as the eager tick rounds them.
        self._chol_q = rbpf.control_noise_factor(self.Q)
        self._q = pk.sym2_host(self.Q)

    def predict(self, state, generator, vn, gn, phi_true) -> ParticleState:
        """One control tick: pose and covariance propagation; under
        SWITCH_HEADING_KNOWN also the per-particle heading update
        against the true heading. On the card one F2 launch
        (``_predict_fused``), elsewhere the eager tick (``_predict_plain``)."""
        if state.xv.is_cuda:
            return self._predict_fused(state, generator, vn, gn, phi_true)
        return self._predict_plain(state, generator, vn, gn, phi_true)

    def _predict_fused(self, state, generator, vn, gn, phi_true
                       ) -> ParticleState:
        """The tick in one F2 launch, in place on the poses and
        covariances, from the control normals drawn as the eager tick
        draws them: the same random stream, bit for bit the same tick."""
        cfg = self.config
        sigma = cfg.sigmaT
        eps = rbpf.control_noise(state.n_particles, generator)
        fs2_predict_tick(state.xv, state.Pv, eps, vn, gn, phi_true,
                         self._chol_q, self._q, wheelbase=cfg.WHEELBASE,
                         dt=cfg.DT_CONTROLS, r=sigma * sigma,
                         add_noise=bool(cfg.SWITCH_PREDICT_NOISE),
                         heading_known=bool(cfg.SWITCH_HEADING_KNOWN))
        fs2_predict_ticks.fused += 1
        return state

    def _predict_plain(self, state, generator, vn, gn, phi_true
                       ) -> ParticleState:
        """F2's twin, the eager tick: ``fs2_predict``, then under
        SWITCH_HEADING_KNOWN the heading update in the span
        ``fs2.heading``."""
        cfg = self.config
        state = fs2_predict(state, generator, vn, gn, self.Q,
                            wheelbase=cfg.WHEELBASE, dt=cfg.DT_CONTROLS,
                            add_noise=bool(cfg.SWITCH_PREDICT_NOISE))
        if cfg.SWITCH_HEADING_KNOWN:
            with span("fs2.heading"):
                state = rbpf.observe_heading_particles(state, phi_true,
                                                       cfg.sigmaT)
        fs2_predict_ticks.eager += 1
        return state

    def _predict_multi(self, state: ParticleState, generator, controls
                       ) -> ParticleState:
        """All T ticks of a superstep, controls [T, 2] (vn, gn), in one
        K6b launch, in place on the poses and covariances. The Philox
        key is two int32 words drawn on the device from ``generator``."""
        cfg = self.config
        seed = torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32,
                             generator=generator, device=generator.device)
        fs2_predict_multi(state.xv, state.Pv, seed, controls, self.Q,
                          wheelbase=cfg.WHEELBASE, dt=cfg.DT_CONTROLS,
                          add_noise=bool(cfg.SWITCH_PREDICT_NOISE))
        return state

    def update(self, state, generator, z, ids, zmask) -> ParticleState:
        P = state.n_particles
        eps = proposal_noise(P, generator)
        uniform_at = rs.uniform_from_generator(P, generator, self.device)
        return fs2_update(state, z, ids, zmask, self.R, self.n_min(P), eps,
                          uniform_at,
                          do_resample=bool(self.config.SWITCH_RESAMPLE))
