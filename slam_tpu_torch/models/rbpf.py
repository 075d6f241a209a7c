"""Rao-Blackwellized particle filter building blocks on the particle
planes (counterpart: slam_tpu.models.rbpf).

Functions that write landmark planes do so in place and return the
state: at 2^17 particles a copy of the planes is half a gigabyte.

Host syncs: where the JAX package branches with ``lax.cond`` (the
resample gate, the new-feature gate), eager torch reads a device bool
on the host. ``host_bool`` does that read and counts it in
``host_bool.count``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slam_tpu_torch.geometry import wrap_angle
from slam_tpu_torch.models.particles import (
    ParticleState,
    gather_particles,
    gather_particles_bounds,
)
from slam_tpu_torch.ops import planes as pk
from slam_tpu_torch.ops import resampling as rs


BOUNDS_ALIGN = 512    # resample through G2 when P is a multiple of this


def host_bool(flag: torch.Tensor) -> bool:
    """Read a device bool on the host: one device-to-host sync."""
    host_bool.count += 1
    return bool(flag)


host_bool.count = 0


def control_noise_factor(Q) -> tuple[float, float, float]:
    """(l00, l10, l11) of chol(Q + 1e-20 I) for a 2x2 Q, in float32
    on the host, so the per-tick sample reads no device value."""
    Q = np.asarray(Q, dtype=np.float32)
    L = np.linalg.cholesky(Q + np.float32(1e-20) * np.eye(2, dtype=np.float32))
    return float(L[0, 0]), float(L[1, 0]), float(L[1, 1])


def sample_controls(vn, gn, Q, n: int, generator: torch.Generator,
                    add_noise: bool = True):
    """Per-particle control sample ~ N((vn, gn), Q): ([n], [n])."""
    l00, l10, l11 = control_noise_factor(Q)
    eps = torch.randn((2, n), generator=generator, device=generator.device)
    n0 = l00 * eps[0]
    n1 = l10 * eps[0] + l11 * eps[1]
    on = float(add_noise)
    return vn + on * n0, gn + on * n1


def propagate_poses(xv, V, G, wheelbase: float, dt: float):
    """Bicycle step over particles, xv [3, P], with the heading rate
    V sin(G) / wheelbase, as the simulator's truth model."""
    theta = xv[2]
    return torch.stack([
        xv[0] + V * dt * torch.cos(G + theta),
        xv[1] + V * dt * torch.sin(G + theta),
        wrap_angle(theta + V * dt * torch.sin(G) / wheelbase),
    ])


def observe_heading_particles(state: ParticleState, phi, sigma_phi
                              ) -> ParticleState:
    """Per-particle scalar heading Joseph update on (xv, Pv); a no-op
    while Pv == 0, as in the reference."""
    xv = state.xv
    r = sigma_phi * sigma_phi
    a, b, c, d, e, f = state.Pv
    s = f + r
    k0, k1, k2 = c / s, e / s, f / s
    v = wrap_angle(phi - xv[2])
    new_xv = torch.stack([xv[0] + k0 * v, xv[1] + k1 * v,
                          wrap_angle(xv[2] + k2 * v)])
    q2 = 1.0 - k2
    Pv = torch.stack([
        a - 2.0 * k0 * c + k0 * k0 * f + r * k0 * k0,
        b - k0 * e - k1 * c + k0 * k1 * f + r * k0 * k1,
        q2 * (c - k0 * f) + r * k0 * k2,
        d - 2.0 * k1 * e + k1 * k1 * f + r * k1 * k1,
        q2 * (e - k1 * f) + r * k1 * k2,
        q2 * q2 * f + r * k2 * k2,
    ])
    return state._replace(xv=new_xv, Pv=Pv)


def associate_known(state: ParticleState, ids, zmask):
    """Shared id-table association: (assoc [K] int32, -1 unmatched;
    is_new [K] bool)."""
    slot = state.da_table[torch.clamp(ids, 0, state.da_table.shape[0] - 1)]
    assoc = torch.where(zmask & (slot >= 0), slot, -1).to(torch.int32)
    is_new = zmask & (slot < 0)
    return assoc, is_new


def new_slots(state: ParticleState, is_new):
    """(slot_new, ok): new observations take consecutive slots from n
    in observation order; only those below the capacity are kept."""
    new = is_new.to(torch.int32)
    slot_new = state.n + torch.cumsum(new, dim=0, dtype=torch.int32) - new
    return slot_new, is_new & (slot_new < state.capacity)


def _write_sources(tgt, valid):
    """For an indexed write at ``tgt`` [K] of which only ``valid``
    entries count: per entry, the first valid entry aimed at the same
    slot (itself, when valid) and whether there is one."""
    hit = valid[None, :] & (tgt[:, None] == tgt[None, :])       # [K, K]
    return torch.argmax(hit.to(torch.int32), dim=1), hit.any(dim=1)


def scatter_slots(planes, tgt, vals, valid) -> None:
    """Write ``vals`` [C, K, P] into slots ``tgt`` [K] of ``planes``
    [C, L, P] where ``valid``, in place, with one plain indexed write
    and no host sync.

    Entries that are not valid write back what their slot ends up
    holding anyway: the valid value aimed at it, or its old value. Every
    write to one slot then carries one value, so the order in which
    ``index_put_`` applies duplicate indices cannot matter."""
    src, has = _write_sources(tgt, valid)
    planes[:, tgt] = torch.where(has[None, :, None], vals[:, src],
                                 planes[:, tgt])


def set_table(table, ids, slots, ok) -> None:
    """table[ids[k]] = slots[k] where ok, in place; ids outside the
    table are dropped (the JAX package's mode="drop")."""
    n_map = table.shape[0]
    ok = ok & (ids >= 0) & (ids < n_map)
    tgt = torch.clamp(ids, 0, n_map - 1)
    src, has = _write_sources(tgt, ok)
    table[tgt] = torch.where(has, slots[src].to(table.dtype), table[tgt])


def gather_landmarks(state: ParticleState, slot):
    """[K]-indexed landmark planes: (lmx, lmy, p00, p01, p11), each
    [K, P]."""
    lm = state.lm[:, slot, :]
    lm_P = state.lm_P[:, slot, :]
    return lm[0], lm[1], lm_P[0], lm_P[1], lm_P[2]


def observe_planes(state: ParticleState, z, slot, R, gathered=None):
    """Jacobian planes and wrapped innovations at each particle's pose
    for each observation slot: (J, v0 [K, P], v1 [K, P])."""
    if gathered is None:
        gathered = gather_landmarks(state, slot)
    J = pk.jacobians_planes(state.xv[0:1], state.xv[1:2], state.xv[2:3],
                            *gathered, *pk.sym2_host(R))
    v0 = z[:, 0:1] - J.zr
    v1 = wrap_angle(z[:, 1:2] - J.zb)
    return J, v0, v1


def update_matched_features(state: ParticleState, slot, matched, v0, v1,
                            J, gathered=None) -> ParticleState:
    """2x2 EKF updates of every (particle, matched observation), written
    back in place."""
    if gathered is None:
        gathered = gather_landmarks(state, slot)
    lmx, lmy, p00, p01, p11 = gathered
    upd = pk.feature_update_planes(lmx, lmy, p00, p01, p11, v0, v1, J)
    scatter_slots(state.lm, slot, torch.stack([upd.nx, upd.ny]), matched)
    scatter_slots(state.lm_P, slot,
                  torch.stack([upd.np00, upd.np01, upd.np11]), matched)
    return state


def add_new_features(state: ParticleState, z, ids, is_new, R
                     ) -> ParticleState:
    """Initialize new landmarks at shared slots, every particle from its
    own pose; in place, and skipped (one host sync) when no new feature
    fits."""
    slot, ok = new_slots(state, is_new)
    if not host_bool(ok.any()):
        return state
    nx, ny, p00, p01, p11 = pk.feature_init_planes(
        state.xv[0:1], state.xv[1:2], state.xv[2:3], z[:, 0:1], z[:, 1:2],
        *pk.sym2_host(R))
    tgt = torch.clamp(slot, 0, state.capacity - 1)
    scatter_slots(state.lm, tgt, torch.stack([nx, ny]), ok)
    scatter_slots(state.lm_P, tgt, torch.stack([p00, p01, p11]), ok)
    set_table(state.da_table, ids, slot, ok)
    return state._replace(n=state.n + ok.sum(dtype=torch.int32))


def resample_gate(logw, n_min: float, do_resample: bool
                  ) -> tuple[torch.Tensor, bool]:
    """(normalized log weights, whether to resample): the Neff gate,
    read on the host (one counted sync) unless resampling is off."""
    logw_n = rs.normalize_log_weights(logw)
    neff = torch.exp(-torch.logsumexp(2.0 * logw_n, dim=-1))
    return logw_n, bool(do_resample) and host_bool(neff < n_min)


def resample(state: ParticleState, n_min: float, do_resample: bool,
             uniform_at: rs.UniformAt) -> ParticleState:
    """Neff-gated stratified resampling and ancestor gather. The gate
    is read on the host (one sync); when it fires, the gather runs on
    G2 from the offspring bounds if P % BOUNDS_ALIGN == 0, else on G1 from the
    ancestor vector, as the JAX package dispatches."""
    n = state.n_particles
    logw_n, fired = resample_gate(state.logw, n_min, do_resample)
    if not fired:
        return state._replace(logw=logw_n)
    if n % BOUNDS_ALIGN == 0:
        S = rs.offspring_bounds(rs.cumulative_weights(logw_n), n,
                                uniform_at)
        state = gather_particles_bounds(state, S)
    else:
        state = gather_particles(state,
                                 rs.stratified_indices(logw_n, uniform_at))
    return state._replace(logw=torch.full_like(logw_n, -math.log(n)))
