"""Struct-of-planes particle state (counterpart:
slam_tpu.models.particles).

The layout is the JAX package's, particle axis last:

    logw [P]          log weights
    xv   [3, P]       poses (x, y, theta)
    Pv   [6, P]       pose covariance, packed symmetric
    lm   [2, L, P]    landmark means
    lm_P [3, L, P]    landmark covariances, packed symmetric (00, 01, 11)
    n    []  int32    live landmark count (shared: known association)
    da_table [n_map] int32   landmark id -> slot, -1 unseen

so ``state_from_numpy`` / ``state_to_numpy`` carry fixtures and
checkpoints across the two packages unchanged. On the card, one thread
per particle reads neighbouring addresses of every plane.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from slam_tpu_torch.device import default_device
from slam_tpu_torch.ops.kernels import bounds_gather_multi, sorted_gather_multi

FIELDS = ("logw", "xv", "Pv", "lm", "lm_P", "n", "da_table")

# Packed-symmetric index maps: Pv's six planes, lm_P's three.
SYM3 = {(0, 0): 0, (0, 1): 1, (0, 2): 2,
        (1, 0): 1, (1, 1): 3, (1, 2): 4,
        (2, 0): 2, (2, 1): 4, (2, 2): 5}
SYM2 = {(0, 0): 0, (0, 1): 1, (1, 0): 1, (1, 1): 2}


class ParticleState(NamedTuple):
    logw: torch.Tensor
    xv: torch.Tensor
    Pv: torch.Tensor
    lm: torch.Tensor
    lm_P: torch.Tensor
    n: torch.Tensor
    da_table: torch.Tensor

    @property
    def n_particles(self) -> int:
        return self.logw.shape[-1]

    @property
    def capacity(self) -> int:
        return self.lm.shape[-2]


def init_particles(n_particles: int, capacity: int, n_map_landmarks: int,
                   device=None, dtype=torch.float32) -> ParticleState:
    """Uniform weights, origin poses, empty maps, on ``device`` (none
    named: the card, ``device.default_device``)."""
    P = n_particles
    device = default_device(device)
    return ParticleState(
        logw=torch.full((P,), -math.log(float(P)), dtype=dtype,
                        device=device),
        xv=torch.zeros((3, P), dtype=dtype, device=device),
        Pv=torch.zeros((6, P), dtype=dtype, device=device),
        lm=torch.zeros((2, capacity, P), dtype=dtype, device=device),
        lm_P=torch.zeros((3, capacity, P), dtype=dtype, device=device),
        n=torch.zeros((), dtype=torch.int32, device=device),
        da_table=torch.full((n_map_landmarks,), -1, dtype=torch.int32,
                            device=device),
    )


def state_from_numpy(arrays, device=None) -> ParticleState:
    """ParticleState from a mapping of the JAX package's field names to
    arrays (numpy, or anything ``np.asarray`` takes), on ``device`` (none
    named: the card, ``device.default_device``)."""
    device = default_device(device)
    return ParticleState(**{
        f: torch.from_numpy(np.array(arrays[f], copy=True)).to(device)
        for f in FIELDS})


def state_to_numpy(state: ParticleState) -> dict:
    """The inverse of ``state_from_numpy``: a dict of numpy arrays."""
    return {f: getattr(state, f).detach().cpu().numpy() for f in FIELDS}


class DeferredState(NamedTuple):
    """The deferred-resample FastSLAM 1 carry (counterpart:
    slam_tpu.models.fastslam1.DeferredState). ``ps`` holds the pose and
    weight rows after the last resample, and the landmark planes from
    before it; ``S`` [P] int32 are the pending offspring bounds
    (arange(1, P + 1) when nothing is pending); ``pending`` is that
    fact, known on the host. The JAX carry's per-block window metadata
    (lo, nch, ident) is the TPU kernel's and has no counterpart."""
    ps: ParticleState
    S: torch.Tensor
    pending: bool


def deferred_state_from_numpy(arrays, device=None) -> DeferredState:
    """DeferredState from the JAX carry's fields: ``arrays["ps"]`` a
    mapping of ParticleState fields, ``arrays["S"]`` the bounds; other
    entries (the window metadata) are ignored. ``device`` as in
    ``state_from_numpy``."""
    device = default_device(device)
    S = np.asarray(arrays["S"], dtype=np.int32)
    identity = np.arange(1, S.shape[0] + 1, dtype=np.int32)
    return DeferredState(ps=state_from_numpy(arrays["ps"], device),
                         S=torch.from_numpy(S.copy()).to(device),
                         pending=not np.array_equal(S, identity))


def deferred_state_to_numpy(state: DeferredState) -> dict:
    """The inverse of ``deferred_state_from_numpy``."""
    return {"ps": state_to_numpy(state.ps),
            "S": state.S.detach().cpu().numpy()}


def estimate_position(state: ParticleState,
                      mode: str = "weighted") -> torch.Tensor:
    """Pose estimate [3]: x/y by "mean", per-axis "median" or
    weight-normalized "weighted" mean; heading always from the
    max-weight particle (the first one on ties, as ``jnp.argmax``)."""
    if mode == "mean":
        xy = torch.mean(state.xv[:2], dim=-1)
    elif mode == "median":
        # The midpoint of the two middle values for even P, as
        # jnp.median (torch.median would take the lower one).
        xy = torch.quantile(state.xv[:2], 0.5, dim=-1)
    else:
        w = torch.softmax(state.logw, dim=-1)
        xy = torch.sum(w[None, :] * state.xv[:2], dim=-1)
    best = torch.argmax(state.logw).reshape(1)
    return torch.cat([xy, state.xv[2].index_select(0, best)])


def pack_particle_planes(state: ParticleState) -> torch.Tensor:
    """All per-particle fields as one [10 + 5L, P] matrix."""
    P, L = state.n_particles, state.capacity
    return torch.cat([state.logw[None, :], state.xv, state.Pv,
                      state.lm.reshape(2 * L, P),
                      state.lm_P.reshape(3 * L, P)], dim=0)


def unpack_particle_planes(state: ParticleState, flat) -> ParticleState:
    """Inverse of pack_particle_planes."""
    L = state.capacity
    N = flat.shape[-1]
    c1, c2, c3, c4 = 1, 4, 10, 10 + 2 * L
    return state._replace(logw=flat[0], xv=flat[c1:c2], Pv=flat[c2:c3],
                          lm=flat[c3:c4].reshape(2, L, N),
                          lm_P=flat[c4:].reshape(3, L, N))


def gather_particles(state: ParticleState, idx) -> ParticleState:
    """Reindex every per-particle field by ancestor indices ``idx``
    (int32 [N]) along the particle axis, through G1."""
    return _gather(state, sorted_gather_multi, idx)


def gather_particles_bounds(state: ParticleState, S) -> ParticleState:
    """The same gather driven by offspring bounds ``S``, through G2."""
    return _gather(state, bounds_gather_multi, S)


def _gather(state: ParticleState, gather_fn, sel) -> ParticleState:
    """One gather call over three row sets: the 10 pose rows packed,
    and the landmark planes as [2L, P] / [3L, P] views (no copy)."""
    P, L = state.n_particles, state.capacity
    small = torch.cat([state.logw[None, :], state.xv, state.Pv], dim=0)
    small_g, lm_g, lmP_g = gather_fn(
        [small, state.lm.reshape(2 * L, P), state.lm_P.reshape(3 * L, P)],
        sel)
    N = small_g.shape[-1]
    return state._replace(logw=small_g[0], xv=small_g[1:4],
                          Pv=small_g[4:10], lm=lm_g.reshape(2, L, N),
                          lm_P=lmP_g.reshape(3, L, N))


# ---------------------------------------------------------------------------
# Packing of symmetric matrices as planes (tests, telemetry)
# ---------------------------------------------------------------------------

def pack_sym2(M: torch.Tensor) -> torch.Tensor:
    """[..., 2, 2] symmetric -> planes (m00, m01, m11) stacked on axis 0."""
    return torch.stack([M[..., 0, 0], M[..., 0, 1], M[..., 1, 1]])


def unpack_sym2(p: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Planes (3, ...) on ``axis`` -> [..., 2, 2] symmetric."""
    m00, m01, m11 = torch.movedim(p, axis, 0)
    return torch.stack([torch.stack([m00, m01], -1),
                        torch.stack([m01, m11], -1)], -2)


def pack_sym3(M: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] symmetric -> planes (6, ...) in SYM3 order."""
    return torch.stack([M[..., 0, 0], M[..., 0, 1], M[..., 0, 2],
                        M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]])


def unpack_sym3(p: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Planes (6, ...) on ``axis`` in SYM3 order -> [..., 3, 3]
    symmetric."""
    a, b, c, d, e, f = torch.movedim(p, axis, 0)
    return torch.stack([torch.stack([a, b, c], -1),
                        torch.stack([b, d, e], -1),
                        torch.stack([c, e, f], -1)], -2)
