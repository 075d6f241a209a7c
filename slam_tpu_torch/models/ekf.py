"""EKF-SLAM: the joint-state extended Kalman filter over pose and
landmarks (counterpart: slam_tpu.models.ekf).

The state has a fixed capacity of ``L`` landmarks: x = [x, y, theta,
lm0x, lm0y, lm1x, ...], ``n`` live landmarks, and slots >= n masked out
of every computation. Association is one batched [K, L] gated
nearest-neighbour computation, the batch update one dense [2K, N] Kalman
step, and new landmarks enter in one masked write.

A superstep reads nothing back to the host: shapes are fixed, every
branch is a ``torch.where``, the factorizations are the ``_ex`` forms,
and writes that the JAX package drops (``mode="drop"``) land in a
padding row or column that is cut off afterwards. The products run in
full float32 whatever the caller's TF32 setting (``full_f32``).
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.device import default_device
from slam_tpu_torch.geometry import wrap_angle
from slam_tpu_torch.models import rbpf
from slam_tpu_torch.ops.jacobians import compute_jacobians
from slam_tpu_torch.ops.kalman import (
    add_feature_init,
    cholesky_update,
    innovation,
    inv_2x2,
    joseph_update,
)


@contextlib.contextmanager
def full_f32():
    """CUDA float32 matmuls without TF32 inside, the caller's setting
    restored after. A reduced-precision product random-walks the
    covariance indefinite (the JAX package pins HIGHEST for the same
    reason). Only a host flag changes: no device work, no sync. The
    flag is ``allow_tf32``, which keeps PyTorch's older and newer
    precision settings of cuBLAS in step."""
    matmul = torch.backends.cuda.matmul
    if not matmul.allow_tf32:
        yield
        return
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = True


def _diag_blocks_2x2(Pm, L: int):
    """[L, 2, 2] per-landmark diagonal blocks of the [2L, 2L] map
    covariance, read from its main and first upper diagonal."""
    d0 = torch.diagonal(Pm)                   # [2L]
    d1 = torch.diagonal(Pm, offset=1)         # [2L - 1]
    p00, p11, p01 = d0[0::2], d0[1::2], d1[0::2]
    return torch.stack([torch.stack([p00, p01], -1),
                        torch.stack([p01, p11], -1)], -2)


class EKFState(NamedTuple):
    """Fixed-capacity joint EKF state.

    ``x``: [3 + 2L] joint mean. ``P``: [3+2L, 3+2L] joint covariance.
    ``n``: [] int32 live landmark count. ``da_table``: [n_map] int32
    true landmark id -> state slot (-1 unseen).
    """
    x: torch.Tensor
    P: torch.Tensor
    n: torch.Tensor
    da_table: torch.Tensor

    @property
    def capacity(self) -> int:
        return (self.x.shape[-1] - 3) // 2

    @property
    def pose(self) -> torch.Tensor:
        return self.x[:3]

    def landmarks(self) -> tuple[torch.Tensor, torch.Tensor]:
        """([L, 2] means, [L] validity mask)."""
        L = self.capacity
        valid = torch.arange(L, device=self.x.device) < self.n
        return self.x[3:].reshape(L, 2), valid


EKF_FIELDS = EKFState._fields


def ekf_init(capacity: int, n_map_landmarks: int, dtype=torch.float32,
             device=None) -> EKFState:
    """Zero pose, zero covariance, empty map, on ``device`` (none named:
    the card, ``device.default_device``)."""
    device = default_device(device)
    N = 3 + 2 * capacity
    return EKFState(
        x=torch.zeros(N, dtype=dtype, device=device),
        P=torch.zeros((N, N), dtype=dtype, device=device),
        n=torch.zeros((), dtype=torch.int32, device=device),
        da_table=torch.full((n_map_landmarks,), -1, dtype=torch.int32,
                            device=device),
    )


def ekf_state_from_numpy(arrays, device=None) -> EKFState:
    """EKFState from a mapping of the JAX package's field names (``x``,
    ``P``, ``n``, ``da_table``) to arrays; ``device`` as in
    ``ekf_init``."""
    device = default_device(device)
    dtypes = dict(x=np.float32, P=np.float32, n=np.int32, da_table=np.int32)
    return EKFState(**{
        f: torch.from_numpy(np.array(arrays[f], dtype=dtypes[f],
                                     copy=True)).to(device)
        for f in EKF_FIELDS})


def ekf_state_to_numpy(state: EKFState) -> dict:
    """The inverse of ``ekf_state_from_numpy``: a dict of numpy arrays."""
    return {f: getattr(state, f).detach().cpu().numpy() for f in EKF_FIELDS}


# ---------------------------------------------------------------------------
# Predict
# ---------------------------------------------------------------------------

def motion_jacobians(theta, v, g, wheelbase: float, dt: float):
    """(Gv [3, 3], Gu [3, 2], new pose increments (dx, dy, heading))
    of one bicycle step from heading ``theta`` with controls (v, g)."""
    s, c = torch.sin(g + theta), torch.cos(g + theta)
    vts, vtc = v * dt * s, v * dt * c
    one, zero = torch.ones_like(theta), torch.zeros_like(theta)
    Gv = torch.stack([torch.stack([one, zero, -vts]),
                      torch.stack([zero, one, vtc]),
                      torch.stack([zero, zero, one])])
    sg, cg = torch.sin(g), torch.cos(g)
    Gu = torch.stack([
        torch.stack([dt * c, -vts]),
        torch.stack([dt * s, vtc]),
        torch.stack([dt * sg / wheelbase, v * dt * cg / wheelbase]),
    ])
    heading = wrap_angle(theta + v * dt * sg / wheelbase)
    return Gv, Gu, (vtc, vts, heading)


def ekf_predict(state: EKFState, v, g, Q, wheelbase: float, dt: float
                ) -> EKFState:
    """Bicycle-model predict with exact sparse covariance propagation:
    only the pose block and the pose-landmark cross rows change, O(N)
    work. Writes the pose of ``x`` and the pose rows and columns of
    ``P`` in place and returns the state. ``Q``: [2, 2] control noise
    covariance (v, g)."""
    x, P = state.x, state.P
    v = torch.as_tensor(v, dtype=x.dtype, device=x.device)
    g = torch.as_tensor(g, dtype=x.dtype, device=x.device)
    Gv, Gu, (dx, dy, heading) = motion_jacobians(x[2], v, g, wheelbase, dt)
    P00 = (Gv @ P[:3, :3]) @ Gv.T + (Gu @ Q) @ Gu.T
    P0m = Gv @ P[:3, 3:]
    pose = torch.stack([x[0] + dx, x[1] + dy, heading])
    P[:3, :3] = P00
    P[:3, 3:] = P0m
    P[3:, :3] = P0m.T
    x[:3] = pose
    return state


def ekf_observe_heading(state: EKFState, phi, sigma_phi: float
                        ) -> EKFState:
    """Scalar heading observation, Joseph form on the full joint
    state."""
    H = torch.zeros_like(state.x)
    H[2].fill_(1.0)          # a fill, not a copy of a host scalar (a sync)
    v = wrap_angle(phi - state.x[2])
    x, P = joseph_update(state.x, state.P, v, sigma_phi * sigma_phi, H)
    x[2] = wrap_angle(x[2])
    return state._replace(x=x, P=P)


# ---------------------------------------------------------------------------
# Data association
# ---------------------------------------------------------------------------

def innovation_stats(pose, lm, valid, P00, P0j, Pjj, z, zmask, R):
    """NIS and NIS + log det S for every (observation, landmark) pair
    against the joint covariance: for landmark j, H = [Hv | .. Hf_j ..]
    and S_j = Hv P00 Hv' + Hv P0j' Hf' + Hf P0j Hv' + Hf Pjj Hf' + R.

    pose [3]; lm [L, 2]; valid [L]; P00 [3, 3]; P0j [L, 2, 3] (the
    landmark rows of the cross block); Pjj [L, 2, 2]; z [K, 2]; zmask
    [K]. Returns (nis [K, L], nd [K, L]), +inf where the landmark is not
    live or the observation is masked."""
    zp, Hv, Hf, _ = compute_jacobians(pose, lm, Pjj, R)      # [L, ...]
    HvP00 = torch.einsum("lab,bc->lac", Hv, P00)
    t1 = torch.einsum("lab,lcb->lac", HvP00, Hv)
    HfPj0 = torch.einsum("lab,lbc->lac", Hf, P0j)
    t2 = torch.einsum("lab,lcb->lac", HfPj0, Hv)
    t3 = torch.einsum("lab,lbc,ldc->lad", Hf, Pjj, Hf)
    S = t1 + t2 + t2.transpose(-1, -2) + t3 + R
    S = 0.5 * (S + S.transpose(-1, -2))                      # [L, 2, 2]

    vfull = innovation(z[:, None, :], zp[None, :, :])        # [K, L, 2]
    nis = torch.einsum("kla,lab,klb->kl", vfull, inv_2x2(S), vfull)
    det = S[:, 0, 0] * S[:, 1, 1] - S[:, 0, 1] * S[:, 1, 0]
    nd = nis + torch.log(torch.clamp(det, min=1e-30))[None, :]

    bad = ~(valid[None, :] & zmask[:, None])
    return torch.where(bad, math.inf, nis), torch.where(bad, math.inf, nd)


def _innovation_stats(state: EKFState, z, zmask, R):
    """``innovation_stats`` on the dense state."""
    L = state.capacity
    P = state.P
    lm, valid = state.landmarks()
    return innovation_stats(state.pose, lm, valid, P[:3, :3],
                            P[:3, 3:].T.reshape(L, 2, 3),
                            _diag_blocks_2x2(P[3:, 3:], L), z, zmask, R)


def gated_nearest(nis, nd, zmask, gate_reject: float, gate_augment: float):
    """Gated nearest neighbour over the [K, L] statistics: (assoc [K]
    int32 slot or -1, is_new [K] bool). A row with no live landmark is
    all +inf: no match, and a new feature."""
    gated_nd = torch.where(nis < gate_reject, nd, math.inf)
    best = torch.argmin(gated_nd, dim=1).to(torch.int32)
    matched = torch.isfinite(torch.amin(gated_nd, dim=1))
    assoc = torch.where(matched & zmask, best, -1)
    # New iff every live landmark is outside the augment gate.
    is_new = (torch.amin(nis, dim=1) > gate_augment) & zmask
    return assoc, is_new


def ekf_data_associate(state: EKFState, z, zmask, R, gate_reject: float,
                       gate_augment: float):
    """Gated nearest-neighbour association, one batched computation.
    Returns (assoc [K] int32 slot or -1, is_new [K] bool)."""
    nis, nd = _innovation_stats(state, z, zmask, R)
    return gated_nearest(nis, nd, zmask, gate_reject, gate_augment)


def known_association(da_table, ids, zmask):
    """Observed true id -> stored slot through the table; unseen ids
    become new features."""
    idx = torch.clamp(ids, 0, da_table.shape[0] - 1).long()
    slot = da_table[idx]
    assoc = torch.where(zmask & (slot >= 0), slot, -1)
    return assoc, zmask & (slot < 0)


def ekf_data_associate_known(state: EKFState, ids, zmask):
    """Table-based known association: (assoc, is_new)."""
    return known_association(state.da_table, ids, zmask)


# ---------------------------------------------------------------------------
# Batch update
# ---------------------------------------------------------------------------

def ekf_batch_update(state: EKFState, z, assoc, R) -> EKFState:
    """One dense Kalman step over all matched observations. Unmatched
    slots contribute zero rows of H and zero innovation, exactly no
    update, so the shapes are fixed: [2K, N]."""
    K = z.shape[0]
    L = state.capacity
    N = 3 + 2 * L
    x, P = state.x, state.P
    matched = assoc >= 0
    slot = torch.where(matched, assoc, 0).long()

    lm, _ = state.landmarks()
    Pjj = _diag_blocks_2x2(P[3:, 3:], L)
    zp, Hv, Hf, _ = compute_jacobians(state.pose, lm[slot], Pjj[slot], R)

    # H rows: the pose block, and each landmark's 2x2 block at its
    # columns 3 + 2 slot + (0, 1).
    H = torch.zeros((K, 2, N), dtype=P.dtype, device=P.device)
    H[:, :, :3] = Hv
    cols = 3 + 2 * slot[:, None, None] + torch.arange(
        2, device=P.device)[None, None, :]
    H.scatter_(2, cols.expand(K, 2, 2), Hf)
    H = torch.where(matched[:, None, None], H, 0.0)
    v = torch.where(matched[:, None], innovation(z, zp), 0.0)

    RR = torch.kron(torch.eye(K, dtype=P.dtype, device=P.device), R)
    x_new, P_new = cholesky_update(x, P, v.reshape(2 * K), RR,
                                   H.reshape(2 * K, N))
    x_new[2] = wrap_angle(x_new[2])
    # Symmetrize: the subtractive form drifts off-symmetric in f32.
    return state._replace(x=x_new, P=0.5 * (P_new + P_new.T))


# ---------------------------------------------------------------------------
# Augment
# ---------------------------------------------------------------------------

def feature_pose_jacobian(theta, z):
    """[K, 2, 3] d(landmark)/d(pose) of initialization from (range,
    bearing) z [K, 2] at heading ``theta``."""
    r, b = z[..., 0], z[..., 1]
    sg = torch.sin(theta + b)
    cg = torch.cos(theta + b)
    one, zero = torch.ones_like(r), torch.zeros_like(r)
    return torch.stack([torch.stack([one, zero, -r * sg], -1),
                        torch.stack([zero, one, r * cg], -1)], -2)


def new_block(Gv, Gz, P00, Re):
    """[2K, 2K] covariance block of K new features: Gv_i P00 Gv_j', plus
    Gz_i Re Gz_i' on the diagonal blocks (the closed form of adding them
    one after another)."""
    K = Gv.shape[0]
    NN = torch.einsum("kab,bc,ldc->kald", Gv, P00, Gv)       # [K,2,K,2]
    diag = torch.einsum("kab,bc,kdc->kad", Gz, Re, Gz)       # [K,2,2]
    ar = torch.arange(K, device=Gv.device)
    NN[ar, :, ar, :] += diag
    return NN.reshape(2 * K, 2 * K)


def ekf_augment(state: EKFState, z, ids, is_new, R) -> EKFState:
    """Add all new features at once. Sequential equivalence: adding
    feature i sets its cross rows to Gv_i P[0:3, :]; a feature j added
    later then gets P[j, i] = Gv_j P00 Gv_i', reproduced in closed form
    for the batch. Rows of masked or overflowing observations go to a
    padding row and column that are cut off. The id table is written in
    place."""
    K = z.shape[0]
    L = state.capacity
    N = 3 + 2 * L
    x, P = state.x, state.P

    slot, ok = rbpf.new_slots(state, is_new)
    rows = 3 + 2 * slot[:, None] + torch.arange(2, device=x.device)
    flat_rows = torch.where(ok[:, None], rows, N).reshape(-1).long()

    xf, Gz = add_feature_init(state.pose, z)             # [K,2], [K,2,2]
    Gv = feature_pose_jacobian(x[2], z)                  # [K, 2, 3]
    B = torch.einsum("kab,bn->kan", Gv, P[:3, :]).reshape(2 * K, N)
    NN = new_block(Gv, Gz, P[:3, :3], R)

    x_pad = torch.cat([x, x.new_zeros(1)])
    x_pad[flat_rows] = xf.reshape(-1)
    P_pad = torch.nn.functional.pad(P, (0, 1, 0, 1))
    P_pad[flat_rows, :N] = B
    P_pad[:N, flat_rows] = B.T
    P_pad[flat_rows[:, None], flat_rows[None, :]] = NN

    rbpf.set_table(state.da_table, ids, slot, ok)
    return state._replace(x=x_pad[:N], P=P_pad[:N, :N].contiguous(),
                          n=state.n + torch.sum(ok, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Full steps and the config-bound estimator
# ---------------------------------------------------------------------------

def ekf_step(state: EKFState, z, ids, zmask, R, Re, *,
             association_known: bool, gate_reject: float,
             gate_augment: float, batch_update: bool = True) -> EKFState:
    """Observe step: associate (with Re) -> batch update (with the true
    sensor R, as the reference does) -> augment (with Re). Predict and
    the heading observe run every control tick separately."""
    if association_known:
        assoc, is_new = ekf_data_associate_known(state, ids, zmask)
    else:
        assoc, is_new = ekf_data_associate(state, z, zmask, Re,
                                           gate_reject, gate_augment)
    if batch_update:
        state = ekf_batch_update(state, z, assoc, R)
    return ekf_augment(state, z, ids, is_new, Re)


def noise_matrices(config: SlamConfig, device):
    """(Qe, R, Re) as [2, 2] diagonal float32 tensors on ``device``,
    made once so that no step copies host values to the card."""
    def diag(values):
        return torch.diag(torch.tensor(np.asarray(values, np.float32))
                          ).to(device)
    return diag(config.Qe), diag(config.R), diag(config.Re)


class EkfSlam:
    """Config-bound EKF-SLAM on one device (the card, unless ``device``
    names another), with the estimator interface of FastSlam1."""

    # Runner hint: an EKF observes the noisy IMU heading each tick;
    # the particle filters get the true heading.
    IS_EKF = True

    def __init__(self, config: SlamConfig, n_map_landmarks: int,
                 device=None):
        self.config = config
        self.n_map = n_map_landmarks
        self.device = default_device(device)
        self.capacity = config.max_landmarks or n_map_landmarks
        self.Q, self.R, self.Re = noise_matrices(config, self.device)

    def init(self, n_particles=None) -> EKFState:
        return ekf_init(self.capacity, self.n_map, device=self.device)

    def predict(self, state, generator, vn, gn, phi) -> EKFState:
        """One control tick; ``phi`` is the noisy IMU heading. The EKF
        draws no random numbers: ``generator`` is part of the shared
        interface and unused."""
        del generator
        cfg = self.config
        with full_f32():
            state = ekf_predict(state, vn, gn, self.Q, cfg.WHEELBASE,
                                cfg.DT_CONTROLS)
            if cfg.SWITCH_HEADING_KNOWN:
                state = ekf_observe_heading(state, phi, cfg.sigmaT)
        return state

    def update(self, state, generator, z, ids, zmask) -> EKFState:
        del generator
        cfg = self.config
        with full_f32():
            return ekf_step(
                state, z, ids, zmask, self.R, self.Re,
                association_known=bool(cfg.SWITCH_ASSOCIATION_KNOWN),
                gate_reject=cfg.GATE_REJECT, gate_augment=cfg.GATE_AUGMENT,
                batch_update=bool(cfg.SWITCH_BATCH_UPDATE))

    def pose(self, state) -> torch.Tensor:
        """The joint state's head, x[:3], as a copy (the next predict
        writes x in place)."""
        return state.x[:3].clone()
