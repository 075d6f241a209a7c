"""Landmark-block EKF-SLAM, the one-card arm (counterpart:
slam_tpu.parallel.ekf).

At 10k landmarks the joint covariance is [20003, 20003] float32, 1.6 GB,
and the dense EKF's heading observe alone (two N^3 products per tick)
cannot run. This estimator keeps the covariance in blocks,

    P = [ P00  P0m ]     P00 [3, 3]     pose block
        [ P0m' Pmm ]     P0m [3, 2L]    pose-landmark
                         Pmm [2L, 2L]   landmark-landmark

and touches Pmm once per observe: the per-tick predict and heading
observe change P00 and P0m only, their rank-1 Pmm terms wait in ``hk``,
and the batch update subtracts them together with its own rank-2K term
in one in-place product over Pmm.

The bodies are written against the rows of Pmm that a shard owns
(``row_lo`` and ``rows``), as the JAX package's are: on one card the
only shard owns them all (row_lo = 0, rows = 2L), and the JAX package's
``psum`` and ``all_gather`` over the landmark axis are the identity.
The collectives of several cards are not ported (ROADMAP.md, Queue 1).

Writes the JAX package drops (``mode="drop"``) are additions here:
slots >= n hold exact zeros in x, P0m and Pmm, and every update keeps
them zero, so adding a new feature's values into them is exact, and a
masked observation adds zeros.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.device import default_device
from slam_tpu_torch.geometry import wrap_angle
from slam_tpu_torch.models import rbpf
from slam_tpu_torch.models.ekf import (
    feature_pose_jacobian,
    full_f32,
    gated_nearest,
    innovation_stats,
    known_association,
    motion_jacobians,
    new_block,
    noise_matrices,
)
from slam_tpu_torch.ops.jacobians import compute_jacobians
from slam_tpu_torch.ops.kalman import (
    add_feature_init,
    cholesky_lower,
    innovation,
    solve_lower,
)


class ShardedEKFState(NamedTuple):
    """Joint EKF state with the covariance in blocks.

    ``x``: [3 + 2L] joint mean. ``P00``: [3, 3]. ``P0m``: [3, 2L].
    ``Pmm``: [rows, 2L], the rows this card owns (all 2L on one card).
    ``n``: [] int32 live landmark count. ``da_table``: [n_map] id ->
    slot.

    ``hk`` [2L, D] / ``hk_n``: the deferred heading terms. Each scalar
    heading observe subtracts (1/s) c c' from the joint covariance; its
    Pmm block feeds only the next observe (predict reads P00 and P0m),
    so the scaled columns u_t = c_m / sqrt(s_t) collect here and fold
    into Pmm once per observe: the true Pmm is stored Pmm - hk hk'.
    ``hk_n``, the number of columns used, is a host integer: it counts
    predicts since the last observe, known without reading the card.
    """
    x: torch.Tensor
    P00: torch.Tensor
    P0m: torch.Tensor
    Pmm: torch.Tensor
    n: torch.Tensor
    da_table: torch.Tensor
    hk: torch.Tensor
    hk_n: int

    @property
    def capacity(self) -> int:
        return (self.x.shape[-1] - 3) // 2

    @property
    def pose(self) -> torch.Tensor:
        return self.x[:3]


SHARDED_FIELDS = ShardedEKFState._fields


def sharded_ekf_init(capacity: int, n_map_landmarks: int,
                     dtype=torch.float32, n_defer: int = 16,
                     device=None) -> ShardedEKFState:
    """Zero pose, zero covariance, empty map, ``n_defer`` columns for
    deferred heading terms; on ``device`` (none named: the card)."""
    device = default_device(device)
    L2 = 2 * capacity
    f32 = dict(dtype=dtype, device=device)
    return ShardedEKFState(
        x=torch.zeros(3 + L2, **f32),
        P00=torch.zeros((3, 3), **f32),
        P0m=torch.zeros((3, L2), **f32),
        Pmm=torch.zeros((L2, L2), **f32),
        n=torch.zeros((), dtype=torch.int32, device=device),
        da_table=torch.full((n_map_landmarks,), -1, dtype=torch.int32,
                            device=device),
        hk=torch.zeros((L2, n_defer), **f32),
        hk_n=0,
    )


def sharded_state_from_numpy(arrays, device=None) -> ShardedEKFState:
    """ShardedEKFState from a mapping of the JAX package's field names
    to arrays (``hk_n`` a number); ``device`` as in
    ``sharded_ekf_init``."""
    device = default_device(device)

    def tensor(f):
        a = np.asarray(arrays[f])
        dtype = np.int32 if f in ("n", "da_table") else np.float32
        return torch.from_numpy(np.array(a, dtype=dtype, copy=True)
                                ).to(device)
    return ShardedEKFState(
        **{f: tensor(f) for f in SHARDED_FIELDS if f != "hk_n"},
        hk_n=int(arrays["hk_n"]))


def sharded_state_to_numpy(state: ShardedEKFState) -> dict:
    """The inverse of ``sharded_state_from_numpy``."""
    out = {f: getattr(state, f).detach().cpu().numpy()
           for f in SHARDED_FIELDS if f != "hk_n"}
    out["hk_n"] = state.hk_n
    return out


# ---------------------------------------------------------------------------
# Shard-local step bodies
# ---------------------------------------------------------------------------

def _predict_local(state: ShardedEKFState, v, g, Q, wheelbase, dt, phi,
                   sigma_phi, heading_known: bool, row_lo: int
                   ) -> ShardedEKFState:
    """Bicycle predict (pose block and cross rows only; Pmm untouched),
    then the optional scalar heading Joseph update, whose Pmm term is a
    rank-1 outer product, deferred into ``hk``."""
    x = state.x
    v = torch.as_tensor(v, dtype=x.dtype, device=x.device)
    g = torch.as_tensor(g, dtype=x.dtype, device=x.device)
    Gv, Gu, (dx, dy, heading) = motion_jacobians(x[2], v, g, wheelbase, dt)
    P00 = (Gv @ state.P00) @ Gv.T + (Gu @ Q) @ Gu.T
    P0m = Gv @ state.P0m
    x = torch.cat([torch.stack([x[0] + dx, x[1] + dy, heading]), x[3:]])
    if not heading_known:
        return state._replace(x=x, P00=P00, P0m=P0m)

    # Scalar heading observe on the blocks. With c = P[:, 2] and
    # W = c / s the Joseph form collapses (exactly, for a scalar
    # observation) to P' = P - W c' - c W' + s W W'; its Pmm block is
    # -(1/s) c_m c_m', deferred.
    s_inn = P00[2, 2] + sigma_phi * sigma_phi
    cp, cm = P00[:, 2], P0m[2, :]
    Wp, Wm = cp / s_inn, cm / s_inn
    vh = wrap_angle(phi - x[2])
    x = x + torch.cat([Wp, Wm]) * vh
    x[2] = wrap_angle(x[2])
    P00 = (P00 - torch.outer(Wp, cp) - torch.outer(cp, Wp)
           + s_inn * torch.outer(Wp, Wp))
    P0m = (P0m - torch.outer(Wp, cm) - torch.outer(cp, Wm)
           + s_inn * torch.outer(Wp, Wm))
    u = cm / torch.sqrt(s_inn)
    state = state._replace(x=x, P00=P00, P0m=P0m)
    if state.hk_n < state.hk.shape[1]:
        state.hk[:, state.hk_n] = u
        return state._replace(hk_n=state.hk_n + 1)
    # No free column (more predicts per observe than n_defer): this
    # tick's term goes into Pmm now.
    rows = state.Pmm.shape[0]
    state.Pmm.addr_(u[row_lo:row_lo + rows], u, alpha=-1.0)
    return state


def _diag_blocks_local(Pmm_local, row_lo: int):
    """[rows / 2, 2, 2] diagonal blocks owned by this shard: local row r
    of the slab is global row row_lo + r."""
    rows = Pmm_local.shape[0]
    d = torch.diagonal(Pmm_local, offset=row_lo)             # P[i, i]
    d1 = torch.diagonal(Pmm_local, offset=row_lo + 1)[:rows - 1]
    p00, p11, p01 = d[0::2], d[1::2], d1[0::2]
    return torch.stack([torch.stack([p00, p01], -1),
                        torch.stack([p01, p11], -1)], -2)


def _owned_rows(Pmm_local, idx, row_lo: int):
    """Rows ``idx`` (global) of Pmm that this shard owns, zero for the
    others: [len(idx), 2L]. Summed over shards, the rows themselves."""
    rows = Pmm_local.shape[0]
    local = idx - row_lo
    own = (local >= 0) & (local < rows)
    got = Pmm_local[torch.clamp(local, 0, rows - 1)]
    return torch.where(own[:, None], got, 0.0)


def _update_local(state: ShardedEKFState, z, ids, zmask, R, Re,
                  gate_reject: float, gate_augment: float,
                  association_known: bool, row_lo: int
                  ) -> ShardedEKFState:
    """Observe step: associate -> batch update -> augment, on the
    blocks. Pmm is written in place."""
    K = z.shape[0]
    L = state.capacity
    N2 = 2 * L
    dev = state.x.device
    rows = state.Pmm.shape[0]

    # Deferred heading terms: true Pmm = stored Pmm - hk hk'. The cheap
    # reads below take the low-rank correction; the subtraction itself
    # rides the batch update's one pass over Pmm.
    hk = state.hk[:, :state.hk_n]

    lm = state.x[3:].reshape(L, 2)
    valid = torch.arange(L, device=dev) < state.n
    # The diagonal blocks: each shard's own, gathered (one shard: all).
    Pjj = _diag_blocks_local(state.Pmm, row_lo)
    hk_blk = hk.reshape(L, 2, hk.shape[1])
    Pjj = Pjj - torch.einsum("lad,lbd->lab", hk_blk, hk_blk)

    # ---- association ---------------------------------------------------
    if association_known:
        assoc, is_new = known_association(state.da_table, ids, zmask)
    else:
        nis, nd = innovation_stats(state.pose, lm, valid, state.P00,
                                   state.P0m.T.reshape(L, 2, 3), Pjj, z,
                                   zmask, Re)
        assoc, is_new = gated_nearest(nis, nd, zmask, gate_reject,
                                      gate_augment)
    matched = assoc >= 0
    slot = torch.where(matched, assoc, 0).long()

    # ---- batch update --------------------------------------------------
    zp, Hv, Hf, _ = compute_jacobians(state.pose, lm[slot], Pjj[slot], R)
    Hv = torch.where(matched[:, None, None], Hv, 0.0)
    Hf = torch.where(matched[:, None, None], Hf, 0.0)
    Hp = Hv.reshape(2 * K, 3)                                # [2K, 3]
    # H = [Hp | Hm], where Hm's row pair k holds Hf_k at the columns
    # gcol[2k : 2k + 2] of the matched landmark. Products with Hm are
    # gathers of those columns (two nonzeros a row: the same sums).
    gcol = (2 * slot[:, None] + torch.arange(2, device=dev)).reshape(-1)

    v = torch.where(matched[:, None], innovation(z, zp), 0.0).reshape(2 * K)

    # PHt pose rows [3, 2K]: P00 Hp' + P0m Hm'.
    P0m_obs = state.P0m[:, gcol].reshape(3, K, 2)
    PHt_p = state.P00 @ Hp.T + torch.einsum(
        "ckb,kab->cka", P0m_obs, Hf).reshape(3, 2 * K)
    # PHt landmark rows: Pm0 Hp' + Pmm Hm'. By symmetry Pmm Hm' needs
    # only Pmm's observed rows, with the deferred correction.
    obs_rows = _owned_rows(state.Pmm, gcol, row_lo)          # [2K, 2L]
    obs_rows = obs_rows - hk[gcol] @ hk.T
    HmP = torch.einsum("kab,kbn->kan", Hf, obs_rows.reshape(K, 2, N2)
                       ).reshape(2 * K, N2)
    PHt_m_loc = (state.P0m[:, row_lo:row_lo + rows].T @ Hp.T
                 + HmP[:, row_lo:row_lo + rows].T)           # [rows, 2K]

    # S = H P H' + R; the landmark contraction is a sum over shards.
    HmPHt = torch.einsum("kab,kbc->kac", Hf,
                         _owned_rows(PHt_m_loc, gcol, row_lo
                                     ).reshape(K, 2, 2 * K))
    S = Hp @ PHt_p + HmPHt.reshape(2 * K, 2 * K)
    RR = torch.kron(torch.eye(K, dtype=S.dtype, device=dev), R)
    S = 0.5 * (S + S.T) + RR
    S = S + 1e-6 * torch.trace(S) / (2 * K) * torch.eye(
        2 * K, dtype=S.dtype, device=dev)

    Lc = cholesky_lower(S)
    # W1 = PHt L^-T ; P -= W1 W1' ; x += PHt S^-1 v.
    W1_p = solve_lower(Lc, PHt_p.T).T                        # [3, 2K]
    W1_m_loc = solve_lower(Lc, PHt_m_loc.T).T                # [rows, 2K]
    W1_m = W1_m_loc                     # gathered over the shards: one
    sv = solve_lower(Lc, v)
    x = state.x + torch.cat([W1_p @ sv, W1_m @ sv])
    x[2] = wrap_angle(x[2])

    P00 = state.P00 - W1_p @ W1_p.T
    P0m = state.P0m - W1_p @ W1_m.T
    # The one pass over Pmm: the batch update and the deferred heading
    # terms, Pmm -= [W1_m | hk] [W1_m | hk]', in place.
    W = torch.cat([W1_m, hk], 1)                             # [2L, 2K + D]
    Pmm = state.Pmm.addmm_(W[row_lo:row_lo + rows], W.T, alpha=-1.0)
    state = state._replace(x=x, P00=0.5 * (P00 + P00.T), P0m=P0m, Pmm=Pmm,
                           hk=state.hk.zero_(), hk_n=0)

    # ---- augment -------------------------------------------------------
    return _augment_local(state, z, ids, is_new, Re, row_lo)


def _augment_local(state: ShardedEKFState, z, ids, is_new, Re,
                   row_lo: int) -> ShardedEKFState:
    """Batch augment on the blocks. New feature i at slot s_i:
        x[3 + 2s_i : 3 + 2s_i + 2]  = xf_i
        P0m[:, 2s_i : 2s_i + 2]     = P00 Gv_i'
        Pmm rows and columns 2s_i.. = Gv_i P0m, the new-new block
    (the closed form of ``models.ekf.ekf_augment``). Every target holds
    zero before, so the values are added in place; masked observations
    add zeros."""
    K = z.shape[0]
    rows = state.Pmm.shape[0]

    slot, ok = rbpf.new_slots(state, is_new)
    okf = ok.to(state.x.dtype)
    okc = okf[:, None].expand(K, 2).reshape(2 * K)
    cols = (2 * torch.where(ok, slot, 0)[:, None]
            + torch.arange(2, device=z.device)).reshape(-1).long()

    xf, Gz = add_feature_init(state.pose, z)
    Gv = feature_pose_jacobian(state.x[2], z)                # [K, 2, 3]
    x = state.x.index_add(0, 3 + cols, (xf * okf[:, None]).reshape(-1))

    # Cross terms against the existing state: Gv_i [P00 | P0m].
    Bp = torch.einsum("kab,bc->kac", Gv, state.P00).reshape(2 * K, 3)
    Bm = torch.einsum("kab,bn->kan", Gv, state.P0m).reshape(2 * K, -1)
    Bm = Bm * okc[:, None]
    P0m = state.P0m.index_add(1, cols, (Bp * okc[:, None]).T)

    # New rows owned here: the cross terms, plus the new-new block at
    # the new columns (Bm is zero there: P0m was).
    NN = new_block(Gv, Gz, state.P00, Re) * (okc[:, None] * okc[None, :])
    new_rows = Bm.index_add(1, cols, NN)                     # [2K, 2L]
    local = cols - row_lo
    own = (local >= 0) & (local < rows)
    state.Pmm.index_add_(0, torch.clamp(local, 0, rows - 1),
                         new_rows * own[:, None])
    # New columns on every owned row; at the new rows Bm adds zero.
    state.Pmm.index_add_(1, cols, Bm[:, row_lo:row_lo + rows].T)

    rbpf.set_table(state.da_table, ids, slot, ok)
    return state._replace(x=x, P0m=P0m,
                          n=state.n + torch.sum(ok, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Estimator (Runner-compatible)
# ---------------------------------------------------------------------------

class ShardedEkfSlam:
    """Landmark-block EKF-SLAM on one device (the card, unless
    ``device`` names another), with the estimator interface of
    ``models.ekf.EkfSlam``. The one shard owns every row of Pmm
    (row_lo = 0), so the capacity needs no padding."""

    IS_EKF = True

    def __init__(self, config: SlamConfig, n_map_landmarks: int,
                 device=None):
        self.config = config
        self.n_map = n_map_landmarks
        self.device = default_device(device)
        self.capacity = config.max_landmarks or n_map_landmarks
        self.Q, self.R, self.Re = noise_matrices(config, self.device)

    def init(self, n_particles=None) -> ShardedEKFState:
        return sharded_ekf_init(self.capacity, self.n_map,
                                device=self.device)

    def predict(self, state, generator, vn, gn, phi) -> ShardedEKFState:
        del generator
        cfg = self.config
        with full_f32():
            return _predict_local(
                state, vn, gn, self.Q, cfg.WHEELBASE, cfg.DT_CONTROLS, phi,
                cfg.sigmaT, bool(cfg.SWITCH_HEADING_KNOWN), row_lo=0)

    def update(self, state, generator, z, ids, zmask) -> ShardedEKFState:
        del generator
        cfg = self.config
        with full_f32():
            return _update_local(
                state, z, ids, zmask, self.R, self.Re, cfg.GATE_REJECT,
                cfg.GATE_AUGMENT, bool(cfg.SWITCH_ASSOCIATION_KNOWN),
                row_lo=0)

    def pose(self, state) -> torch.Tensor:
        """The joint state's head, x[:3], as a copy."""
        return state.x[:3].clone()


def dense_covariance(state: ShardedEKFState) -> torch.Tensor:
    """The dense [3+2L, 3+2L] joint covariance, with the deferred
    heading terms folded (for tests)."""
    hk = state.hk[:, :state.hk_n]
    Pmm = state.Pmm - hk @ hk.T
    top = torch.cat([state.P00, state.P0m], dim=1)
    bot = torch.cat([state.P0m.T, Pmm], dim=1)
    return torch.cat([top, bot], dim=0)
