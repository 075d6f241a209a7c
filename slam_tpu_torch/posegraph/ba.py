"""Batch bundle adjustment: Gauss-Newton with the landmarks eliminated by
the Schur complement, under Levenberg-Marquardt damping (counterpart:
slam_tpu.posegraph.ba).

Factors: SE(2) odometry between consecutive keyframe poses, range-bearing
observations tying keyframe poses to landmarks (the filters' h, Hv and Hf
of ``ops.planes``), and a prior that anchors pose 0 (the gauge). A trial
step is kept only if the total weighted cost does not rise; otherwise the
damping is raised x10 and the step recomputed from the same point. The
landmark system is block-diagonal, 2x2 per landmark, so

    S   = App - W All^-1 W',        rhs = bp - W All^-1 bl
    dp  = S^-1 rhs,                 dl  = All^-1 (bl - W' dp)

with W, the pose-landmark block, dense [3T, 2L]: S's contraction is one
float32 matrix product (cuBLAS on the card) and the reduced [3T, 3T]
system one Cholesky solve (cuSOLVER), with no host read. Every product
runs in full float32 whatever the caller's TF32 setting (``full_f32``);
the JAX package pins ``Precision.HIGHEST`` for the same reason.

Landmark-indexed sums. The JAX package adds the per-observation terms
into All, bl and W by one-hot contractions, which ride the TPU's matrix
unit; at T = 256, K = 24, L = 10k the one-hot array alone is 246 MB.
Here each sum gathers its observations' terms through an index table and
adds them along one axis (``ObsPlan``). There are no atomics, so the
same inputs give the same bits, which LM needs: it keeps or rejects a
trial by comparing two float costs. The table depends only on the
observations' landmark ids, so a solve builds it once, from one host
read.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from slam_tpu_torch.device import default_device
from slam_tpu_torch.geometry import wrap_angle
from slam_tpu_torch.models.ekf import full_f32
from slam_tpu_torch.ops import planes as pk
from slam_tpu_torch.ops.kalman import cholesky_lower
from slam_tpu_torch.spans import span

# Information weight of the gauge-prior factor anchoring pose 0. It is a
# real factor (its residual pulls pose 0 back to its anchor), not only a
# diagonal stiffener: without the residual the solution can drift to any
# rigid transform of the optimum, since the observation and odometry
# factors are invariant under a global SE(2) motion.
PRIOR_INFO = 1.0e6


@dataclass(frozen=True)
class BAProblem:
    """A bundle-adjustment problem; every tensor on one device."""
    poses0: torch.Tensor      # [T, 3] initial keyframe poses
    landmarks0: torch.Tensor  # [L, 2] initial landmark estimates
    odom: torch.Tensor        # [T-1, 3] measured relative transforms
    odom_info: torch.Tensor   # [3, 3] odometry information matrix
    z: torch.Tensor           # [T, K, 2] observations
    lm_idx: torch.Tensor      # [T, K] landmark index per observation
    mask: torch.Tensor        # [T, K] validity
    R: torch.Tensor           # [2, 2] observation noise

    @property
    def T(self) -> int:
        return self.poses0.shape[0]

    @property
    def L(self) -> int:
        return self.landmarks0.shape[0]

    @classmethod
    def from_numpy(cls, device=None, **arrays) -> "BAProblem":
        """The problem from arrays of its fields, on ``device`` (none
        named: the card): float32, ``lm_idx`` int32, ``mask`` bool."""
        device = default_device(device)
        dtypes = dict(lm_idx=np.int32, mask=np.bool_)
        return cls(**{
            f: torch.from_numpy(np.array(arrays[f],
                                         dtype=dtypes.get(f, np.float32),
                                         copy=True)).to(device)
            for f in cls.__dataclass_fields__})


def to_local(a, b):
    """Relative SE(2) transform of pose b in the frame of pose a ([..., 3]
    each)."""
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    return torch.stack([c * dx + s * dy, -s * dx + c * dy,
                        wrap_angle(b[..., 2] - a[..., 2])], dim=-1)


def _odom_residual_jacobians(poses, odom):
    """r_t = to_local(x_t, x_{t+1}) - m_t with its SE(2) Jacobians:
    (r [T-1, 3], Ja [T-1, 3, 3], Jb [T-1, 3, 3])."""
    a, b = poses[:-1], poses[1:]
    c, s = torch.cos(a[:, 2]), torch.sin(a[:, 2])
    dx = b[:, 0] - a[:, 0]
    dy = b[:, 1] - a[:, 1]
    lx = c * dx + s * dy
    ly = -s * dx + c * dy
    r = torch.stack([lx - odom[:, 0], ly - odom[:, 1],
                     wrap_angle(b[:, 2] - a[:, 2] - odom[:, 2])], dim=-1)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    Ja = torch.stack([torch.stack([-c, -s, ly], -1),
                      torch.stack([s, -c, -lx], -1),
                      torch.stack([zeros, zeros, -ones], -1)], -2)
    Jb = torch.stack([torch.stack([c, s, zeros], -1),
                      torch.stack([-s, c, zeros], -1),
                      torch.stack([zeros, zeros, ones], -1)], -2)
    return r, Ja, Jb


def _obs_terms(poses, landmarks, z, lm_idx, mask):
    """Per-observation Gauss-Newton blocks, masked to zero: Hv [T, K, 2,
    3], Hf [T, K, 2, 2], r [T, K, 2]. The Jacobians are the filters'
    (``jacobians_planes``, with its polynomial atan2)."""
    lm = landmarks[lm_idx.long()]                        # [T, K, 2]
    J = pk.jacobians_planes(poses[:, None, 0], poses[:, None, 1],
                            poses[:, None, 2], lm[..., 0], lm[..., 1],
                            0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    r0 = z[..., 0] - J.zr
    r1 = wrap_angle(z[..., 1] - J.zb)
    m = mask.to(poses.dtype)
    zeros = torch.zeros_like(J.a)
    Hv = torch.stack([torch.stack([J.hv00, J.hv01, zeros], -1),
                      torch.stack([J.hv10, J.hv11, -torch.ones_like(J.a)],
                                  -1)], -2)
    Hf = torch.stack([torch.stack([J.a, J.b], -1),
                      torch.stack([J.c, J.e], -1)], -2)
    r = torch.stack([r0, r1], -1) * m[..., None]
    return Hv * m[..., None, None], Hf * m[..., None, None], r


def _prior_residual(poses, anchor):
    """Gauge-prior residual: pose 0 against its anchor, heading
    wrapped."""
    return torch.cat([poses[0, :2] - anchor[:2],
                      wrap_angle(poses[0, 2:3] - anchor[2:3])])


# ---------------------------------------------------------------------------
# Landmark-indexed sums
# ---------------------------------------------------------------------------

class ObsPlan(NamedTuple):
    """Index tables of the landmark-indexed sums. Rows index the
    observations flattened in (t, k) order; index T K, one past the
    last, is a zero row (padding).

    ``lm_rows`` [L, C]: landmark l's observations. ``pair_t``,
    ``pair_l`` [U]: the distinct (keyframe, landmark) pairs observed;
    ``pair_rows`` [U, D]: each pair's observations (D is 1 unless a
    keyframe observes a landmark twice)."""
    lm_rows: torch.Tensor
    pair_t: torch.Tensor
    pair_l: torch.Tensor
    pair_rows: torch.Tensor


def _rows_by_key(keys: np.ndarray, rows: np.ndarray, pad: int):
    """(distinct keys [U], [U, D] table of the rows of each key in
    ascending row order, padded with ``pad``)."""
    order = np.argsort(keys, kind="stable")
    keys, rows = keys[order], rows[order]
    uniq, first, count = np.unique(keys, return_index=True,
                                   return_counts=True)
    table = np.full((len(uniq), max(int(count.max(initial=0)), 1)), pad,
                    np.int64)
    rank = np.arange(len(rows)) - np.repeat(first, count)
    table[np.repeat(np.arange(len(uniq)), count), rank] = rows
    return uniq, table


def obs_plan(lm_idx, mask, L: int) -> ObsPlan:
    """The index tables of the observations that ``mask`` keeps (one host
    read of ``lm_idx`` and ``mask``), on their device. The others add
    nothing: their terms are zero in the JAX package's sums too. Raises
    ValueError for an index outside [0, L)."""
    packed = torch.stack([lm_idx.to(torch.int32), mask.to(torch.int32)])
    with span("ba.host_read"):
        host = packed.cpu().numpy()
    idx, valid = host[0].reshape(-1), host[1].reshape(-1).astype(bool)
    if idx.size and (idx.min() < 0 or idx.max() >= L):
        raise ValueError(f"landmark indices must lie in [0, {L}), got "
                         f"[{idx.min()}, {idx.max()}]")
    K = lm_idx.shape[-1]
    rows = np.flatnonzero(valid)
    ids = idx[rows].astype(np.int64)
    lm_ids, by_lm = _rows_by_key(ids, rows, idx.size)
    lm_rows = np.full((L, by_lm.shape[1]), idx.size, np.int64)
    lm_rows[lm_ids] = by_lm
    pairs, pair_rows = _rows_by_key(rows // K * L + ids, rows, idx.size)

    def dev(a):
        return torch.from_numpy(a).to(lm_idx.device)
    return ObsPlan(lm_rows=dev(lm_rows), pair_t=dev(pairs // L),
                   pair_l=dev(pairs % L), pair_rows=dev(pair_rows))


def _segment_sum(terms, rows):
    """terms [N, ...] summed over each row of ``rows`` [M, C] (index N:
    zero): [M, ...], in a fixed order."""
    pad = terms.new_zeros((1,) + terms.shape[1:])
    return torch.cat([terms, pad])[rows].sum(1)


def _dense_cross(Wt, plan: ObsPlan, L: int):
    """The dense pose-landmark block W [3T, 2L] from the per-observation
    blocks Wt [T, K, 3, 2]: row 3t + a, column 2l + b."""
    T = Wt.shape[0]
    W = Wt.new_zeros((T, 3, L, 2))
    W[plan.pair_t, :, plan.pair_l, :] = _segment_sum(
        Wt.reshape(-1, 3, 2), plan.pair_rows)
    return W.reshape(3 * T, 2 * L)


# ---------------------------------------------------------------------------
# Normal equations and the trial step
# ---------------------------------------------------------------------------

def _inv(R):
    """The inverse of a small matrix, with no host read."""
    return torch.linalg.inv_ex(R)[0]


def _pose_system(App_diag, Aaa, Aab, Abb):
    """App [3T, 3T]: the observations' diagonal blocks, the odometry
    chain's tridiagonal blocks and the gauge prior's information, added
    in the JAX package's order."""
    T = App_diag.shape[0]
    App = App_diag.new_zeros((T, 3, T, 3))
    blocks = App.permute(0, 2, 1, 3)             # [T, T, 3, 3] view

    def band(offset):                            # blocks (t, t + offset)
        return blocks.diagonal(offset, 0, 1).permute(2, 0, 1)
    band(0).add_(App_diag)
    band(0)[:-1] += Aaa
    band(1).add_(Aab)
    band(-1).add_(Aab.mT)
    band(0)[1:] += Abb
    blocks[0, 0] += PRIOR_INFO * torch.eye(3, dtype=App.dtype,
                                           device=App.device)
    return App.reshape(3 * T, 3 * T)


def _odom_blocks(poses, odom, odom_info):
    """The odometry factors' blocks: (Aaa, Aab, Abb [T-1, 3, 3]) and
    their right-hand sides (ba, bb [T-1, 3])."""
    r_od, Ja, Jb = _odom_residual_jacobians(poses, odom)
    Info = odom_info.to(poses.dtype)
    JaI = torch.einsum("tab,bc->tac", Ja.mT, Info)       # Ja' Info
    JbI = torch.einsum("tab,bc->tac", Jb.mT, Info)
    return (torch.einsum("tab,tbc->tac", JaI, Ja),
            torch.einsum("tab,tbc->tac", JaI, Jb),
            torch.einsum("tab,tbc->tac", JbI, Jb),
            -torch.einsum("tab,tb->ta", JaI, r_od),
            -torch.einsum("tab,tb->ta", JbI, r_od))


def _pose_rhs(bp_obs, ba, bb, poses, anchor):
    """bp [3T]: the observations' part, the odometry's and the gauge
    prior's, added in the JAX package's order."""
    bp = bp_obs.clone()
    bp[:-1] += ba
    bp[1:] += bb
    bp[0] += -PRIOR_INFO * _prior_residual(poses, anchor)
    return bp.reshape(-1)


def _gn_normal_blocks(poses, landmarks, odom, odom_info, z, lm_idx, mask,
                      R, anchor, L: int, plan: ObsPlan | None = None):
    """All Gauss-Newton normal-equation pieces: (App [3T, 3T], W [3T,
    2L], All [L, 2, 2], bp [3T], bl [L, 2]). ``plan``: ``obs_plan`` of
    ``lm_idx`` and ``mask``, built here (one host read) when not
    given."""
    if plan is None:
        plan = obs_plan(lm_idx, mask, L)
    Rinv = _inv(R.to(poses.dtype))
    Hv, Hf, r = _obs_terms(poses, landmarks, z, lm_idx, mask)
    # The residual is z - h, so J_pose = -Hv and J_lm = -Hf: the signs
    # cancel in the normal matrices and flip in b.
    HvR = torch.einsum("tkab,ac->tkbc", Hv, Rinv)        # Hv' Rinv
    App_diag = torch.einsum("tkab,tkbc->tac", HvR, Hv)
    bp_obs = torch.einsum("tkab,tkb->ta", HvR, r)
    HfR = torch.einsum("tkab,ac->tkbc", Hf, Rinv)
    All_terms = torch.einsum("tkab,tkbc->tkac", HfR, Hf)
    bl_terms = torch.einsum("tkab,tkb->tka", HfR, r)
    All = _segment_sum(All_terms.reshape(-1, 2, 2), plan.lm_rows)
    bl = _segment_sum(bl_terms.reshape(-1, 2), plan.lm_rows)
    W = _dense_cross(torch.einsum("tkab,tkbc->tkac", HvR, Hf), plan, L)

    Aaa, Aab, Abb, ba, bb = _odom_blocks(poses, odom, odom_info)
    App = _pose_system(App_diag, Aaa, Aab, Abb)
    return App, W, All, _pose_rhs(bp_obs, ba, bb, poses, anchor), bl


def _ba_cost(poses, landmarks, odom, odom_info, z, lm_idx, mask, R,
             anchor):
    """Total weighted squared residual (observations, odometry, gauge
    prior): LM's acceptance test. Exact ``atan2`` here, and no floor
    under the range's square root, as in the JAX package."""
    Rinv = _inv(R.to(poses.dtype))
    lm = landmarks[lm_idx.long()]
    dx = lm[..., 0] - poses[:, None, 0]
    dy = lm[..., 1] - poses[:, None, 1]
    rng = torch.sqrt(dx * dx + dy * dy)
    brg = torch.atan2(dy, dx) - poses[:, None, 2]
    r = torch.stack([z[..., 0] - rng, wrap_angle(z[..., 1] - brg)], -1)
    r = r * mask.to(poses.dtype)[..., None]
    c_obs = torch.einsum("tka,ab,tkb->", r, Rinv, r)
    return c_obs + _pose_cost(poses, odom, odom_info, anchor)


def _pose_cost(poses, odom, odom_info, anchor):
    """The landmark-free part of the cost: odometry and gauge prior."""
    r_od, _, _ = _odom_residual_jacobians(poses, odom)
    c_od = torch.einsum("ta,ab,tb->", r_od, odom_info.to(poses.dtype),
                        r_od)
    rp = _prior_residual(poses, anchor)
    return c_od + PRIOR_INFO * torch.dot(rp, rp)


def _inv_2x2_blocks(All):
    """[L, 2, 2] inverses by the adjugate, the determinant floored at
    1e-20: a landmark with no observation has only the damping."""
    det = torch.clamp(All[:, 0, 0] * All[:, 1, 1]
                      - All[:, 0, 1] * All[:, 1, 0], min=1e-20)
    adj = torch.stack([torch.stack([All[:, 1, 1], -All[:, 0, 1]], -1),
                       torch.stack([-All[:, 1, 0], All[:, 0, 0]], -1)], -2)
    return adj / det[:, None, None]


def _times_blocks(W, Allinv):
    """W All^-1 for W [3T, 2L] and the block-diagonal All^-1 (``plc,
    lcd->pld``)."""
    W3 = W.reshape(W.shape[0], -1, 2)
    w0, w1 = W3[..., 0], W3[..., 1]
    return torch.stack([w0 * Allinv[:, 0, 0] + w1 * Allinv[:, 1, 0],
                        w0 * Allinv[:, 0, 1] + w1 * Allinv[:, 1, 1]],
                       -1).reshape(W.shape)


def _solve_pos(S, rhs):
    """S^-1 rhs for a positive definite S, by the Cholesky factor of its
    upper triangle (the one ``jax.scipy.linalg.solve(assume_a="pos")``
    reads); NaN where the factorization fails, with no host read."""
    return torch.cholesky_solve(rhs[:, None], cholesky_lower(S.mT))[:, 0]


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _damped(All, lam):
    return All + lam * _eye(2, All)


def _step_poses(poses, dp):
    """poses + dp, the headings wrapped."""
    new = poses + dp.reshape(poses.shape)
    return torch.cat([new[:, :2], wrap_angle(new[:, 2:])], dim=1)


def _gn_step(poses, landmarks, odom, odom_info, z, lm_idx, mask, R,
             anchor, damping, plan: ObsPlan | None = None):
    """One damped Gauss-Newton trial step with Schur elimination:
    (poses, landmarks). ``damping``: a float32 scalar tensor."""
    T, L = poses.shape[0], landmarks.shape[0]
    App, W, All, bp, bl = _gn_normal_blocks(
        poses, landmarks, odom, odom_info, z, lm_idx, mask, R, anchor, L,
        plan)
    lam = torch.as_tensor(damping, dtype=poses.dtype, device=poses.device)
    # Unobserved landmarks have singular blocks: the damping regularizes
    # them, and bl there is zero, so dl stays zero.
    Allinv = _inv_2x2_blocks(_damped(All, lam))
    WA = _times_blocks(W, Allinv)
    S = App + lam * _eye(3 * T, App) - WA @ W.T
    dp = _solve_pos(S, bp - WA @ bl.reshape(-1))
    dl_rhs = bl.reshape(-1) - W.T @ dp
    dl = torch.einsum("lcd,ld->lc", Allinv, dl_rhs.reshape(L, 2))
    return _step_poses(poses, dp), landmarks + dl


# ---------------------------------------------------------------------------
# Levenberg-Marquardt
# ---------------------------------------------------------------------------

def _raised(lam):
    """The damping after a rejected trial: x10, at most 1e8."""
    return torch.clamp(lam * 10.0, max=1e8)


def _lowered(lam):
    """The damping after an accepted step: /3, at least 1e-9."""
    return torch.clamp(lam / 3.0, min=1e-9)


def _start(prob: BAProblem, damping: float):
    """(poses, landmarks, the static arguments, the observations' plan,
    the damping as a float32 tensor) of a solve."""
    poses = prob.poses0.to(torch.float32)
    landmarks = prob.landmarks0.to(torch.float32)
    static = (prob.odom, prob.odom_info, prob.z, prob.lm_idx, prob.mask,
              prob.R, poses[0])
    lam = torch.full((), damping, dtype=torch.float32, device=poses.device)
    return poses, landmarks, static, obs_plan(prob.lm_idx, prob.mask,
                                              prob.L), lam


def solve_ba(prob: BAProblem, iters: int = 10, damping: float = 1e-3,
             tol: float = 1e-8, max_retries: int = 6,
             return_info: bool = False):
    """Levenberg-Marquardt: up to ``iters`` accepted steps, each trial
    kept only if the total cost does not rise (else the damping is raised
    x10 and the step recomputed from the same point, up to
    ``max_retries`` times). Runs on the problem's device. Returns (poses
    [T, 3], landmarks [L, 2]); with ``return_info`` also a dict: the cost
    after each accepted step, ``n_steps`` (trials, i.e. linear solves),
    the final damping and ``host_reads`` (device-to-host reads: the
    plan's, the first cost's, one per trial and the final damping's).

    The host reads each trial's cost, as the JAX package's ``solve_ba``
    does. The damping is a float32 on the device, changed by the same
    operations as in ``solve_ba_device`` (JAX keeps a Python float here,
    which may differ from its device loop's in the last bits)."""
    with span("ba.solve"), full_f32():
        poses, landmarks, static, plan, lam = _start(prob, damping)
        cost = _ba_cost(poses, landmarks, *static)
        with span("ba.host_read"):
            cost = float(cost)
        costs, n_steps, reads = [cost], 0, 2
        for _ in range(iters):
            accepted = False
            for _retry in range(max_retries + 1):
                with span("ba.trial"):
                    trial_p, trial_l = _gn_step(poses, landmarks, *static,
                                                lam, plan)
                    n_steps += 1
                    trial_cost = _ba_cost(trial_p, trial_l, *static)
                    with span("ba.host_read"):
                        trial_cost = float(trial_cost)
                    reads += 1
                if math.isfinite(trial_cost) and trial_cost <= cost:
                    accepted = True
                    break
                lam = _raised(lam)
            if not accepted:
                break
            poses, landmarks = trial_p, trial_l
            gain = cost - trial_cost
            cost = trial_cost
            costs.append(cost)
            lam = _lowered(lam)
            if gain <= tol * max(cost, 1.0):
                break
        if return_info:
            with span("ba.host_read"):
                final_damping = float(lam)
    if return_info:
        return poses, landmarks, {"costs": costs, "n_steps": n_steps,
                                  "final_damping": final_damping,
                                  "host_reads": reads + 1}
    return poses, landmarks


def solve_ba_device(prob: BAProblem, iters: int = 10,
                    damping: float = 1e-3, tol: float = 1e-8,
                    max_retries: int = 6, return_info: bool = False):
    """``solve_ba`` with the acceptance, the kept state and the damping
    decided on the device (``torch.where``), as the JAX package's
    ``lax.while_loop`` nest decides them. PyTorch has no device-side
    while loop, so the host runs the two loops: after each trial it
    reads one packed float32 tensor (accepted, converged, cost, damping)
    to decide whether to go on. A trial therefore costs one host read
    here, where the JAX package's whole solve is one dispatch.

    The same trial/accept sequence as ``solve_ba`` on the same device,
    and the same bits (the convergence test here is in float32, as on
    JAX's device; ``solve_ba``'s in float64, as JAX's host loop: the two
    can part only when the gain lies within a rounding of the
    threshold). ``return_info`` adds a dict: final cost, ``n_steps``
    (trials), ``n_accepted``, the final damping, ``host_reads`` (the
    plan's and one per trial)."""
    with span("ba.solve"), full_f32():
        poses, landmarks, static, plan, lam = _start(prob, damping)
        cost = _ba_cost(poses, landmarks, *static)
        n_acc, n_steps, reads, done, last = 0, 0, 1, False, None
        while not done and n_acc < iters:
            for _ in range(max_retries + 1):
                with span("ba.trial"):
                    tp, tl = _gn_step(poses, landmarks, *static, lam, plan)
                    tc = _ba_cost(tp, tl, *static)
                    acc = torch.isfinite(tc) & (tc <= cost)
                    converged = acc & (cost - tc
                                       <= tol * torch.clamp(tc, min=1.0))
                    poses = torch.where(acc, tp, poses)
                    landmarks = torch.where(acc, tl, landmarks)
                    cost = torch.where(acc, tc, cost)
                    lam = torch.where(acc, _lowered(lam), _raised(lam))
                    last = torch.stack([acc.to(cost.dtype),
                                        converged.to(cost.dtype), cost, lam])
                    with span("ba.host_read"):
                        last = last.cpu().numpy()
                    n_steps += 1
                    reads += 1
                if last[0]:
                    break
            n_acc += bool(last[0])
            done = not last[0] or bool(last[1])
        if last is None:
            last = torch.stack([cost, cost, cost, lam])
            with span("ba.host_read"):
                last = last.cpu().numpy()
            reads += 1
    if return_info:
        return poses, landmarks, {
            "cost": float(last[2]), "n_steps": n_steps,
            "n_accepted": n_acc, "final_damping": float(last[3]),
            "host_reads": reads}
    return poses, landmarks


# ---------------------------------------------------------------------------
# From a filter run
# ---------------------------------------------------------------------------

def problem_from_run(result, config, slam_map=None, device=None
                     ) -> BAProblem:
    """A BA problem from a finished filter run (``RunResult``), on
    ``device`` (none named: the card): keyframes are the observe
    supersteps, odometry the dead-reckoned relative transforms of the
    noisy controls, landmarks initialized by back-projecting each
    observation from its keyframe pose and averaging per id. The
    landmark axis is the world's ids, up to the largest observed."""
    del slam_map
    act = result.active
    poses0 = np.asarray(result.est_pose[act], np.float32)
    z = np.asarray(result.obs_z[act])
    mask = np.asarray(result.obs_mask[act])
    ids = np.asarray(result.obs_ids[act])

    L = int(ids[mask].max()) + 1 if mask.any() else 1
    ang = poses0[:, 2][:, None] + z[..., 1]
    wx = poses0[:, 0][:, None] + z[..., 0] * np.cos(ang)
    wy = poses0[:, 1][:, None] + z[..., 0] * np.sin(ang)
    sums = np.zeros((L, 2))
    counts = np.zeros(L)
    np.add.at(sums, ids[mask], np.stack([wx[mask], wy[mask]], -1))
    np.add.at(counts, ids[mask], 1.0)
    landmarks0 = sums / np.maximum(counts, 1.0)[:, None]

    # odom[t + 1] measures the motion from keyframe t to t + 1.
    odom = np.asarray(result.odom[act])[1:]
    # Information: the control noise of one observe period of n ticks
    # (a random-walk diagonal): longitudinal from sigmaV, lateral and
    # heading from sigmaG.
    n_ticks_per = round(config.DT_OBSERVE / config.DT_CONTROLS)
    dt = config.DT_CONTROLS
    var_x = n_ticks_per * (config.sigmaV * dt) ** 2
    var_y = n_ticks_per * (config.V * config.sigmaG * dt) ** 2
    var_t = n_ticks_per * (config.V * dt * config.sigmaG /
                           max(config.WHEELBASE, 1e-6)) ** 2
    info = np.diag([1.0 / max(var_x, 1e-10), 1.0 / max(var_y, 1e-10),
                    1.0 / max(var_t, 1e-10)])
    return BAProblem.from_numpy(
        device, poses0=poses0, landmarks0=landmarks0, odom=odom,
        odom_info=info, z=z, lm_idx=np.where(mask, ids, 0), mask=mask,
        R=np.diag(config.Re).astype(np.float32))
