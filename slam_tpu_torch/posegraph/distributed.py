"""Schur-complement bundle adjustment over a landmark-sharded layout
(counterpart: slam_tpu.posegraph.distributed).

The landmark axis splits over a 1-D mesh on ``LM_AXIS`` (one rank per
device; ``mesh_over(ranks, (S,), ("l",))``). Each rank assembles the
normal-equation pieces of its landmark block (every observation belongs
to one landmark, hence to one shard) and its part of S's contraction;
all-reduces over the mesh's group join them: App's observation diagonal
and bp's observation part, the [3T, 3T] partial W All^-1 W' and
W All^-1 bl, and the sharded cost. The reduced pose solve runs on every
rank on the same sums, the landmark back-substitution stays local, and
the landmarks are gathered once, at the end. With no mesh the one card
is the only shard and the sums are its own values; a mesh of one rank
runs the same operations through collectives over a group of one.

Kept from the JAX solver, where it differs from ``ba.solve_ba``: the
first cost is ``_ba_cost``'s and every later one ``_sharded_cost``'s,
whose range is sqrt(max(., 1e-24)); observations outside a shard's
block are dropped from its sums; the host reads once per LM iteration
in JAX (its retry loop runs on the device) and ``n_iters`` counts the
iteration that failed. Here the retry loop runs on the host, with one
read per trial of the all-reduced cost, the same on every rank, so
every rank takes the same decisions; ``solve_ba_sharded`` reports the
reads of a solve.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from slam_tpu_torch.geometry import wrap_angle
from slam_tpu_torch.models.ekf import full_f32
from slam_tpu_torch.parallel.mesh import all_gather_rows, psum
from slam_tpu_torch.posegraph.ba import (
    BAProblem,
    ObsPlan,
    _ba_cost,
    _damped,
    _dense_cross,
    _eye,
    _inv,
    _inv_2x2_blocks,
    _lowered,
    _obs_terms,
    _odom_blocks,
    _pose_cost,
    _pose_rhs,
    _pose_system,
    _raised,
    _segment_sum,
    _solve_pos,
    _step_poses,
    _times_blocks,
    obs_plan,
)
from slam_tpu_torch.spans import span

LM_AXIS = "l"


def _shards(mesh: DeviceMesh | None):
    """(shard count, this rank's shard, the group) of a 1-D landmark
    mesh; (1, 0, None) without one."""
    if mesh is None:
        return 1, 0, None
    group = mesh.get_group(0)
    return dist.get_world_size(group), mesh.get_local_rank(0), group


def _owned(lm_idx, mask, L_local: int, shard: int):
    """(observations of the shard's landmarks, their shard-local
    indices, clipped into the block)."""
    lo = shard * L_local
    own = mask & (lm_idx >= lo) & (lm_idx < lo + L_local)
    return own, torch.clamp(lm_idx - lo, 0, L_local - 1)


def _shard_plan(lm_idx, mask, L_local: int, shard: int = 0) -> ObsPlan:
    """``obs_plan`` of a shard's own observations (one host read)."""
    own, local_idx = _owned(lm_idx, mask, L_local, shard)
    return obs_plan(local_idx, own, L_local)


def _assemble_local(poses, lm_local, z, lm_idx, mask, Rinv, lam,
                    L_local: int, shard: int, plan: ObsPlan, group):
    """A shard's observation-side assembly and Schur partials: (App's
    observation diagonal [T, 3, 3], bp's [T, 3], the summed W All^-1 W'
    [3T, 3T] and W All^-1 bl [3T], and the shard's W, All^-1, bl)."""
    own, local_idx = _owned(lm_idx, mask, L_local, shard)
    Hv, Hf, r = _obs_terms(poses, lm_local, z, local_idx, own)
    HvR = torch.einsum("tkab,ac->tkbc", Hv, Rinv)
    App_diag = psum(torch.einsum("tkab,tkbc->tac", HvR, Hv), group)
    bp_obs = psum(torch.einsum("tkab,tkb->ta", HvR, r), group)

    HfR = torch.einsum("tkab,ac->tkbc", Hf, Rinv)
    All_terms = torch.einsum("tkab,tkbc->tkac", HfR, Hf)
    bl_terms = torch.einsum("tkab,tkb->tka", HfR, r)
    All = _segment_sum(All_terms.reshape(-1, 2, 2), plan.lm_rows)
    bl = _segment_sum(bl_terms.reshape(-1, 2), plan.lm_rows)
    W = _dense_cross(torch.einsum("tkab,tkbc->tkac", HvR, Hf), plan,
                     L_local)

    Allinv = _inv_2x2_blocks(_damped(All, lam))
    WA = _times_blocks(W, Allinv)
    SW = psum(WA @ W.T, group)
    rhs_lm = psum(WA @ bl.reshape(-1), group)
    return App_diag, bp_obs, SW, rhs_lm, W, Allinv, bl


def _sharded_cost(poses, lm_local, odom, odom_info, z, lm_idx, mask, R,
                  anchor, shard: int, group):
    """The total cost with the observation term scored per landmark
    shard (each shard the observations of its block ``lm_local``,
    summed over the shards); the odometry and gauge terms once, on
    every rank."""
    dtype = poses.dtype
    Rinv = _inv(R.to(dtype))
    L_local = lm_local.shape[0]

    def obs_cost():
        own, local_idx = _owned(lm_idx, mask, L_local, shard)
        lm = lm_local[local_idx.long()]
        dx = lm[..., 0] - poses[:, None, 0]
        dy = lm[..., 1] - poses[:, None, 1]
        rng = torch.sqrt(torch.clamp(dx * dx + dy * dy, min=1e-24))
        brg = torch.atan2(dy, dx) - poses[:, None, 2]
        r = torch.stack([z[..., 0] - rng, wrap_angle(z[..., 1] - brg)],
                        -1) * own.to(dtype)[..., None]
        return torch.einsum("tka,ab,tkb->", r, Rinv, r)

    c_obs = psum(obs_cost(), group)
    return c_obs + _pose_cost(poses, odom, odom_info, anchor)


def make_sharded_gn_step(mesh: DeviceMesh | None, T: int, L: int):
    """One sharded Gauss-Newton trial step for T poses and L landmarks
    over the landmark mesh ``mesh`` (None: one shard; the JAX package's
    ``_make_trial_fn``, which its ``make_sharded_gn_step`` jits):
    ``step(poses, lm_local, odom, odom_info, z, lm_idx, mask, R, anchor,
    damping, plan)`` -> (poses, lm_local) on this rank's block of
    L / S landmarks, ``plan`` the shard's ``_shard_plan``."""
    n_shards, shard, group = _shards(mesh)
    if L % n_shards:
        raise ValueError(f"L={L} must divide over {n_shards} shards")
    L_local = L // n_shards

    def step(poses, landmarks, odom, odom_info, z, lm_idx, mask, R,
             anchor, damping, plan: ObsPlan):
        dtype = poses.dtype
        Rinv = _inv(R.to(dtype))
        lam = torch.as_tensor(damping, dtype=dtype, device=poses.device)
        App_diag, bp_obs, SW, rhs_lm, W, Allinv, bl = _assemble_local(
            poses, landmarks, z, lm_idx, mask, Rinv, lam, L_local, shard,
            plan, group)

        # The landmark-free terms: odometry chain and gauge.
        Aaa, Aab, Abb, ba, bb = _odom_blocks(poses, odom, odom_info)
        App = _pose_system(App_diag, Aaa, Aab, Abb)
        bp = _pose_rhs(bp_obs, ba, bb, poses, anchor)
        S = App + lam * _eye(3 * T, App) - SW
        dp = _solve_pos(S, bp - rhs_lm)

        # The landmark back-substitution, local to the shard.
        dl_rhs = bl.reshape(-1) - W.T @ dp
        dl = torch.einsum("lcd,ld->lc", Allinv,
                          dl_rhs.reshape(L_local, 2))
        return _step_poses(poses, dp), landmarks + dl

    return step


def make_lm_iteration(mesh: DeviceMesh | None, T: int, L: int,
                      max_retries: int = 6):
    """One Levenberg-Marquardt iteration over the landmark mesh
    ``mesh``: ``lm_iter(poses, lm_local, cost, lam, odom, odom_info, z,
    lm_idx, mask, R, anchor, plan)`` -> (poses, lm_local, cost, damping,
    accepted, the cost on the host, trials). Trial steps from the same
    point with the damping raised x10 after each rejection, until one
    does not raise the sharded cost or ``max_retries`` retries are
    spent; one host read per trial, of the all-reduced cost."""
    trial = make_sharded_gn_step(mesh, T, L)
    _, shard, group = _shards(mesh)

    def lm_iter(poses, landmarks, cost, lam, odom, odom_info, z, lm_idx,
                mask, R, anchor, plan: ObsPlan):
        static = (odom, odom_info, z, lm_idx, mask, R, anchor)
        for tries in range(1, max_retries + 2):
            with span("ba.trial"):
                tp, tl = trial(poses, landmarks, *static, lam, plan)
                tc = _sharded_cost(tp, tl, *static, shard, group)
                acc = torch.isfinite(tc) & (tc <= cost)
                packed = torch.stack([acc.to(tc.dtype), tc])
                with span("ba.host_read"):
                    acc_h, tc_h = packed.tolist()
            if acc_h:
                return tp, tl, tc, _lowered(lam), True, tc_h, tries
            lam = _raised(lam)
        return poses, landmarks, cost, lam, False, tc_h, tries

    return lm_iter


def solve_ba_sharded(prob: BAProblem, mesh: DeviceMesh | None = None,
                     iters: int = 10, damping: float = 1e-3,
                     tol: float = 1e-8, max_retries: int = 6,
                     return_info: bool = False):
    """Schur-complement BA over the landmark-sharded layout, on the
    problem's device: over the 1-D landmark mesh ``mesh``, whose every
    rank calls this with the same problem, or on one shard (None). The
    landmarks pad to a multiple of the shard count, and rank r owns
    block r. The Levenberg-Marquardt schedule of ``solve_ba`` (a trial
    kept iff the total cost does not rise, damping x10 on a rejection,
    /3 on an acceptance), iterated by ``make_lm_iteration``. Returns
    (poses [T, 3], landmarks [L, 2], gathered), the same on every rank;
    with ``return_info`` also a dict: the cost after each accepted
    iteration, ``n_iters`` (the failed one included), ``n_steps``
    (trials) and ``host_reads`` (the plan's, the first cost's and one
    per trial)."""
    n_shards, shard, group = _shards(mesh)
    L_pad = -(-prob.L // n_shards) * n_shards
    L_local = L_pad // n_shards
    lm_iter = make_lm_iteration(mesh, prob.T, L_pad,
                                max_retries=max_retries)
    with span("ba.solve"), full_f32():
        poses = prob.poses0.to(torch.float32)
        landmarks = prob.landmarks0.to(torch.float32)
        # Padded rows have no observations: their blocks are the damping
        # alone, invertible and inert, and they stay at zero.
        if L_pad != prob.L:
            landmarks = torch.cat([landmarks, landmarks.new_zeros(
                (L_pad - prob.L, 2))])
        static = (prob.odom, prob.odom_info, prob.z, prob.lm_idx,
                  prob.mask, prob.R, poses[0])
        plan = _shard_plan(prob.lm_idx, prob.mask, L_local, shard)
        lam = torch.full((), damping, dtype=torch.float32,
                         device=poses.device)
        # The first cost from the whole initial map, on every rank.
        cost = _ba_cost(poses, landmarks, *static)
        with span("ba.host_read"):
            cost_h = float(cost)
        lm_local = landmarks[shard * L_local:(shard + 1) * L_local]
        costs, n_iters, n_steps, reads = [cost_h], 0, 0, 2
        for _ in range(iters):
            poses, lm_local, cost, lam, acc, new_cost_h, tries = lm_iter(
                poses, lm_local, cost, lam, *static, plan)
            n_iters += 1
            n_steps += tries
            reads += tries
            if not acc:
                break
            gain = cost_h - new_cost_h
            cost_h = new_cost_h
            costs.append(cost_h)
            if gain <= tol * max(cost_h, 1.0):
                break
        landmarks = all_gather_rows(lm_local, group)[:prob.L]
    if return_info:
        return poses, landmarks, {"costs": costs, "n_iters": n_iters,
                                  "n_steps": n_steps, "host_reads": reads}
    return poses, landmarks
