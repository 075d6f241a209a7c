"""Plain reference of the bundle-adjustment stage: the least-squares
problem, its Gauss-Newton step by the Schur complement, and the
Levenberg-Marquardt schedule.

The problem (BASELINE config #5's pose-graph refinement): keyframe poses
(x, y, theta) and 2-D landmarks; factors

- range-bearing observations z = (|l - p|, atan2(l - p) - theta) + noise,
  weighted by R^-1;
- odometry between consecutive keyframes, the pose of keyframe t + 1 in
  the frame of keyframe t, weighted by ``odom_info``;
- a prior of weight ``PRIOR_INFO`` holding keyframe 0 at its start.

``problem_from_run`` builds the problem of a filter run as config #5
does: keyframes are the observe supersteps at the filter's estimate,
odometry the dead-reckoned motion of each superstep, landmarks the mean
of their back-projected observations, and the odometry's weight the
control noise of one superstep. Torch only, in any dtype and on any
device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PRIOR_INFO = 1.0e6
FIELDS = ("poses0", "landmarks0", "odom", "odom_info", "z", "lm_idx",
          "mask", "R")


def wrap(a):
    """Angle(s) to [-pi, pi)."""
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def problem_from_run(est_pose, active, obs_z, obs_mask, obs_ids, odom,
                     cfg: dict) -> dict:
    """The BA problem of a filter run (numpy float64 arrays)."""
    act = np.asarray(active, bool)
    poses0 = np.asarray(est_pose, np.float64)[act]
    z = np.asarray(obs_z, np.float64)[act]
    mask = np.asarray(obs_mask, bool)[act]
    ids = np.asarray(obs_ids, np.int64)[act]
    L = int(ids[mask].max()) + 1 if mask.any() else 1
    ang = poses0[:, 2][:, None] + z[..., 1]
    wx = poses0[:, 0][:, None] + z[..., 0] * np.cos(ang)
    wy = poses0[:, 1][:, None] + z[..., 0] * np.sin(ang)
    sums, counts = np.zeros((L, 2)), np.zeros(L)
    np.add.at(sums, ids[mask], np.stack([wx[mask], wy[mask]], -1))
    np.add.at(counts, ids[mask], 1.0)
    n = round(cfg["DT_OBSERVE"] / cfg["DT_CONTROLS"])
    dt = cfg["DT_CONTROLS"]
    var = (n * (cfg["sigmaV"] * dt) ** 2,
           n * (cfg["V"] * cfg["sigmaG"] * dt) ** 2,
           n * (cfg["V"] * dt * cfg["sigmaG"] / cfg["WHEELBASE"]) ** 2)
    return dict(poses0=poses0,
                landmarks0=sums / np.maximum(counts, 1.0)[:, None],
                odom=np.asarray(odom, np.float64)[act][1:],
                odom_info=np.diag([1.0 / v for v in var]), z=z,
                lm_idx=np.where(mask, ids, 0), mask=mask,
                R=np.diag([cfg["sigmaR"] ** 2, cfg["sigmaB"] ** 2]))


def to_torch(prob: dict, device, dtype=torch.float64) -> dict:
    out = {}
    for k in FIELDS:
        t = torch.as_tensor(np.asarray(prob[k]), device=device)
        out[k] = t if k in ("lm_idx", "mask") else t.to(dtype)
    out["lm_idx"] = out["lm_idx"].long()
    return out


def _obs(prob, poses, lms):
    """Per observation: residual r [T, K, 2], d(h)/d(pose) [T, K, 2, 3],
    d(h)/d(landmark) [T, K, 2, 2], masked to zero."""
    lm = lms[prob["lm_idx"]]
    dx = lm[..., 0] - poses[:, None, 0]
    dy = lm[..., 1] - poses[:, None, 1]
    d2 = dx * dx + dy * dy
    d = torch.sqrt(d2)
    m = prob["mask"].to(poses.dtype)
    r = torch.stack([prob["z"][..., 0] - d,
                     wrap(prob["z"][..., 1] - torch.atan2(dy, dx)
                          + poses[:, None, 2])], -1) * m[..., None]
    zero = torch.zeros_like(d)
    Hl = torch.stack([torch.stack([dx / d, dy / d], -1),
                      torch.stack([-dy / d2, dx / d2], -1)], -2)
    Hp = torch.stack([torch.stack([-dx / d, -dy / d, zero], -1),
                      torch.stack([dy / d2, -dx / d2, -torch.ones_like(d)],
                                  -1)], -2)
    return r, Hp * m[..., None, None], Hl * m[..., None, None]


def _odom(prob, poses):
    """Odometry residuals [T-1, 3] and their Jacobians in the two poses."""
    a, b, m = poses[:-1], poses[1:], prob["odom"]
    c, s = torch.cos(a[:, 2]), torch.sin(a[:, 2])
    dx, dy = b[:, 0] - a[:, 0], b[:, 1] - a[:, 1]
    lx, ly = c * dx + s * dy, -s * dx + c * dy
    r = torch.stack([lx - m[:, 0], ly - m[:, 1],
                     wrap(b[:, 2] - a[:, 2] - m[:, 2])], -1)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    Ja = torch.stack([torch.stack([-c, -s, ly], -1),
                      torch.stack([s, -c, -lx], -1),
                      torch.stack([z, z, -o], -1)], -2)
    Jb = torch.stack([torch.stack([c, s, z], -1),
                      torch.stack([-s, c, z], -1),
                      torch.stack([z, z, o], -1)], -2)
    return r, Ja, Jb


def _prior(prob, poses):
    p = poses[0] - prob["poses0"][0]
    return torch.cat([p[:2], wrap(p[2:])])


def cost(prob, poses, lms) -> torch.Tensor:
    """The total weighted squared residual."""
    r, _, _ = _obs(prob, poses, lms)
    Rinv = torch.linalg.inv(prob["R"])
    ro, _, _ = _odom(prob, poses)
    rp = _prior(prob, poses)
    return (torch.einsum("tka,ab,tkb->", r, Rinv, r)
            + torch.einsum("ta,ab,tb->", ro, prob["odom_info"], ro)
            + PRIOR_INFO * torch.dot(rp, rp))


def gn_step(prob, poses, lms, lam: float = 0.0):
    """The (damped) Gauss-Newton step from (poses, lms): (dp [T, 3],
    dl [L, 2]), the landmark system eliminated by the Schur complement.
    A landmark with no observation keeps dl = 0."""
    T, L = poses.shape[0], lms.shape[0]
    dt, dev = poses.dtype, poses.device
    r, Hp, Hl = _obs(prob, poses, lms)
    Rinv = torch.linalg.inv(prob["R"])
    # r(x + dx) ~ r - H dx, so (H' W H) dx = H' W r.
    HpR = torch.einsum("tkab,ac->tkbc", Hp, Rinv)
    HlR = torch.einsum("tkab,ac->tkbc", Hl, Rinv)
    App = torch.zeros((T, 3, T, 3), dtype=dt, device=dev)
    tt = torch.arange(T, device=dev)
    App[tt, :, tt, :] += torch.einsum("tkij,tkjl->til", HpR, Hp)
    bp = torch.einsum("tkij,tkj->ti", HpR, r)
    idx = prob["lm_idx"].reshape(-1)
    All = torch.zeros((L, 2, 2), dtype=dt, device=dev).index_add_(
        0, idx, torch.einsum("tkij,tkjl->tkil", HlR, Hl).reshape(-1, 2, 2))
    bl = torch.zeros((L, 2), dtype=dt, device=dev).index_add_(
        0, idx, torch.einsum("tkij,tkj->tki", HlR, r).reshape(-1, 2))
    tk = tt[:, None].expand_as(prob["lm_idx"]).reshape(-1)
    W = torch.zeros((T, L, 3, 2), dtype=dt, device=dev).index_put_(
        (tk, idx), torch.einsum("tkij,tkjl->tkil", HpR, Hl).reshape(
            -1, 3, 2), accumulate=True).permute(0, 2, 1, 3)
    # The odometry chain: r_od(x + dx) ~ r_od + Ja da + Jb db.
    ro, Ja, Jb = _odom(prob, poses)
    Io = prob["odom_info"]
    t0, t1 = tt[:-1], tt[1:]
    for (ia, Jx), (ib, Jy) in ((((t0, Ja), (t0, Ja))), ((t0, Ja), (t1, Jb)),
                               ((t1, Jb), (t0, Ja)), ((t1, Jb), (t1, Jb))):
        App[ia, :, ib, :] += torch.einsum("tba,bc,tcd->tad", Jx, Io, Jy)
    bp[:-1] -= torch.einsum("tba,bc,tc->ta", Ja, Io, ro)
    bp[1:] -= torch.einsum("tba,bc,tc->ta", Jb, Io, ro)
    App[0, :, 0, :] += PRIOR_INFO * torch.eye(3, dtype=dt, device=dev)
    bp[0] -= PRIOR_INFO * _prior(prob, poses)
    seen = torch.zeros(L, dtype=torch.bool, device=dev)
    seen[idx[prob["mask"].reshape(-1)]] = True
    All = All + lam * torch.eye(2, dtype=dt, device=dev)
    All[~seen] = torch.eye(2, dtype=dt, device=dev)
    Ainv = torch.linalg.inv(All)
    W = W.reshape(3 * T, L, 2) * seen[None, :, None].to(dt)
    WA = torch.einsum("plc,lcd->pld", W, Ainv).reshape(3 * T, 2 * L)
    W = W.reshape(3 * T, 2 * L)
    blv = (bl * seen[:, None].to(dt)).reshape(-1)
    S = App.reshape(3 * T, 3 * T) + lam * torch.eye(3 * T, dtype=dt,
                                                    device=dev) - WA @ W.T
    dp = torch.linalg.solve(S, bp.reshape(-1) - WA @ blv)
    dl = torch.einsum("lcd,ld->lc", Ainv,
                      (blv - W.T @ dp).reshape(L, 2)) * seen[:, None]
    return dp.reshape(T, 3), dl


def lm_solve(prob, iters: int, damping: float = 1e-3, tol: float = 1e-8,
             max_retries: int = 6):
    """Levenberg-Marquardt from the problem's start: a trial is kept iff
    the cost does not rise; the damping x10 (at most 1e8) on a
    rejection, /3 (at least 1e-9) on an acceptance; stop after ``iters``
    accepted steps, a failed iteration, or a gain under ``tol`` x cost.
    Returns (poses, landmarks, the cost at the start and after each
    accepted step)."""
    poses, lms = prob["poses0"].clone(), prob["landmarks0"].clone()
    costs = [float(cost(prob, poses, lms))]
    lam = damping
    for _ in range(iters):
        for _ in range(max_retries + 1):
            dp, dl = gn_step(prob, poses, lms, lam)
            tp = torch.cat([poses[:, :2] + dp[:, :2],
                            wrap(poses[:, 2:] + dp[:, 2:])], 1)
            tl = lms + dl
            tc = float(cost(prob, tp, tl))
            if math.isfinite(tc) and tc <= costs[-1]:
                break
            lam = min(lam * 10.0, 1e8)
        else:
            return poses, lms, costs
        poses, lms, gain = tp, tl, costs[-1] - tc
        costs.append(tc)
        lam = max(lam / 3.0, 1e-9)
        if gain <= tol * max(tc, 1.0):
            break
    return poses, lms, costs


def judge(prob, poses, lms) -> dict:
    """The answer (poses, lms) in the problem's dtype: ``cost`` there,
    and ``move_m``, the largest keyframe position move of one undamped
    Gauss-Newton step from it (how far it lies from a stationary
    point)."""
    dp, _ = gn_step(prob, poses, lms)
    return dict(move_m=float(dp[:, :2].norm(dim=1).max()),
                cost=float(cost(prob, poses, lms)))
