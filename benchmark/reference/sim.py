"""Plain reference of the simulator: the truth trajectory and what the
range-bearing sensor sees from it.

The truth is the reference simulator's bicycle model chasing the
waypoints (steering rate and angle clamped, ``AT_WAYPOINT`` to switch,
``NUMBER_LOOPS`` passes), with no noise: it does not depend on the
seed. The sensor sees a landmark within ``MAX_RANGE`` in the forward
half-plane, reports the first ``max_obs`` in landmark order, and adds
N(0, sigmaR^2) to the range and N(0, sigmaB^2) to the bearing.

Each function takes a ``dtype``: the reference runs in float64; the
control runs the same code in bfloat16. Plain torch on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def wrap(a):
    """Angle(s) to [-pi, pi)."""
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def truth_trajectory(cfg: dict, waypoints: np.ndarray, n_ticks: int,
                     dtype=torch.float64) -> np.ndarray:
    """[n_ticks, 4]: the truth pose (x, y, theta) after each control tick
    and whether the run was done by then (1.0)."""
    t = lambda v: torch.tensor(v, dtype=dtype)          # noqa: E731
    wps = torch.as_tensor(waypoints, dtype=dtype)
    n_wp = wps.shape[0]
    V, dt, wb = t(cfg["V"]), t(cfg["DT_CONTROLS"]), t(cfg["WHEELBASE"])
    at2 = t(cfg["AT_WAYPOINT"]) ** 2
    max_delta = t(cfg["RATEG"]) * dt
    maxg = t(cfg["MAXG"])
    x = y = th = G = t(0.0)
    iwp, loops, done = 0, int(cfg["NUMBER_LOOPS"]), False
    out = np.zeros((n_ticks, 4))
    for k in range(n_ticks):
        if not done:
            wp = wps[iwp]
            reached = bool((wp[0] - x) ** 2 + (wp[1] - y) ** 2 < at2)
            nxt = iwp + 1 if reached else iwp
            exhausted = nxt >= n_wp
            new_loops = loops - 1 if exhausted and loops > 1 else loops
            done_now = exhausted and loops <= 1
            nxt = 0 if exhausted else nxt
            if not exhausted:
                tgt = wps[nxt]
                delta = wrap(torch.atan2(tgt[1] - y, tgt[0] - x) - th - G)
                delta = torch.clamp(delta, -max_delta, max_delta)
                G = torch.clamp(G + delta, -maxg, maxg)
            if done_now:
                done = True
            else:
                x, y, th = (x + V * dt * torch.cos(G + th),
                            y + V * dt * torch.sin(G + th),
                            wrap(th + V * dt * torch.sin(G) / wb))
                iwp, loops = nxt, new_loops
        out[k] = (float(x), float(y), float(th), float(done))
    return out


def visible(landmarks: np.ndarray, pose: np.ndarray, max_range: float,
            margin: float = 1e-3):
    """(visible [N] bool, ambiguous [N] bool) from one truth pose, in
    float64: ambiguous where the landmark lies within ``margin`` (m) of
    an edge of the field of view, where float32 may decide either way."""
    d = landmarks.astype(np.float64) - pose[:2]
    dx, dy = d[:, 0], d[:, 1]
    fwd = dx * math.cos(pose[2]) + dy * math.sin(pose[2])
    rng = np.sqrt(dx * dx + dy * dy)
    vis = ((np.abs(dx) < max_range) & (np.abs(dy) < max_range)
           & (fwd > 0.0) & (rng < max_range))
    amb = ((np.abs(np.abs(dx) - max_range) < margin)
           | (np.abs(np.abs(dy) - max_range) < margin)
           | (np.abs(fwd) < margin) | (np.abs(rng - max_range) < margin))
    return vis, amb


def range_bearing(landmarks: np.ndarray, pose, dtype=torch.float64):
    """True (range, bearing) [N, 2] of ``landmarks`` from ``pose``, the
    bearing wrapped, in ``dtype``; returned as float64 numpy."""
    lm = torch.as_tensor(np.asarray(landmarks, np.float64), dtype=dtype)
    p = torch.as_tensor(np.asarray(pose, np.float64), dtype=dtype)
    d = lm - p[:2]
    rng = torch.sqrt(torch.sum(d * d, dim=-1))
    brg = wrap(torch.atan2(d[:, 1], d[:, 0]) - p[2])
    return torch.stack([rng, brg], -1).to(torch.float64).numpy()


def observation_check(landmarks, true_pose, obs_z, obs_mask, obs_ids,
                      max_range: float, max_obs: int, sigma_r: float,
                      sigma_b: float):
    """Judge one run's observations against the truth poses it reports.

    Returns (id mismatches: supersteps whose reported landmarks are not
    the visible ones, ambiguous edges aside; the normalized noise
    residuals [n, 2] of every reported observation)."""
    miss, resid = 0, []
    for t in range(true_pose.shape[0]):
        pose = true_pose[t].astype(np.float64)
        vis, amb = visible(landmarks, pose, max_range)
        got = obs_ids[t][obs_mask[t]].astype(np.int64)
        want = np.flatnonzero(vis)
        sure = np.flatnonzero(vis & ~amb)
        if np.any(~(vis | amb)[got]) or len(set(got)) != len(got):
            miss += 1
        elif len(want) + int(np.sum(amb & ~vis)) <= max_obs:
            miss += int(not set(sure) <= set(got))
        else:
            miss += int(len(got) != max_obs)
        if got.size:
            h = range_bearing(landmarks[got], pose)
            z = obs_z[t][obs_mask[t]].astype(np.float64)
            resid.append(np.stack([(z[:, 0] - h[:, 0]) / sigma_r,
                                   np.asarray(wrap(torch.as_tensor(
                                       z[:, 1] - h[:, 1]))) / sigma_b], -1))
    resid = np.concatenate(resid) if resid else np.zeros((0, 2))
    return miss, resid


def noise_z(resid: np.ndarray) -> float:
    """How far normalized residuals [n, d] stray from N(0, 1): the
    largest z-score, over the columns, of their mean and of their mean
    square against 1. None for no residual."""
    n = resid.shape[0]
    if n == 0:
        return None
    mean_z = np.abs(resid.mean(0)) * math.sqrt(n)
    var_z = np.abs((resid ** 2).mean(0) - 1.0) / math.sqrt(2.0 / n)
    return float(max(mean_z.max(), var_z.max()))
