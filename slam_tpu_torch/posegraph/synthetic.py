"""The synthetic bundle-adjustment workload of BASELINE config #5
(counterpart: ``make_ba_problem`` in the repository's ``bench.py``,
which the port may not import)."""

from __future__ import annotations

import numpy as np
import torch

from slam_tpu_torch.posegraph.ba import BAProblem, to_local


def make_ba_problem(n_keyframes: int = 256, n_landmarks: int = 10_000,
                    K: int = 24, loops: int = 2, seed: int = 0,
                    device=None):
    """``loops`` passes around a 200 m-radius circle (landmarks seen
    again on the second pass brace the graph), noisy range-bearing
    observations of the K nearest landmarks of each keyframe, noisy
    odometry, and a dead-reckoned initial trajectory that carries real
    drift; landmarks initialized by back-projecting the observations from
    it. Made with numpy from ``seed``; the problem on ``device`` (none
    named: the card). Returns (problem, poses_true, poses0, lms_true),
    the last three numpy."""
    rng = np.random.default_rng(seed)
    T, L = n_keyframes, n_landmarks
    ang = np.linspace(0, loops * 2 * np.pi, T)
    th = np.mod(ang + np.pi / 2 + np.pi, 2 * np.pi) - np.pi
    poses = np.stack([200 * np.cos(ang), 200 * np.sin(ang), th],
                     -1).astype(np.float32)
    lms = rng.uniform(-300, 300, (L, 2)).astype(np.float32)
    d_all = np.linalg.norm(lms[None, :, :] - poses[:, None, :2], axis=-1)
    idx = np.argsort(d_all, axis=1)[:, :K].astype(np.int32)
    d = lms[idx] - poses[:, None, :2]
    z = np.stack([np.linalg.norm(d, axis=-1),
                  np.arctan2(d[..., 1], d[..., 0]) - poses[:, 2:3]],
                 -1).astype(np.float32)
    # Measurement noise consistent with R = diag(0.1^2 m^2, ~1 deg^2).
    z[..., 0] += rng.normal(scale=0.1, size=z[..., 0].shape)
    z[..., 1] += rng.normal(scale=0.017, size=z[..., 1].shape)
    # Odometry noise consistent with odom_info (5 cm, ~0.6 deg per
    # keyframe step). Pose 0 is the truth: it anchors the gauge.
    odom = to_local(torch.from_numpy(poses[:-1]),
                    torch.from_numpy(poses[1:])).numpy()
    odom = odom + np.stack(
        [rng.normal(scale=0.05, size=(T - 1,)),
         rng.normal(scale=0.05, size=(T - 1,)),
         rng.normal(scale=0.01, size=(T - 1,))], -1).astype(np.float32)
    poses0 = np.empty_like(poses)
    poses0[0] = poses[0]
    for t in range(T - 1):
        c, s = np.cos(poses0[t, 2]), np.sin(poses0[t, 2])
        poses0[t + 1] = (poses0[t, 0] + c * odom[t, 0] - s * odom[t, 1],
                         poses0[t, 1] + s * odom[t, 0] + c * odom[t, 1],
                         poses0[t, 2] + odom[t, 2])
    ang_w = poses0[:, 2:3] + z[..., 1]
    wx = poses0[:, 0:1] + z[..., 0] * np.cos(ang_w)
    wy = poses0[:, 1:2] + z[..., 0] * np.sin(ang_w)
    sums = np.zeros((L, 2))
    counts = np.zeros(L)
    np.add.at(sums, idx.reshape(-1),
              np.stack([wx.reshape(-1), wy.reshape(-1)], -1))
    np.add.at(counts, idx.reshape(-1), 1.0)
    lms0 = np.where(counts[:, None] > 0,
                    sums / np.maximum(counts, 1.0)[:, None],
                    lms).astype(np.float32)
    prob = BAProblem.from_numpy(
        device, poses0=poses0, landmarks0=lms0, odom=odom,
        odom_info=np.diag([400., 400., 10000.]), z=z, lm_idx=idx,
        mask=np.ones((T, K), bool), R=np.diag([0.01, 0.0003]))
    return prob, poses, poses0, lms
