"""The benchmark's traffic generators, frozen: the worlds and the bundle-
adjustment problems that the cells run, made with numpy from a seed.

Frozen copies, so that a change to the program cannot change what it is
measured on:

- ``synthetic_map``: ``slam_tpu_torch.maps.synthetic_map``;
- ``make_world``: the map of ``slam_tpu_torch.runtime.config5.
  config5_setup``, shifted so that waypoint 0, where the vehicle starts,
  is the origin (``origin="waypoint0"``), or left unshifted, so that the
  vehicle starts at the centre of the loop (``origin="centre"``);
- ``make_ba_problem``: ``slam_tpu_torch.posegraph.synthetic.
  make_ba_problem``, returning numpy arrays in place of a ``BAProblem``.

``benchmark/tests/test_bench_world.py`` holds each equal to the
program's at a small size. Imports numpy and torch.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def synthetic_map(n_landmarks: int, n_waypoints: int = 32,
                  radius: float = 200.0, seed: int = 0):
    """(landmarks [N, 2], waypoints [W, 2]) float32: waypoints on a
    wobbly loop, landmarks scattered in an annulus around its corridor."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(0.0, 2 * np.pi, n_waypoints, endpoint=False)
    r_wp = radius * (1.0 + 0.15 * np.sin(3 * theta))
    waypoints = np.stack([r_wp * np.cos(theta), r_wp * np.sin(theta)],
                         axis=1).astype(np.float32)
    ang = rng.uniform(0.0, 2 * np.pi, n_landmarks)
    rad = radius * (1.0 + rng.uniform(-0.4, 0.4, n_landmarks))
    landmarks = np.stack([rad * np.cos(ang), rad * np.sin(ang)],
                         axis=1).astype(np.float32)
    return landmarks, waypoints


def make_world(world: dict):
    """(landmarks, waypoints) of a configuration's ``world`` entry:
    ``synthetic_map`` of its sizes, then ``origin``: "centre" leaves the
    map as made (the vehicle starts at the loop's centre), "waypoint0"
    shifts landmarks and waypoints so that waypoint 0 is the origin."""
    lms, wps = synthetic_map(world["n_landmarks"], world["n_waypoints"],
                             world["radius"], world["seed"])
    origin = world.get("origin", "centre")
    if origin == "waypoint0":
        shift = wps[0].copy()
        lms, wps = lms - shift, wps - shift
    elif origin != "centre":
        raise ValueError(f"world origin {origin!r}: centre or waypoint0")
    return lms, wps


def _to_local(a, b):
    """Relative SE(2) transform of pose b in the frame of pose a (float32
    [..., 3]), in torch on the CPU, as the program computes it."""
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    dth = torch.remainder(b[..., 2] - a[..., 2] + math.pi,
                          2 * math.pi) - math.pi
    return torch.stack([c * dx + s * dy, -s * dx + c * dy, dth],
                       dim=-1).numpy()


def make_ba_problem(n_keyframes: int = 256, n_landmarks: int = 10_000,
                    K: int = 24, loops: int = 2, seed: int = 0) -> dict:
    """``loops`` passes around a 200 m-radius circle, noisy range-bearing
    observations of the K nearest landmarks of each keyframe, noisy
    odometry and a dead-reckoned initial trajectory; landmarks
    initialized by back-projecting the observations from it. Returns a
    dict of numpy arrays: the problem's fields (``poses0``,
    ``landmarks0``, ``odom``, ``odom_info``, ``z``, ``lm_idx``, ``mask``,
    ``R``) and the truth (``poses_true``, ``lms_true``)."""
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
    z[..., 0] += rng.normal(scale=0.1, size=z[..., 0].shape)
    z[..., 1] += rng.normal(scale=0.017, size=z[..., 1].shape)
    odom = _to_local(poses[:-1], poses[1:])
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
    return dict(poses0=poses0, landmarks0=lms0, odom=odom,
                odom_info=np.diag([400., 400., 10000.]).astype(np.float32),
                z=z, lm_idx=idx, mask=np.ones((T, K), bool),
                R=np.diag([0.01, 0.0003]).astype(np.float32),
                poses_true=poses, lms_true=lms)
