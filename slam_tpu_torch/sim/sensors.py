"""Range-bearing sensor with a semicircular field of view (counterpart:
slam_tpu.sim.sensors): visibility for every landmark at once, then a
stable compaction of the visible ones, in landmark order, into
``max_obs`` slots with a validity mask."""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_tpu_torch.geometry import wrap_angle


class Observation(NamedTuple):
    """``z`` [max_obs, 2] (range, bearing); ``ids`` [max_obs] int32
    landmark ids (arbitrary where not ``mask``); ``mask`` [max_obs]
    bool; ``count`` [] int32."""
    z: torch.Tensor
    ids: torch.Tensor
    mask: torch.Tensor
    count: torch.Tensor


def visible_mask(landmarks, pose, max_range):
    """|dx| < R, |dy| < R, forward half-plane, and d^2 < R^2."""
    d = landmarks - pose[:2]
    dx, dy = d[..., 0], d[..., 1]
    c, s = torch.cos(pose[2]), torch.sin(pose[2])
    return ((torch.abs(dx) < max_range)
            & (torch.abs(dy) < max_range)
            & (dx * c + dy * s > 0.0)
            & (dx * dx + dy * dy < max_range * max_range))


def range_bearing(landmarks, pose):
    """True (range, bearing) [N, 2]; the bearing is not wrapped."""
    d = landmarks - pose[:2]
    rng = torch.sqrt(torch.sum(d * d, dim=-1))
    brg = torch.atan2(d[..., 1], d[..., 0]) - pose[2]
    return torch.stack([rng, brg], dim=-1)


def observe(landmarks, pose, max_range, max_obs: int, noise=None,
            sigma_r: float = 0.0, sigma_b: float = 0.0) -> Observation:
    """Visibility, compaction and optional noise. ``noise``: standard
    normals [max_obs, 2], scaled by (sigma_r, sigma_b); None for a
    noiseless batch."""
    vis = visible_mask(landmarks, pose, max_range)
    count = torch.sum(vis, dtype=torch.int32)
    order = torch.argsort((~vis).to(torch.int32), stable=True)
    slots = order[:max_obs]
    slot_mask = ((torch.arange(max_obs, device=landmarks.device) < count)
                 & vis[slots])

    z = range_bearing(landmarks[slots], pose)
    if noise is not None:
        # Column by column with host scalars: building a sigma tensor
        # would copy host memory to the card, which waits for the
        # stream.
        z = torch.stack([z[:, 0] + noise[:, 0] * sigma_r,
                         z[:, 1] + noise[:, 1] * sigma_b], dim=1)
    z = torch.where(slot_mask[:, None], z, 0.0)
    z = torch.stack([z[:, 0],
                     torch.where(slot_mask, wrap_angle(z[:, 1]), 0.0)],
                    dim=1)
    return Observation(z=z, ids=slots.to(torch.int32), mask=slot_mask,
                       count=torch.clamp(count, max=max_obs))
