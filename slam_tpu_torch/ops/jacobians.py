"""Range-bearing observation Jacobians in the batched, broadcasting form
(counterpart: slam_tpu.ops.jacobians).

The EKF estimators call this with one pose against many landmarks. The
plane form that FastSLAM runs (and K1 computes) is
``ops.planes.jacobians_planes``.

Per landmark, with dx = xf - xv_x, dy = xf_y - xv_y, d2 = dx^2 + dy^2,
d = sqrt(d2):

    zp = [d, wrap(atan2(dy, dx) - theta)]
    Hv = [[-dx/d,  -dy/d,  0],
          [ dy/d2, -dx/d2, -1]]
    Hf = [[ dx/d,   dy/d],
          [-dy/d2,  dx/d2]]
    Sf = Hf Pf Hf^T + R
"""

from __future__ import annotations

import torch

from slam_tpu_torch.geometry import wrap_angle


def compute_jacobians(xv, xf, Pf, R):
    """Batched observation Jacobians.

    Args:
      xv: [..., 3] vehicle pose(s).
      xf: [..., 2] landmark mean(s).
      Pf: [..., 2, 2] landmark covariance(s).
      R:  [2, 2] observation noise (broadcast).

    Returns:
      zp [..., 2], Hv [..., 2, 3], Hf [..., 2, 2], Sf [..., 2, 2].
    """
    dx = xf[..., 0] - xv[..., 0]
    dy = xf[..., 1] - xv[..., 1]
    # Guard the padded-landmark case (dx = dy = 0); callers mask the
    # outputs anyway.
    d2 = torch.clamp(dx * dx + dy * dy, min=1e-12)
    d = torch.sqrt(d2)

    zp = torch.stack([d, wrap_angle(torch.atan2(dy, dx) - xv[..., 2])],
                     dim=-1)

    zeros = torch.zeros_like(d)
    ones = torch.ones_like(d)
    Hv = torch.stack([
        torch.stack([-dx / d, -dy / d, zeros], dim=-1),
        torch.stack([dy / d2, -dx / d2, -ones], dim=-1),
    ], dim=-2)
    Hf = torch.stack([
        torch.stack([dx / d, dy / d], dim=-1),
        torch.stack([-dy / d2, dx / d2], dim=-1),
    ], dim=-2)

    # Sf = Hf Pf Hf^T + R, expanded in scalars as the JAX package does.
    a, b = Hf[..., 0, 0], Hf[..., 0, 1]
    c, e = Hf[..., 1, 0], Hf[..., 1, 1]
    p00, p01 = Pf[..., 0, 0], Pf[..., 0, 1]
    p10, p11 = Pf[..., 1, 0], Pf[..., 1, 1]

    s00 = a * (p00 * a + p01 * b) + b * (p10 * a + p11 * b)
    s01 = a * (p00 * c + p01 * e) + b * (p10 * c + p11 * e)
    s10 = c * (p00 * a + p01 * b) + e * (p10 * a + p11 * b)
    s11 = c * (p00 * c + p01 * e) + e * (p10 * c + p11 * e)
    Sf = torch.stack([
        torch.stack([s00 + R[0, 0], s01 + R[0, 1]], dim=-1),
        torch.stack([s10 + R[1, 0], s11 + R[1, 1]], dim=-1),
    ], dim=-2)
    return zp, Hv, Hf, Sf
