"""Geometry primitives (counterpart: slam_tpu.geometry): the angle wrap,
and the plot geometry the streaming run draws with. Every function is
batched and runs on any device."""

from __future__ import annotations

import math

import torch

PI = math.pi
TWO_PI = 2.0 * math.pi


def wrap_angle(ang: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to [-pi, pi) with a floored modulo.

    ``torch.remainder`` is fmod plus a sign fix-up, the same operation
    as ``jnp.mod``; a truncating fmod alone would leave negative angles
    in (-3 pi, -pi)."""
    return torch.remainder(ang + PI, TWO_PI) - PI


def wrap_angle_fast(ang: torch.Tensor) -> torch.Tensor:
    """``wrap_angle`` bit for bit, with the remainder taken only outside
    two periods: the plain twin of ``csrc/planes.cuh:wrap_angle_fast``,
    which K6 and K6b wrap their headings with.

    With s = ang + pi and m = 2 pi in float32: s in [0, m) is its own
    remainder; for s in [m, 2 m) the remainder s - m is exact (Sterbenz);
    s in (-m, 0) is lifted by m, the one rounded addition the floored
    modulo makes there too. Every other s (and NaN) takes
    ``torch.remainder``."""
    s = ang + PI
    m = torch.tensor(TWO_PI, dtype=s.dtype, device=s.device)
    r = torch.where(
        (s >= 0) & (s < m), s,
        torch.where((s >= m) & (s < 2 * m), s - m,
                    torch.where((s < 0) & (s > -m), s + m,
                                torch.remainder(s, m))))
    return r - PI


def transform_to_global(points: torch.Tensor, pose: torch.Tensor
                        ) -> torch.Tensor:
    """Rotate and translate local points [..., 2] into the global frame
    of ``pose`` [3] = (x, y, theta)."""
    c, s = torch.cos(pose[2]), torch.sin(pose[2])
    x = points[..., 0] * c - points[..., 1] * s + pose[0]
    y = points[..., 0] * s + points[..., 1] * c + pose[1]
    return torch.stack([x, y], dim=-1)


def laser_lines(z: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Observation rays for plotting: for each (range, bearing) row of
    ``z`` [K, 2], the segment from the pose to the observed point, as
    [K, 4] rows (x0, y0, x1, y1)."""
    local = torch.stack([z[..., 0] * torch.cos(z[..., 1]),
                         z[..., 0] * torch.sin(z[..., 1])], dim=-1)
    pts = transform_to_global(local, pose)
    origin = pose[:2].expand(pts.shape)
    return torch.cat([origin, pts], dim=-1)


def sqrtm_2x2_psd(P: torch.Tensor) -> torch.Tensor:
    """Closed-form principal square root of symmetric PSD 2x2 matrices
    [..., 2, 2]: (M + sqrt(det) I) / sqrt(trace + 2 sqrt(det)), with
    the determinant clamped at 0 and the root's argument at 1e-30 (a
    zero matrix gives zero)."""
    a = P[..., 0, 0]
    b = P[..., 0, 1]
    c = P[..., 1, 1]
    s = torch.sqrt(torch.clamp_min(a * c - b * b, 0.0))
    t = torch.sqrt(torch.clamp_min(a + c + 2.0 * s, 1e-30))
    eye = torch.eye(2, dtype=P.dtype, device=P.device)
    return (P + s[..., None, None] * eye) / t[..., None, None]


def covariance_ellipse(center: torch.Tensor, P: torch.Tensor,
                       n_segments: int = 16, scale: float = 2.0
                       ) -> torch.Tensor:
    """The 2-sigma covariance ellipse polyline of each ``center``
    [..., 2] and covariance ``P`` [..., 2, 2]: [..., n_segments + 1, 2]
    points. The product with the square root is written out, so no
    matrix unit (or TF32) is involved."""
    r = sqrtm_2x2_psd(P)[..., None, :, :]
    phi = torch.linspace(0.0, TWO_PI, n_segments + 1, dtype=P.dtype,
                         device=P.device)
    c, s = torch.cos(phi), torch.sin(phi)
    x = c * r[..., 0, 0] + s * r[..., 0, 1]
    y = c * r[..., 1, 0] + s * r[..., 1, 1]
    return center[..., None, :] + scale * torch.stack([x, y], dim=-1)
