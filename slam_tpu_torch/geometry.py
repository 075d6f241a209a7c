"""Geometry primitives of the slice (counterpart: slam_tpu.geometry)."""

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
