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
