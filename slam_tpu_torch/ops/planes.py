"""Plane-form estimation math (counterpart: slam_tpu.ops.planes).

Scalar-expanded 2x2 algebra on broadcastable "planes", typically
[K, P] with the particle axis last. These functions are the plain
versions the CUDA kernels are held against: ``csrc/planes.cuh`` spells
out the same expressions, operation for operation, so a kernel and its
twin differ only by the device's libm (``sin``, ``cos``, ``log``).

Branch-free; degenerate inputs (landmarks at distance 0, singular S) are
guarded with the same epsilons as the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from slam_tpu_torch.geometry import wrap_angle

_LOG_2PI = math.log(2.0 * math.pi)
_PI = math.pi
_HALF_PI = 0.5 * _PI


def sym2_host(M) -> tuple[float, float, float]:
    """(m00, m01, m11) of a symmetric 2x2 held on the host, as Python
    floats rounded to float32. Scalars enter the plane math and the
    kernels' arguments without a device read."""
    M = np.asarray(M, dtype=np.float32)
    return float(M[0, 0]), float(M[0, 1]), float(M[1, 1])


def atan2_poly(y, x):
    """atan2 as the JAX package computes it: an odd minimax polynomial
    for atan on [0, 1] plus quadrant reconstruction, |err| < 1.1e-6 rad.
    Kept instead of ``torch.atan2`` so that the port, its kernels and
    the JAX package evaluate the same function."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    mx = torch.maximum(ax, ay)
    mn = torch.minimum(ax, ay)
    z = mn / torch.clamp(mx, min=1e-30)
    s = z * z
    p = (((((-0.0117212 * s + 0.05265332) * s - 0.11643287) * s
           + 0.19354346) * s - 0.33262348) * s + 0.99997726) * z
    r = torch.where(ay > ax, _HALF_PI - p, p)
    r = torch.where(x < 0.0, _PI - r, r)
    return torch.where(y < 0.0, -r, r)


class JacobianPlanes(NamedTuple):
    """Range-bearing model at (pose, landmark): prediction, pose and
    feature Jacobians, innovation covariance (packed symmetric)."""
    zr: torch.Tensor
    zb: torch.Tensor
    hv00: torch.Tensor
    hv01: torch.Tensor
    hv10: torch.Tensor
    hv11: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    e: torch.Tensor
    s00: torch.Tensor
    s01: torch.Tensor
    s11: torch.Tensor


def jacobians_planes(xvx, xvy, xvt, lmx, lmy, p00, p01, p11,
                     r00, r01, r11) -> JacobianPlanes:
    """computeJacobians in plane form."""
    dx = lmx - xvx
    dy = lmy - xvy
    d2 = torch.clamp(dx * dx + dy * dy, min=1e-12)
    d = torch.sqrt(d2)
    inv_d = 1.0 / d
    inv_d2 = 1.0 / d2

    zr = d
    zb = wrap_angle(atan2_poly(dy, dx) - xvt)

    a = dx * inv_d
    b = dy * inv_d
    c = -dy * inv_d2
    e = dx * inv_d2

    # Sf = Hf Pf Hf^T + R, expanded on the packed symmetric Pf.
    t0 = p00 * a + p01 * b
    t1 = p01 * a + p11 * b
    t2 = p00 * c + p01 * e
    t3 = p01 * c + p11 * e
    s00 = a * t0 + b * t1 + r00
    s01 = c * t0 + e * t1 + r01
    s11 = c * t2 + e * t3 + r11

    return JacobianPlanes(zr=zr, zb=zb,
                          hv00=-a, hv01=-b, hv10=-c, hv11=-e,
                          a=a, b=b, c=c, e=e,
                          s00=s00, s01=s01, s11=s11)


def log_gauss2_planes(v0, v1, s00, s01, s11):
    """log N(v; 0, S) with packed symmetric 2x2 S."""
    det = torch.clamp(s00 * s11 - s01 * s01, min=1e-30)
    quad = (s11 * v0 * v0 - 2.0 * s01 * v0 * v1 + s00 * v1 * v1) / det
    return -0.5 * quad - _LOG_2PI - 0.5 * torch.log(det)


class FeatureUpdatePlanes(NamedTuple):
    nx: torch.Tensor
    ny: torch.Tensor
    np00: torch.Tensor
    np01: torch.Tensor
    np11: torch.Tensor


def feature_update_planes(lmx, lmy, p00, p01, p11, v0, v1,
                          J: JacobianPlanes) -> FeatureUpdatePlanes:
    """Per-landmark 2x2 EKF update:
    W = Pf Hf' S^-1; xf += W v; Pf -= W (Pf Hf')'."""
    det = torch.clamp(J.s00 * J.s11 - J.s01 * J.s01, min=1e-30)
    i00 = J.s11 / det
    i01 = -J.s01 / det
    i11 = J.s00 / det

    pht00 = p00 * J.a + p01 * J.b
    pht01 = p00 * J.c + p01 * J.e
    pht10 = p01 * J.a + p11 * J.b
    pht11 = p01 * J.c + p11 * J.e

    w00 = pht00 * i00 + pht01 * i01
    w01 = pht00 * i01 + pht01 * i11
    w10 = pht10 * i00 + pht11 * i01
    w11 = pht10 * i01 + pht11 * i11

    nx = lmx + w00 * v0 + w01 * v1
    ny = lmy + w10 * v0 + w11 * v1
    np00 = p00 - (w00 * pht00 + w01 * pht01)
    np01 = p01 - 0.5 * ((w00 * pht10 + w01 * pht11)
                        + (w10 * pht00 + w11 * pht01))
    np11 = p11 - (w10 * pht10 + w11 * pht11)
    return FeatureUpdatePlanes(nx=nx, ny=ny, np00=np00, np01=np01,
                               np11=np11)


def feature_init_planes(xvx, xvy, xvt, zr, zb, r00, r01, r11):
    """New-landmark initialization: mean from pose + (r, b);
    Pf = Gz R Gz'."""
    s = torch.sin(xvt + zb)
    c = torch.cos(xvt + zb)
    nx = xvx + zr * c
    ny = xvy + zr * s
    g00, g01 = c, -zr * s
    g10, g11 = s, zr * c
    t0 = g00 * r00 + g01 * r01
    t1 = g00 * r01 + g01 * r11
    t2 = g10 * r00 + g11 * r01
    t3 = g10 * r01 + g11 * r11
    p00 = t0 * g00 + t1 * g01
    p01 = t0 * g10 + t1 * g11
    p11 = t2 * g10 + t3 * g11
    return nx, ny, p00, p01, p11
