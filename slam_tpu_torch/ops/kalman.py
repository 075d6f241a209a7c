"""Kalman update primitives (counterpart: slam_tpu.ops.kalman).

- ``joseph_update``: scalar-observation Joseph-form covariance update
  with the reference's eps jitter.
- ``cholesky_update``: dense Kalman update via the Cholesky factor of
  the innovation covariance.
- ``feature_update_2x2``: per-landmark 2x2 EKF update in closed form.
- ``add_feature_init``: a landmark's mean and its initialization
  Jacobian Gz from pose + (range, bearing).

All are batch-friendly. None reads a device value on the host: the
factorizations are the ``_ex`` forms, which report failure in a device
tensor instead of raising; a failed Cholesky gives NaN, as the JAX
package's does.
"""

from __future__ import annotations

import math

import torch

from slam_tpu_torch.geometry import wrap_angle

_JOSEPH_EPS = 2.2204e-16


def joseph_update(x, P, v, r, H):
    """Scalar-observation Joseph-form update.

    Args:
      x: [N] state. P: [N, N] covariance. v: scalar innovation.
      r: scalar observation variance. H: [N] observation row.
    Returns updated (x, P). P gets the reference's +eps*I jitter.
    """
    PHt = P @ H                      # [N]
    s = H @ PHt + r                  # scalar
    W = PHt / s                      # [N]
    x_new = x + W * v
    n = x.shape[-1]
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    C = eye - torch.outer(W, H)
    P_new = (C @ P) @ C.T + r * torch.outer(W, W)
    P_new = P_new + _JOSEPH_EPS * eye
    return x_new, P_new


def cholesky_lower(S):
    """Lower Cholesky factor of S, NaN where the factorization fails
    (the JAX package's result), with no host read of the status."""
    L, info = torch.linalg.cholesky_ex(S)
    return torch.where((info != 0)[..., None, None], math.nan, L)


def solve_lower(L, b):
    """L^-1 b for lower-triangular L; ``b`` [M] or [M, k]."""
    if b.dim() == 1:
        return torch.linalg.solve_triangular(L, b[:, None],
                                             upper=False)[:, 0]
    return torch.linalg.solve_triangular(L, b, upper=False)


def cholesky_update(x, P, v, R, H):
    """Dense Kalman update via Cholesky.

    Args:
      x: [N]. P: [N, N]. v: [M] innovation. R: [M, M]. H: [M, N].
    Returns updated (x, P). Symmetrizes S before factorization like the
    reference; P update uses the W1 W1^T form for symmetry.
    """
    PHt = P @ H.T                    # [N, M]
    S = H @ PHt + R
    S = 0.5 * (S + S.T)
    # Small diagonal jitter keeps the factorization alive when f32
    # accumulation error nudges S off PSD late in long runs.
    m = S.shape[-1]
    S = S + 1e-6 * torch.trace(S) / m * torch.eye(m, dtype=S.dtype,
                                                  device=S.device)
    L = cholesky_lower(S)            # [M, M]
    # W1 = PHt L^-T ; P -= W1 W1^T ; x += PHt S^-1 v
    W1 = solve_lower(L, PHt.T).T     # [N, M]
    Wv = W1 @ solve_lower(L, v)
    return x + Wv, P - W1 @ W1.T


def feature_update_2x2(xf, Pf, v, R, Hf):
    """Per-landmark 2x2 EKF update, closed form, batched over leading
    axes: W = Pf Hf^T S^-1 with S = Hf Pf Hf^T + R; xf += W v;
    Pf -= W S W^T. Inputs: xf [..., 2], Pf [..., 2, 2], v [..., 2],
    R [2, 2], Hf [..., 2, 2]. Returns (xf', Pf')."""
    PHt = Pf @ Hf.transpose(-1, -2)
    S = Hf @ PHt + R
    S = 0.5 * (S + S.transpose(-1, -2))
    W = PHt @ inv_2x2(S)
    xf_new = xf + (W @ v[..., None])[..., 0]
    # P' = P - W S W^T == P - W (PHt)^T, the W1 W1^T form.
    Pf_new = Pf - W @ PHt.transpose(-1, -2)
    Pf_new = 0.5 * (Pf_new + Pf_new.transpose(-1, -2))
    return xf_new, Pf_new


def inv_2x2(S):
    """Closed-form 2x2 inverse, batched; |det| below 1e-30 becomes
    1e-30."""
    a, b = S[..., 0, 0], S[..., 0, 1]
    c, d = S[..., 1, 0], S[..., 1, 1]
    det = a * d - b * c
    det = torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    inv = torch.stack([
        torch.stack([d, -b], dim=-1),
        torch.stack([-c, a], dim=-1),
    ], dim=-2)
    return inv / det[..., None, None]


def solve_3x3_psd(A, B):
    """Solve A X = B for symmetric PD 3x3 A (batched; B [..., 3, k])."""
    return torch.linalg.solve_ex(A, B).result


def inv_3x3_psd(A):
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)
    return solve_3x3_psd(A, eye)


def add_feature_init(xv, z):
    """A landmark's mean and the Gz Jacobian from pose + (range,
    bearing). Args: xv [..., 3], z [..., 2]. Returns (xf [..., 2],
    Gz [..., 2, 2]); the landmark covariance is Gz R Gz^T, composed by
    the caller."""
    r, b = z[..., 0], z[..., 1]
    s = torch.sin(xv[..., 2] + b)
    c = torch.cos(xv[..., 2] + b)
    xf = torch.stack([xv[..., 0] + r * c, xv[..., 1] + r * s], dim=-1)
    Gz = torch.stack([
        torch.stack([c, -r * s], dim=-1),
        torch.stack([s, r * c], dim=-1),
    ], dim=-2)
    return xf, Gz


def innovation(z, zp):
    """Measurement innovation with the bearing wrapped."""
    v = z - zp
    return torch.stack([v[..., 0], wrap_angle(v[..., 1])], dim=-1)
