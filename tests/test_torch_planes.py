"""The port's plane algebra (slam_tpu_torch.ops.planes, geometry) against
the JAX package's on the same numpy inputs.

Tolerance: rtol 1e-6, the float32 rounding of a few operations. An
absolute floor of 1e-6 covers entries that cancel to near zero (s01,
c, e at long range), where a relative bound says nothing."""

import numpy as np
import pytest
import torch

from slam_tpu import geometry as jgeo
from slam_tpu.ops import planes as jpk
from slam_tpu_torch import geometry as tgeo
from slam_tpu_torch.ops import planes as tpk

RTOL, ATOL = 1e-6, 1e-6
R = np.diag([0.01, 0.0003]).astype(np.float32)
R3 = (float(R[0, 0]), float(R[0, 1]), float(R[1, 1]))


def _close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=name)


def _inputs(P=257, K=5, seed=0):
    rng = np.random.default_rng(seed)
    xv = rng.normal(size=(3, P)).astype(np.float32)
    xv[2] *= 3.0
    lmx = (xv[0] + rng.normal(size=(K, P)) * 8 + 2).astype(np.float32)
    lmy = (xv[1] + rng.normal(size=(K, P)) * 8 + 1).astype(np.float32)
    A = rng.normal(size=(K, P)).astype(np.float32) * 0.3
    B = rng.normal(size=(K, P)).astype(np.float32) * 0.3
    p00 = A * A + 0.05
    p11 = B * B + 0.05
    p01 = 0.3 * A * B
    z = np.column_stack([rng.uniform(2, 25, K),
                         rng.uniform(-1.5, 1.5, K)]).astype(np.float32)
    return xv, lmx, lmy, p00, p01, p11, z


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def test_wrap_angle_matches_jax():
    x = np.random.default_rng(1).normal(size=4096).astype(np.float32) * 20
    x[:4] = [np.pi, -np.pi, 3 * np.pi, -7.5]
    _close(tgeo.wrap_angle(torch.from_numpy(x)), jgeo.wrap_angle(x))
    w = tgeo.wrap_angle(torch.from_numpy(x)).numpy()
    assert w.min() >= -np.pi - 1e-6 and w.max() < np.pi + 1e-6


@pytest.mark.parametrize("scale", [1e-3, 1.0, 50.0])
def test_atan2_poly_matches_jax(scale):
    rng = np.random.default_rng(2)
    y, x = (rng.normal(size=(2, 2048)) * scale).astype(np.float32)
    y[:3], x[:3] = [0.0, 1.0, -1.0], [-1.0, 0.0, 0.0]
    _close(tpk.atan2_poly(*_t(y, x)), jpk.atan2_poly(y, x))


def test_jacobians_planes_matches_jax():
    xv, lmx, lmy, p00, p01, p11, _ = _inputs()
    txv, *tl = _t(xv, lmx, lmy, p00, p01, p11)
    got = tpk.jacobians_planes(txv[0:1], txv[1:2], txv[2:3], *tl, *R3)
    want = jpk.jacobians_planes(xv[0][None], xv[1][None], xv[2][None],
                                lmx, lmy, p00, p01, p11, *R3)
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        _close(g, w, name)


def test_log_gauss2_planes_matches_jax():
    xv, lmx, lmy, p00, p01, p11, z = _inputs(seed=3)
    J = jpk.jacobians_planes(xv[0][None], xv[1][None], xv[2][None],
                             lmx, lmy, p00, p01, p11, *R3)
    v0 = z[:, 0:1] - np.asarray(J.zr)
    v1 = np.asarray(jgeo.wrap_angle(z[:, 1:2] - J.zb))
    S = [np.asarray(s) for s in (J.s00, J.s01, J.s11)]
    _close(tpk.log_gauss2_planes(*_t(v0, v1, *S)),
           jpk.log_gauss2_planes(v0, v1, *S))


def test_feature_update_planes_matches_jax():
    xv, lmx, lmy, p00, p01, p11, z = _inputs(seed=4)
    J = jpk.jacobians_planes(xv[0][None], xv[1][None], xv[2][None],
                             lmx, lmy, p00, p01, p11, *R3)
    v0 = z[:, 0:1] - np.asarray(J.zr)
    v1 = np.asarray(jgeo.wrap_angle(z[:, 1:2] - J.zb))
    tJ = tpk.JacobianPlanes(*_t(*[np.asarray(f) for f in J]))
    got = tpk.feature_update_planes(*_t(lmx, lmy, p00, p01, p11, v0, v1),
                                    tJ)
    want = jpk.feature_update_planes(lmx, lmy, p00, p01, p11, v0, v1, J)
    for name, g, w in zip(got._fields, got, want):
        _close(g, w, name)


def test_feature_init_planes_matches_jax():
    xv, *_, z = _inputs(seed=5)
    txv, tz = _t(xv, z)
    got = tpk.feature_init_planes(txv[0:1], txv[1:2], txv[2:3],
                                  tz[:, 0:1], tz[:, 1:2], *R3)
    want = jpk.feature_init_planes(xv[0][None], xv[1][None], xv[2][None],
                                   z[:, 0:1], z[:, 1:2], *R3)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"output {i}")
