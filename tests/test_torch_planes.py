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


def _near(values, width=2000):
    """Every float32 within ``width`` ulps of each value."""
    out = []
    for v in values:
        bits = int(np.array([v], np.float32).view(np.uint32)[0])
        out.append(np.arange(bits - width, bits + width + 1)
                   .astype(np.uint32).view(np.float32))
    return np.concatenate(out)


# The fast wrap's ranges meet where ang + pi is 0, +-2 pi and 4 pi.
WRAP_SWEEPS = {
    "two periods": lambda rng: rng.uniform(-4 * np.pi, 4 * np.pi, 200_000),
    "breakpoints": lambda rng: _near([k * np.pi for k in range(-6, 7)]),
    "zeros and tiny": lambda rng: np.concatenate([
        _near([0.0], 50), -_near([0.0], 50),
        [1e-45, -1e-45, 1e-30, -1e-30, 1e-7, -1e-7]]),
    "large": lambda rng: np.concatenate([
        rng.normal(size=50_000) * 1e3, rng.normal(size=50_000) * 1e8,
        [1e30, -1e30, 3.4e38, -3.4e38]]),
    "not finite": lambda rng: np.array([np.inf, -np.inf, np.nan]),
}


@pytest.mark.parametrize("sweep", WRAP_SWEEPS)
def test_wrap_angle_fast_is_wrap_angle_bit_for_bit(sweep):
    """The twin of csrc/planes.cuh:wrap_angle_fast against wrap_angle:
    the same bits (NaN for NaN), the sign of a zero included."""
    x = np.asarray(WRAP_SWEEPS[sweep](np.random.default_rng(5)), np.float32)
    t = torch.from_numpy(x)
    want, got = tgeo.wrap_angle(t), tgeo.wrap_angle_fast(t)
    assert got.dtype == want.dtype == torch.float32
    same = (got.view(torch.int32) == want.view(torch.int32)) | (
        got.isnan() & want.isnan())
    assert bool(same.all()), x[~same.numpy()][:5]
    if sweep != "not finite":
        _close(got, jgeo.wrap_angle(x))


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


@pytest.mark.parametrize("n", [2, 3])
def test_sym_packing_matches_jax(n):
    """models.particles' SYM maps and pack / unpack helpers against the
    JAX package's: the same index maps, the same planes, exact round
    trips."""
    import jax.numpy as jnp

    from slam_tpu.models import particles as jpart
    from slam_tpu_torch.models import particles as tpart

    assert getattr(tpart, f"SYM{n}") == getattr(jpart, f"SYM{n}")
    rng = np.random.default_rng(n)
    A = rng.normal(size=(5, 4, n, n)).astype(np.float32)
    M = A @ np.swapaxes(A, -1, -2)
    pack_j, pack_t = (getattr(m, f"pack_sym{n}") for m in (jpart, tpart))
    unpack_j, unpack_t = (getattr(m, f"unpack_sym{n}") for m in (jpart, tpart))
    planes = pack_t(torch.tensor(M))
    np.testing.assert_array_equal(planes.numpy(),
                                  np.asarray(pack_j(jnp.asarray(M))))
    np.testing.assert_array_equal(unpack_t(planes).numpy(), M)
    moved = np.moveaxis(planes.numpy(), 0, 1)
    np.testing.assert_array_equal(
        unpack_t(torch.tensor(moved), axis=1).numpy(),
        np.asarray(unpack_j(jnp.asarray(moved), axis=1)))
