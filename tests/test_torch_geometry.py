"""The port's plot geometry (slam_tpu_torch.geometry) against the JAX
package's (slam_tpu.geometry), on seeded numpy inputs, at rtol 1e-5,
atol 1e-6: ``transform_to_global`` and ``laser_lines`` with poses at and
around +-pi, ``sqrtm_2x2_psd`` and ``covariance_ellipse`` with singular
(rank one) and zero covariances among random PSD ones. The JAX
functions take one pose or one ellipse at a time; the port's are
batched, and are held row by row against them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu import geometry as jg
from slam_tpu_torch import geometry as tg

TOL = dict(rtol=1e-5, atol=1e-6)
PI32 = float(np.float32(np.pi))


def poses(rng, n):
    """n poses [n, 3]: random, then headings at +-pi and one float32 ulp
    either side of them."""
    p = rng.normal(size=(n, 3)).astype(np.float32) * [50.0, 50.0, 2.0]
    edges = [PI32, -PI32, np.nextafter(np.float32(PI32), np.float32(0)),
             np.nextafter(np.float32(-PI32), np.float32(0)), 0.0]
    p[:len(edges), 2] = edges
    return p.astype(np.float32)


def covariances(rng, n):
    """n symmetric PSD 2x2 matrices: random, rank one (singular), zero,
    and diagonal with a zero entry."""
    A = rng.normal(size=(n, 2, 2)).astype(np.float32)
    P = A @ np.swapaxes(A, -1, -2)
    v = rng.normal(size=(4, 2)).astype(np.float32)
    P[:4] = v[:, :, None] * v[:, None, :]
    P[4] = 0.0
    P[5] = np.diag([0.3, 0.0])
    P[6] = np.diag([1e-12, 1e-12])
    return P.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_transform_to_global_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pose = poses(rng, 16)
    pts = rng.normal(size=(16, 7, 2)).astype(np.float32) * 10
    for p, q in zip(pose, pts):
        want = np.asarray(jg.transform_to_global(jnp.asarray(q),
                                                 jnp.asarray(p)))
        got = tg.transform_to_global(_t(q), _t(p)).numpy()
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_laser_lines_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pose = poses(rng, 16)
    z = np.stack([rng.uniform(0.1, 25.0, (16, 9)),
                  rng.uniform(-np.pi, np.pi, (16, 9))], axis=-1)
    z = z.astype(np.float32)
    z[0, :2, 1] = [PI32, -PI32]
    for p, zi in zip(pose, z):
        want = np.asarray(jg.laser_lines(jnp.asarray(zi), jnp.asarray(p)))
        got = tg.laser_lines(_t(zi), _t(p)).numpy()
        assert got.shape == want.shape == (9, 4)
        np.testing.assert_allclose(got, want, **TOL)
    empty = tg.laser_lines(torch.zeros((0, 2)), _t(pose[0]))
    assert empty.shape == (0, 4)


def test_sqrtm_2x2_psd_matches_jax():
    P = covariances(np.random.default_rng(2), 40)
    want = np.asarray(jg.sqrtm_2x2_psd(jnp.asarray(P)))
    got = tg.sqrtm_2x2_psd(_t(P)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[4] == 0.0)         # zero in, zero out (the 1e-30 floor)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("scale,segments", [(2.0, 16), (3.0, 8)])
def test_covariance_ellipse_matches_jax(scale, segments):
    rng = np.random.default_rng(3)
    P = covariances(rng, 24)
    c = rng.normal(size=(24, 2)).astype(np.float32) * 40
    got = tg.covariance_ellipse(_t(c), _t(P), segments, scale).numpy()
    assert got.shape == (24, segments + 1, 2)
    for i in range(24):
        want = np.asarray(jg.covariance_ellipse(
            jnp.asarray(c[i]), jnp.asarray(P[i]), segments, scale))
        np.testing.assert_allclose(got[i], want, **TOL)
        # Unbatched, as the JAX package calls it.
        one = tg.covariance_ellipse(_t(c[i]), _t(P[i]), segments, scale)
        np.testing.assert_allclose(one.numpy(), want, **TOL)
    np.testing.assert_array_equal(got[4], np.broadcast_to(c[4], got[4].shape))
