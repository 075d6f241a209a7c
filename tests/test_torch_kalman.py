"""The port's observation Jacobians and Kalman primitives
(slam_tpu_torch.ops.jacobians, slam_tpu_torch.ops.kalman) against the JAX
package's on the same inputs, drawn from a numpy seed (the cases of
tests/test_ops.py:29-176). Both sides run float32 on the CPU; each case
states its tolerance, set by the float32 rounding of its longest chain
of operations."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.ops import jacobians as jjac
from slam_tpu.ops import kalman as jkal
from slam_tpu_torch.ops import jacobians as tjac
from slam_tpu_torch.ops import kalman as tkal

R2 = np.diag([0.01, 0.0003]).astype(np.float32)


def _rand_psd(rng, n, d, scale=1.0):
    A = rng.normal(size=(n, d, d)).astype(np.float32) * scale
    return A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(d, dtype=np.float32)


def _both(jfn, tfn, *args):
    """(JAX outputs, port outputs) as lists of numpy arrays, each side
    given the same numpy inputs."""
    j = jfn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
              for a in args))
    t = tfn(*(torch.from_numpy(a.copy()) if isinstance(a, np.ndarray)
              else a for a in args))
    as_list = lambda out: list(out) if isinstance(out, tuple) else [out]
    return ([np.asarray(a) for a in as_list(j)],
            [b.numpy() for b in as_list(t)])


def _jacobian_inputs(rng, shape=(64,)):
    xv = rng.normal(size=shape + (3,)).astype(np.float32)
    xf = (xv[..., :2] + rng.normal(size=shape + (2,)) * 10 + 1.0
          ).astype(np.float32)
    Pf = _rand_psd(rng, int(np.prod(shape)), 2, 0.3).reshape(
        shape + (2, 2))
    return xv, xf, Pf, R2


def case_jacobians(rng):
    return (jjac.compute_jacobians, tjac.compute_jacobians,
            _jacobian_inputs(rng), dict(rtol=1e-5, atol=1e-6))


def case_jacobians_broadcast(rng):
    """One pose against L landmarks, as the EKF calls it; one landmark at
    the pose (the guarded d2 = 0 case)."""
    xv, xf, Pf, R = _jacobian_inputs(rng)
    xf = xf.copy()
    xf[0] = xv[0, :2]
    return (jjac.compute_jacobians, tjac.compute_jacobians,
            (xv[0], xf, Pf, R), dict(rtol=1e-5, atol=1e-6))


def case_joseph(rng):
    N = 9
    P = _rand_psd(rng, 1, N)[0]
    x = rng.normal(size=N).astype(np.float32)
    H = np.zeros(N, np.float32)
    H[2] = 1.0
    return (jkal.joseph_update, tkal.joseph_update,
            (x, P, np.float32(0.2), 0.01, H), dict(rtol=1e-5, atol=1e-5))


def case_cholesky(rng):
    N, M = 9, 4
    P = _rand_psd(rng, 1, N)[0]
    x = rng.normal(size=N).astype(np.float32)
    H = rng.normal(size=(M, N)).astype(np.float32)
    R = _rand_psd(rng, 1, M, 0.1)[0]
    v = rng.normal(size=M).astype(np.float32)
    return (jkal.cholesky_update, tkal.cholesky_update, (x, P, v, R, H),
            dict(rtol=1e-4, atol=1e-4))


def case_cholesky_not_pd(rng):
    """An S that is not positive definite: NaN on both sides."""
    N, M = 5, 2
    P = -_rand_psd(rng, 1, N)[0]
    x = rng.normal(size=N).astype(np.float32)
    H = rng.normal(size=(M, N)).astype(np.float32)
    R = np.zeros((M, M), np.float32)
    v = rng.normal(size=M).astype(np.float32)
    return (jkal.cholesky_update, tkal.cholesky_update, (x, P, v, R, H),
            dict(rtol=0, atol=0, equal_nan=True))


def case_feature_update(rng):
    n = 32
    xf = rng.normal(size=(n, 2)).astype(np.float32)
    Pf = _rand_psd(rng, n, 2, 0.5)
    v = (rng.normal(size=(n, 2)) * 0.1).astype(np.float32)
    Hf = rng.normal(size=(n, 2, 2)).astype(np.float32)
    return (jkal.feature_update_2x2, tkal.feature_update_2x2,
            (xf, Pf, v, R2, Hf), dict(rtol=1e-4, atol=1e-5))


def case_inv_2x2(rng):
    S = _rand_psd(rng, 20, 2)
    S[0] = 0.0                      # the guarded singular case
    return jkal.inv_2x2, tkal.inv_2x2, (S,), dict(rtol=1e-5, atol=0)


def case_solve_3x3(rng):
    A = _rand_psd(rng, 16, 3)
    B = rng.normal(size=(16, 3, 2)).astype(np.float32)
    return (jkal.solve_3x3_psd, tkal.solve_3x3_psd, (A, B),
            dict(rtol=1e-4, atol=1e-5))


def case_inv_3x3(rng):
    return (jkal.inv_3x3_psd, tkal.inv_3x3_psd, (_rand_psd(rng, 16, 3),),
            dict(rtol=1e-4, atol=1e-5))


def case_add_feature_init(rng):
    xv = rng.normal(size=(24, 3)).astype(np.float32)
    z = np.stack([rng.uniform(1, 25, 24), rng.uniform(-1.5, 1.5, 24)],
                 -1).astype(np.float32)
    return (jkal.add_feature_init, tkal.add_feature_init, (xv, z),
            dict(rtol=1e-5, atol=1e-5))


def case_innovation(rng):
    z = np.stack([rng.uniform(1, 25, 40), rng.uniform(-3.14, 3.14, 40)],
                 -1).astype(np.float32)
    zp = np.stack([rng.uniform(1, 25, 40), rng.uniform(-3.14, 3.14, 40)],
                  -1).astype(np.float32)
    return (jkal.innovation, tkal.innovation, (z, zp),
            dict(rtol=1e-6, atol=1e-6))


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("name", CASES)
def test_matches_jax(name):
    jfn, tfn, args, tol = CASES[name](np.random.default_rng(7))
    j_out, t_out = _both(jfn, tfn, *args)
    assert len(j_out) == len(t_out)
    for a, b in zip(j_out, t_out):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(b, a, **tol)


def test_cases_cover_the_module():
    """Every function of the JAX module has a case here."""
    covered = {fn(np.random.default_rng(0))[0].__name__
               for fn in CASES.values()}
    assert covered == {"compute_jacobians", "joseph_update",
                       "cholesky_update", "feature_update_2x2", "inv_2x2",
                       "solve_3x3_psd", "inv_3x3_psd", "add_feature_init",
                       "innovation"}


def test_joseph_update_matches_the_textbook():
    """The port's Joseph update is the scalar Kalman update and keeps P
    symmetric (tests/test_ops.py's oracle, on the port)."""
    rng = np.random.default_rng(1)
    P = _rand_psd(rng, 1, 3)[0]
    x = np.array([1.0, 2.0, 0.5], np.float32)
    H = np.array([0.0, 0.0, 1.0], np.float32)
    x2, P2 = tkal.joseph_update(*(torch.from_numpy(a) for a in (x, P)),
                                0.2, 0.01, torch.from_numpy(H))
    K = P[:, 2] / (P[2, 2] + 0.01)
    np.testing.assert_allclose(x2.numpy(), x + K * 0.2, rtol=1e-5)
    C = np.eye(3) - np.outer(K, H)
    np.testing.assert_allclose(P2.numpy(), C @ P @ C.T + 0.01 * np.outer(
        K, K), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(P2.numpy(), P2.numpy().T, atol=1e-7)
