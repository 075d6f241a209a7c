"""K6, the multi-tick FastSLAM 1 predict, and its Philox stream.

- Philox4x32-10 against published known-answer vectors.
- The plain twin with the noise off against the JAX package's
  ``fs1_predict_multi_tpu`` in interpret mode (the TPU kernel's PRNG arm
  has no CPU lowering, as tests/test_deferred.py notes), at rtol/atol
  1e-5: float32 rounding through 8 bicycle steps.
  The same at T = 3 and T = 11, tick counts that are no multiple of
  the unrolling of the CUDA kernel's tick loop.
- The twin with the noise on: the moments of (V, G) against the
  nominal controls and Q, within 4 standard errors.
- On a card, the CUDA kernel against the twin, draw for draw: bit for
  bit at T = 8, at a T that is no multiple of the tick loop's
  unrolling and at a T that takes two launches, at 2^20 particles and
  at a ragged count, the noise on and off; and the sweep
  that holds the kernel's sincosf and fast wrap to sinf, cosf and the
  fmodf wrap on every float32 bit pattern.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.ops.pallas.kernels import fs1_predict_multi_tpu
from slam_tpu_torch.geometry import wrap_angle
from slam_tpu_torch.ops import kernels as tk
from slam_tpu_torch.ops.kernels import predict as tp

TOL = dict(rtol=1e-5, atol=1e-5)
WHEELBASE, DT = 4.0, 0.025
Q_DIAG = np.diag([0.09, 0.0025]).astype(np.float32)
M32 = 0xFFFFFFFF

# Philox4x32-10 known answers (Random123's kat_vectors): counter, key,
# output words.
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32, M32, M32, M32), (M32, M32),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def _controls(T, seed=3):
    rng = np.random.default_rng(seed)
    return np.column_stack([rng.uniform(1, 4, T),
                            rng.uniform(-0.3, 0.3, T)]).astype(np.float32)


def _seed(a, b):
    return torch.tensor([a, b], dtype=torch.int32)


@pytest.mark.parametrize("counter,key,want", KAT, ids=["zeros", "ones",
                                                      "pi"])
def test_philox_known_answers(counter, key, want):
    got = tp.philox4x32([torch.tensor(c, dtype=torch.int64)
                         for c in counter],
                        [torch.tensor(k, dtype=torch.int64) for k in key])
    assert [int(w) for w in got] == list(want)


def test_philox_counters_map_to_distinct_words():
    """Every (particle, tick) counter gets its own words 0 and 1, in
    [0, 2^32), and the seed words enter as unsigned."""
    P, T = 4096, 8
    p = torch.arange(P, dtype=torch.int64)
    key = tp.seed_key(_seed(-7, 2 ** 31 - 1))
    assert [int(k) for k in key] == [2 ** 32 - 7, 2 ** 31 - 1]
    words = []
    for t in range(T):
        b0, b1, _, _ = tp.philox4x32((p, t, 0, 0), key)
        assert int(b0.min()) >= 0 and int(b1.max()) <= M32
        words.append(b0 * 2 ** 32 + b1)
    assert torch.unique(torch.cat(words)).numel() == P * T


def _check_k6_twin_noise_off_against_jax(T):
    P = 512
    rng = np.random.default_rng(3)
    xv = rng.normal(size=(3, P)).astype(np.float32)
    ctl = _controls(T)
    want = fs1_predict_multi_tpu(jnp.asarray(xv), jax.random.key(0),
                                 jnp.asarray(ctl), jnp.asarray(Q_DIAG),
                                 wheelbase=WHEELBASE, dt=DT,
                                 add_noise=False, interpret=True)
    got = torch.tensor(xv)
    out = tp.fs1_predict_multi_plain(got, _seed(1, 2), torch.tensor(ctl),
                                     Q_DIAG, wheelbase=WHEELBASE, dt=DT,
                                     add_noise=False)
    assert out is got                       # in place, as the kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_k6_twin_noise_off_matches_jax():
    _check_k6_twin_noise_off_against_jax(8)


@pytest.mark.parametrize("T", [3, 11])
def test_k6_twin_noise_off_matches_jax_at_other_tick_counts(T):
    """T = 8 is the superstep's tick count; the wrapper and the CUDA
    kernel's tick loop take any T."""
    _check_k6_twin_noise_off_against_jax(T)


def test_k6_twin_noise_moments():
    """One tick from the origin: x = V dt cos G, y = V dt sin G, so each
    particle's (V, G) is read back from its pose. Their mean and
    covariance must match (vn, gn) and Q within 4 standard errors."""
    P = 2 ** 16
    Q = np.array([[0.09, 0.006], [0.006, 0.0025]], np.float32)
    vn, gn = 3.0, 0.1
    xv = torch.zeros((3, P))
    tp.fs1_predict_multi_plain(xv, _seed(12345, -999),
                               torch.tensor([[vn, gn]]), Q,
                               wheelbase=WHEELBASE, dt=DT)
    x, y = xv[0].double().numpy(), xv[1].double().numpy()
    V, G = np.hypot(x, y) / DT, np.arctan2(y, x)
    q = Q.astype(np.float64)
    se = np.sqrt(np.diag(q) / P)
    assert abs(V.mean() - vn) < 4 * se[0]
    assert abs(G.mean() - gn) < 4 * se[1]
    C = np.cov(np.stack([V, G]))
    se_var = np.sqrt(2.0 / (P - 1)) * np.diag(q)
    se_cov = math.sqrt((q[0, 0] * q[1, 1] + q[0, 1] ** 2) / P)
    assert abs(C[0, 0] - q[0, 0]) < 4 * se_var[0]
    assert abs(C[1, 1] - q[1, 1]) < 4 * se_var[1]
    assert abs(C[0, 1] - q[0, 1]) < 4 * se_cov


def test_k6_seed_fixes_the_stream():
    P, T = 2048, 8
    ctl = torch.tensor(_controls(T))
    xv0 = torch.tensor(np.random.default_rng(1).normal(size=(3, P))
                       .astype(np.float32))

    def run(seed):
        return tp.fs1_predict_multi_plain(xv0.clone(), seed, ctl, Q_DIAG,
                                          wheelbase=WHEELBASE, dt=DT)

    a, b = run(_seed(5, 6)), run(_seed(5, 6))
    assert torch.equal(a, b)
    for other in (_seed(5, 7), _seed(6, 6)):
        c = run(other)
        assert float((c[0] != a[0]).float().mean()) > 0.99


def test_k6_wrapper_runs_the_twin_on_cpu():
    tk.reset_launch_counts()
    P, T = 1024, 8
    ctl = torch.tensor(_controls(T))
    xv = torch.tensor(np.random.default_rng(2).normal(size=(3, P))
                      .astype(np.float32))
    want = tp.fs1_predict_multi_plain(xv.clone(), _seed(3, 4), ctl, Q_DIAG,
                                      wheelbase=WHEELBASE, dt=DT)
    got = tk.fs1_predict_multi(xv, _seed(3, 4), ctl, Q_DIAG,
                               wheelbase=WHEELBASE, dt=DT)
    assert got is xv and torch.equal(got, want)
    assert tk.launch_counts()["K6"] == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("add_noise", [True, False], ids=["noise", "nominal"])
def test_k6_kernel_matches_twin_on_card(cuda, add_noise):
    """Draw for draw: the same Philox words, so only the device libm's
    rounding of log, sin and cos separates the two. Headings are
    compared wrapped: one ulp at +-pi flips a wrapped value by 2 pi."""
    P, T = 100_000, 8
    xv = torch.tensor(np.random.default_rng(4).normal(size=(3, P))
                      .astype(np.float32), device=cuda)
    ctl = torch.tensor(_controls(T), device=cuda)
    seed = torch.tensor([-123, 456], dtype=torch.int32, device=cuda)
    kw = dict(wheelbase=WHEELBASE, dt=DT, add_noise=add_noise)
    before = tk.fs1_predict_multi.launches
    got = tk.fs1_predict_multi(xv.clone(), seed, ctl, Q_DIAG, **kw)
    assert tk.fs1_predict_multi.launches == before + 1
    want = tp.fs1_predict_multi_plain(xv.clone(), seed, ctl, Q_DIAG, **kw)
    torch.testing.assert_close(got[:2], want[:2], **TOL)
    dth = wrap_angle(got[2] - want[2])
    torch.testing.assert_close(dth, torch.zeros_like(dth), **TOL)


# T = 8 is the superstep's; 5 and 11 are no multiple of the tick
# loop's unrolling (4), 300 takes two launches (256 ticks each at most);
# 2^20 + 37 leaves the last block ragged.
CARD_SHAPES = [(8, 2 ** 20), (8, 2 ** 20 + 37), (5, 2 ** 20 + 37),
               (11, 1000), (300, 4133)]


@pytest.mark.cuda
@pytest.mark.parametrize("add_noise", [True, False], ids=["noise", "nominal"])
@pytest.mark.parametrize("T,P", CARD_SHAPES)
def test_k6_kernel_is_bit_equal_to_twin_on_card(cuda, T, P, add_noise):
    """The kernel keeps the twin's operation order, and its sincosf and
    fast wrap return the bits of what they replace (the sweep below), so
    nothing separates the two."""
    xv = torch.tensor(np.random.default_rng(6).normal(size=(3, P))
                      .astype(np.float32) * [[1.0], [1.0], [2.0]],
                      dtype=torch.float32, device=cuda)
    ctl = torch.tensor(_controls(T), device=cuda)
    seed = torch.tensor([-123, 456], dtype=torch.int32, device=cuda)
    kw = dict(wheelbase=WHEELBASE, dt=DT, add_noise=add_noise)
    got = tk.fs1_predict_multi(xv.clone(), seed, ctl, Q_DIAG, **kw)
    want = tp.fs1_predict_multi_plain(xv.clone(), seed, ctl, Q_DIAG, **kw)
    assert torch.isfinite(got).all() and not torch.equal(got, xv)
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
def test_fast_math_sweep_finds_no_mismatch_on_card(cuda):
    """sincosf against sinf and cosf, wrap_angle_fast against wrap_angle,
    on all 2^32 float32 bit patterns."""
    sweep = tp.fast_math_sweep(cuda)
    assert sweep == dict(sin_mismatches=0, cos_mismatches=0,
                         wrap_mismatches=0, first_trig=None,
                         first_wrap=None), sweep


def test_fast_math_sweep_needs_the_card():
    with pytest.raises(ValueError, match="CUDA device"):
        tp.fast_math_sweep("cpu")
