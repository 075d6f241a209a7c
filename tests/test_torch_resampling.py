"""The port's resampling (slam_tpu_torch.ops.resampling) against the JAX
package's.

The stratified dither is threefry ``fold_in`` in JAX, which torch cannot
reproduce, and the JAX prefix sum rounds differently from
``torch.cumsum``. So the discrete outputs (offspring bounds, ancestors)
are compared bit for bit given JAX's csum and U = _uniform_at(key,
arange(P)); the float outputs (normalized weights, Neff) at rtol 1e-6,
the rounding of a logsumexp over P terms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.ops import resampling as jrs
from slam_tpu_torch.ops import resampling as trs
from slam_tpu_torch.ops.kernels import bounds as tbounds


def _logw(P, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return np.full(P, -np.log(P), np.float32)
    if kind == "collapsed":
        lw = np.full(P, -60.0, np.float32)
        lw[rng.integers(P)] = 0.0
        return lw
    return (rng.normal(size=P) * 3.0).astype(np.float32)


def _jax_draws(logw, key):
    """JAX's stratified csum (stratified_indices' own) and dither."""
    P = logw.shape[0]
    csum = np.asarray(jrs._cumsum_2d(jnp.exp(jrs.normalize_log_weights(
        jnp.asarray(logw)))))
    U = np.asarray(jrs._uniform_at(key, jnp.arange(P, dtype=jnp.int32)))
    return csum, torch.tensor(U)


CASES = [(P, kind) for P in (300, 2048)
         for kind in ("random", "uniform", "collapsed")]


@pytest.mark.parametrize("P,kind", CASES)
def test_offspring_bounds_and_ancestors_bit_exact(P, kind):
    key = jax.random.PRNGKey(P)
    csum, U = _jax_draws(_logw(P, kind), key)
    want_S = np.asarray(jrs.offspring_bounds(key, jnp.asarray(csum), P))
    got_S = trs.offspring_bounds(torch.tensor(csum), P,
                                 lambda pos: U[pos])
    assert got_S.dtype == torch.int32
    np.testing.assert_array_equal(got_S.numpy(), want_S)

    want_A = np.asarray(jrs.ancestors_from_bounds(jnp.asarray(want_S), P))
    got_A = trs.ancestors_from_bounds(torch.tensor(want_S), P)
    np.testing.assert_array_equal(got_A.numpy(), want_A)


@pytest.mark.parametrize("P,kind", CASES)
def test_stratified_indices_bit_exact(P, kind, monkeypatch):
    key = jax.random.PRNGKey(7 * P)
    logw = _logw(P, kind, seed=1)
    csum, U = _jax_draws(logw, key)
    monkeypatch.setattr(trs, "cumulative_weights",
                        lambda logw_n: torch.tensor(csum))
    got = trs.stratified_indices(torch.tensor(logw), lambda pos: U[pos])
    want = np.asarray(jrs.stratified_indices(key, jnp.asarray(logw)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(np.diff(got.numpy()) >= 0)


def test_offspring_bounds_cummax_guard():
    """A prefix sum that dips by an ulp (the JAX blocked cumsum does at
    block edges) still gives a non-decreasing partition, equal to
    JAX's."""
    P = 64
    csum = np.cumsum(np.full(P, 1.0 / P, np.float32)).astype(np.float32)
    csum[20] = np.nextafter(csum[19], np.float32(0))   # dip below csum[19]
    key = jax.random.PRNGKey(3)
    U = np.asarray(jrs._uniform_at(key, jnp.arange(P, dtype=jnp.int32)))
    want = np.asarray(jrs.offspring_bounds(key, jnp.asarray(csum), P))
    got = trs.offspring_bounds(torch.tensor(csum), P,
                               lambda pos: torch.tensor(U)[pos])
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(np.diff(got.numpy()) >= 0) and got[-1] == P


def _guard_case():
    """test_offspring_bounds_cummax_guard's prefix sum and dither."""
    P = 64
    csum = np.cumsum(np.full(P, 1.0 / P, np.float32)).astype(np.float32)
    csum[20] = np.nextafter(csum[19], np.float32(0))
    U = jrs._uniform_at(jax.random.PRNGKey(3), jnp.arange(P, dtype=jnp.int32))
    return csum, torch.tensor(np.asarray(U))


@pytest.mark.parametrize("case", [*CASES, "guard"])
def test_r1_cpu_path_is_the_eager_form_on_jax_draws(case):
    """R1's wrapper on a CPU tensor, with JAX's dither as a bare callable
    and as a table: the eager form's bounds, which are JAX's."""
    if case == "guard":
        csum, U = _guard_case()
        key = jax.random.PRNGKey(3)
    else:
        P, kind = case
        key = jax.random.PRNGKey(P)
        csum, U = _jax_draws(_logw(P, kind), key)
    P = csum.shape[0]
    want = np.asarray(jrs.offspring_bounds(key, jnp.asarray(csum), P))
    c = torch.tensor(csum)
    eager = trs.offspring_bounds_plain(c, P, lambda pos: U[pos])
    np.testing.assert_array_equal(eager.numpy(), want)
    for dither in (lambda pos: U[pos], trs.DitherTable(U)):
        got = tbounds.offspring_bounds(c, P, dither)
        assert torch.equal(got, eager)


@pytest.mark.parametrize("kind", ["random", "uniform", "collapsed"])
def test_normalize_and_neff_match_jax(kind):
    logw = _logw(1000, kind, seed=2)
    np.testing.assert_allclose(
        trs.normalize_log_weights(torch.tensor(logw)).numpy(),
        np.asarray(jrs.normalize_log_weights(jnp.asarray(logw))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        float(trs.effective_particles(torch.tensor(logw))),
        float(jrs.effective_particles(jnp.asarray(logw))), rtol=1e-6)


@pytest.mark.parametrize("n", [700, 1024, 5000, 1024 * 1024 + 3])
def test_cumulative_weights_blocked_prefix_sum(n):
    """The row-blocked prefix sum agrees with a float64 cumsum to
    float32 rounding (atol 1e-6 on a sum that ends at 1) and ends at the
    total."""
    logw = _logw(n, "random", seed=4)
    logw_n = trs.normalize_log_weights(torch.tensor(logw))
    got = trs.cumulative_weights(logw_n).numpy()
    want = np.cumsum(np.exp(logw_n.numpy().astype(np.float64)))
    assert got.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.all(np.diff(got) >= -1e-7)


def test_uniform_from_generator_is_a_function_of_position():
    g = torch.Generator().manual_seed(0)
    u = trs.uniform_from_generator(50, g)
    pos = torch.tensor([3, 7, 3, 49, 0])
    a = u(pos)
    assert a[0] == a[2] and torch.all((a >= 0) & (a < 1))
    np.testing.assert_array_equal(u(pos).numpy(), a.numpy())


# The cases of tests/test_ops.py's resample_particles tests (uniform
# weights: the gate holds; one dominant particle: it fires; resampling
# off), and random weights with a fired gate.
RESAMPLE_CASES = {
    "holds": (np.zeros(8, np.float32), 6.0, True),
    "fires": (np.array([0.0] + [-40.0] * 7, np.float32), 6.0, True),
    "disabled": (np.array([0.0] + [-40.0] * 7, np.float32), 6.0, False),
    "random": (_logw(300, "random", seed=5), 300.0, True),
}


@pytest.mark.parametrize("case", list(RESAMPLE_CASES))
def test_resample_particles_matches_jax(case, monkeypatch):
    """The port's resample_particles on JAX's dither (and prefix sum)
    against JAX's: ancestors and the decision exactly, weights at rtol
    1e-6."""
    logw, n_min, on = RESAMPLE_CASES[case]
    key = jax.random.PRNGKey(0)
    idx, new_logw, did = jrs.resample_particles(key, jnp.asarray(logw),
                                                n_min=n_min, do_resample=on)
    logw_n = np.asarray(jrs.normalize_log_weights(jnp.asarray(logw)))
    csum, U = _jax_draws(logw_n, key)
    monkeypatch.setattr(trs, "cumulative_weights",
                        lambda _: torch.tensor(csum))
    t_idx, t_logw, t_did = trs.resample_particles(
        lambda pos: U[pos], torch.tensor(logw), n_min, do_resample=on)
    assert bool(t_did) == bool(did) == (case in ("fires", "random"))
    assert t_idx.dtype == torch.int32
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(t_logw.numpy(), np.asarray(new_logw),
                               rtol=1e-6)
