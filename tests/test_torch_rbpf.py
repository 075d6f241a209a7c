"""The port's particle state and filter building blocks
(slam_tpu_torch.models.particles, rbpf) against the JAX package's.

Tolerance: float plane math at rtol 1e-6, atol 1e-6 (a few float32
operations), the Jacobian and EKF chain at rtol 1e-5, atol 1e-5 (some
thirty); index bookkeeping, gathers and indexed writes exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.models import particles as jparticles
from slam_tpu.models import rbpf as jrbpf
from slam_tpu_torch.models import particles as tparticles
from slam_tpu_torch.models import rbpf as trbpf

TOL = dict(rtol=1e-6, atol=1e-6)


def _state(P=40, L=8, n_map=12, seed=0):
    rng = np.random.default_rng(seed)
    table = -np.ones(n_map, np.int32)
    table[[1, 4, 6, 9]] = [2, 0, 3, 1]
    arrays = dict(
        logw=(rng.normal(size=P) - np.log(P)).astype(np.float32),
        xv=rng.normal(size=(3, P)).astype(np.float32),
        Pv=np.abs(rng.normal(size=(6, P))).astype(np.float32) * 0.01,
        lm=rng.normal(size=(2, L, P)).astype(np.float32) * 5,
        lm_P=np.abs(rng.normal(size=(3, L, P))).astype(np.float32) * 0.1,
        n=np.int32(4), da_table=table)
    return arrays, jparticles.ParticleState(
        **{k: jnp.asarray(v) for k, v in arrays.items()})


def test_init_particles_matches_jax():
    want = jparticles.init_particles(37, 16, 21)
    got = tparticles.init_particles(37, 16, 21, device="cpu")
    for f in tparticles.FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("mode", ["mean", "median", "weighted"])
def test_estimate_position_matches_jax(mode):
    arrays, jstate = _state()
    tstate = tparticles.state_from_numpy(arrays, device="cpu")
    np.testing.assert_allclose(
        tparticles.estimate_position(tstate, mode).numpy(),
        np.asarray(jparticles.estimate_position(jstate, mode)), **TOL)


def test_estimate_position_heading_tie_takes_first_particle():
    arrays, _ = _state()
    arrays["logw"][:] = -np.log(40)
    tstate = tparticles.state_from_numpy(arrays, device="cpu")
    assert float(tparticles.estimate_position(tstate)[2]) == \
        arrays["xv"][2, 0]


def test_pack_unpack_round_trip():
    arrays, jstate = _state()
    tstate = tparticles.state_from_numpy(arrays, device="cpu")
    flat = tparticles.pack_particle_planes(tstate)
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(jparticles.pack_particle_planes(jstate)))
    back = tparticles.unpack_particle_planes(tstate, flat)
    for f in ("logw", "xv", "Pv", "lm", "lm_P"):
        assert torch.equal(getattr(back, f), getattr(tstate, f)), f


def test_gathers_match_jax():
    arrays, jstate = _state()
    tstate = tparticles.state_from_numpy(arrays, device="cpu")
    idx = np.sort(np.random.default_rng(1).integers(0, 40, 40)).astype(
        np.int32)
    want = jparticles.gather_particles(jstate, jnp.asarray(idx))
    got = tparticles.gather_particles(tstate, torch.tensor(idx))
    # The bounds form of the same ancestors: S_g = #{j : idx_j <= g}.
    S = np.searchsorted(idx, np.arange(40), side="right").astype(np.int32)
    got_b = tparticles.gather_particles_bounds(tstate, torch.tensor(S))
    for f in ("logw", "xv", "Pv", "lm", "lm_P"):
        w = np.asarray(getattr(want, f))
        np.testing.assert_array_equal(getattr(got, f).numpy(), w, f)
        np.testing.assert_array_equal(getattr(got_b, f).numpy(), w, f)


def test_observe_heading_particles_matches_jax():
    arrays, jstate = _state(seed=2)
    tstate = tparticles.state_from_numpy(arrays, device="cpu")
    want = jrbpf.observe_heading_particles(jstate, jnp.float32(0.3), 0.02)
    got = trbpf.observe_heading_particles(tstate, torch.tensor(0.3), 0.02)
    np.testing.assert_allclose(got.xv.numpy(), np.asarray(want.xv), **TOL)
    np.testing.assert_allclose(got.Pv.numpy(), np.asarray(want.Pv), **TOL)
    # At Pv == 0 the gain is zero: x, y and Pv stay as they are, and the
    # heading only goes through one more wrap (a rounding, no more).
    arrays["Pv"][:] = 0.0
    zero = tparticles.state_from_numpy(arrays, device="cpu")
    got0 = trbpf.observe_heading_particles(zero, torch.tensor(0.3), 0.02)
    assert torch.equal(got0.xv[:2], zero.xv[:2])
    assert torch.equal(got0.Pv, zero.Pv)
    np.testing.assert_allclose(got0.xv[2].numpy(), zero.xv[2].numpy(),
                               rtol=0, atol=1e-6)


def test_sample_controls_noise_off_and_moments():
    g = torch.Generator().manual_seed(0)
    Q = np.diag([0.09, 0.0027]).astype(np.float32)
    vn, gn = torch.tensor(3.0), torch.tensor(0.1)
    V, G = trbpf.sample_controls(vn, gn, Q, 8, g, add_noise=False)
    assert torch.all(V == 3.0) and torch.all(G == gn)
    V, G = trbpf.sample_controls(vn, gn, Q, 200_000, g)
    np.testing.assert_allclose([float(V.mean()), float(G.mean())],
                               [3.0, 0.1], atol=3e-3)
    np.testing.assert_allclose([float(V.std()), float(G.std())],
                               np.sqrt(np.diag(Q)), rtol=1e-2)
    np.testing.assert_allclose(trbpf.control_noise_factor(Q),
                               [np.sqrt(Q[0, 0]), 0.0, np.sqrt(Q[1, 1])],
                               rtol=1e-6)


def test_associate_and_new_slots_match_jax():
    arrays, jstate = _state()
    tstate = tparticles.state_from_numpy(arrays, device="cpu")
    ids = np.array([4, 5, 9, 11, 2, 7], np.int32)
    zmask = np.array([True, True, True, True, False, True])
    ja, jn = jrbpf.associate_known(jstate, jnp.asarray(ids),
                                   jnp.asarray(zmask))
    ta, tn = trbpf.associate_known(tstate, torch.tensor(ids),
                                   torch.tensor(zmask))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    slot_new, ok = trbpf.new_slots(tstate, tn)
    # New ids 5, 11, 7 take slots 4, 5, 6 (capacity 8).
    np.testing.assert_array_equal(slot_new.numpy()[tn.numpy()], [4, 5, 6])
    assert ok.tolist() == tn.tolist()


@pytest.mark.parametrize("case", ["plain", "duplicates"])
def test_scatter_slots_matches_jax(case):
    arrays, _ = _state()
    planes = arrays["lm"]
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(2, 4, planes.shape[2])).astype(np.float32)
    if case == "plain":
        tgt, valid = [1, 5, 2, 7], [True, True, False, True]
    else:  # masked entries parked on a slot that a valid entry writes
        tgt, valid = [0, 0, 3, 0], [False, True, True, False]
    tgt, valid = np.array(tgt, np.int32), np.array(valid)
    want = jrbpf.scatter_slots(jnp.asarray(planes), jnp.asarray(tgt),
                               jnp.asarray(vals), jnp.asarray(valid))
    got = torch.tensor(planes)
    trbpf.scatter_slots(got, torch.tensor(tgt), torch.tensor(vals),
                        torch.tensor(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_set_table_drops_masked_and_out_of_range_ids():
    table = torch.full((6,), -1, dtype=torch.int32)
    trbpf.set_table(table, torch.tensor([2, 2, 9, 4], dtype=torch.int32),
                    torch.tensor([7, 8, 9, 10], dtype=torch.int32),
                    torch.tensor([False, True, True, True]))
    assert table.tolist() == [-1, -1, 8, -1, 10, -1]


def test_add_new_features_matches_jax():
    arrays, jstate = _state(P=40, L=8)
    tstate = tparticles.state_from_numpy(arrays, device="cpu")
    R = np.diag([0.01, 0.0003]).astype(np.float32)
    z = np.array([[5.0, 0.3], [4.0, -0.2], [7.0, 0.9], [3.0, 0.1]],
                 np.float32)
    ids = np.array([5, 4, 11, 0], np.int32)   # 5, 11, 0 new; 4 known
    is_new = np.array([True, False, True, True])
    want = jrbpf.add_new_features(jstate, jnp.asarray(z), jnp.asarray(ids),
                                  jnp.asarray(is_new), jnp.asarray(R))
    got = trbpf.add_new_features(tstate, torch.tensor(z), torch.tensor(ids),
                                 torch.tensor(is_new), R)
    np.testing.assert_allclose(got.lm.numpy(), np.asarray(want.lm), **TOL)
    np.testing.assert_allclose(got.lm_P.numpy(), np.asarray(want.lm_P),
                               **TOL)
    assert int(got.n) == int(want.n) == 7
    np.testing.assert_array_equal(got.da_table.numpy(),
                                  np.asarray(want.da_table))


def test_observe_planes_and_matched_update_match_jax():
    arrays, jstate = _state(seed=4)
    tstate = tparticles.state_from_numpy(arrays, device="cpu")
    R = np.diag([0.01, 0.0003]).astype(np.float32)
    z = np.array([[5.0, 0.3], [4.0, -0.2], [6.0, 1.0]], np.float32)
    slot = np.array([2, 0, 3], np.int32)
    matched = np.array([True, False, True])
    jJ, jv0, jv1 = jrbpf.observe_planes(jstate, jnp.asarray(z),
                                        jnp.asarray(slot), jnp.asarray(R))
    tJ, tv0, tv1 = trbpf.observe_planes(tstate, torch.tensor(z),
                                        torch.tensor(slot), R)
    for name, g, w in zip(tJ._fields + ("v0", "v1"), (*tJ, tv0, tv1),
                          (*jJ, jv0, jv1)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    want = jrbpf.update_matched_features(jstate, jnp.asarray(slot),
                                         jnp.asarray(matched), jv0, jv1,
                                         jJ)
    got = trbpf.update_matched_features(tstate, torch.tensor(slot),
                                        torch.tensor(matched), tv0, tv1,
                                        tJ)
    np.testing.assert_allclose(got.lm.numpy(), np.asarray(want.lm),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.lm_P.numpy(), np.asarray(want.lm_P),
                               rtol=1e-5, atol=1e-5)
