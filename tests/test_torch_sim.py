"""The port's simulator (slam_tpu_torch.sim) against the JAX package's on
data/ring40, with the noise off, and with the JAX package's own normal
draws injected into the port.

Tolerance: rtol 1e-5, atol 1e-5 on poses and observations, the
float32 rounding of the bicycle step accumulated over the ticks
compared (torch.atan2 and jnp.arctan2 may differ by an ulp, and the
error carries from tick to tick); ids, masks, counts, waypoint indices
and done flags exactly."""

import os

import jax
import numpy as np
import pytest
import torch

from slam_tpu.config import SlamConfig
from slam_tpu.maps import read_map_file
from slam_tpu.sim import simulator as jsim
from slam_tpu_torch.sim import simulator as tsim

DATA = os.path.join(os.path.dirname(__file__), os.pardir, "data")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ring40():
    cfg = SlamConfig.from_ini(os.path.join(DATA, "ring40.ini"))
    return cfg, read_map_file(os.path.join(DATA, "ring40.mat"))


def _assert_vehicle(tv, jv):
    np.testing.assert_allclose(tv.pose.numpy(), np.asarray(jv.pose), **TOL)
    np.testing.assert_allclose(float(tv.steer), float(jv.steer), **TOL)
    assert int(tv.waypoint) == int(jv.waypoint)
    assert int(tv.loops) == int(jv.loops)
    assert bool(tv.done) == bool(jv.done)


def _assert_obs(to, jo):
    np.testing.assert_array_equal(to.mask.numpy(), np.asarray(jo.mask))
    np.testing.assert_array_equal(to.ids.numpy()[to.mask.numpy()],
                                  np.asarray(jo.ids)[np.asarray(jo.mask)])
    assert int(to.count) == int(jo.count)
    np.testing.assert_allclose(to.z.numpy(), np.asarray(jo.z), **TOL)


@pytest.mark.parametrize("noise", ["off", "injected"])
def test_control_and_observe_steps_match_jax(ring40, noise):
    cfg, slam_map = ring40
    if noise == "off":
        cfg = cfg.replace(SWITCH_CONTROL_NOISE=0, SWITCH_SENSOR_NOISE=0)
    js, ts = jsim.Simulator(cfg, slam_map), tsim.Simulator(cfg, slam_map)
    assert ts.max_obs == js.max_obs
    jstate, tstate = js.init(seed=3), ts.init(seed=3)
    jcontrol, jobserve = jax.jit(js.control_step), jax.jit(js.observe_step)
    for tick in range(1, 161):
        # The normals JAX's control_step draws: split, then normal(sub).
        _, sub = jax.random.split(jstate.key)
        eps = torch.tensor(np.asarray(jax.random.normal(sub, (2,))))
        jstate, jc = jcontrol(jstate)
        tstate, tc = ts.control_step(tstate, noise=eps)
        _assert_vehicle(tstate.vehicle, jstate.vehicle)
        np.testing.assert_allclose(float(tc.v_noisy), float(jc.v_noisy),
                                   **TOL)
        np.testing.assert_allclose(float(tc.g_noisy), float(jc.g_noisy),
                                   **TOL)
        if tick % cfg.steps_per_observe == 0:
            _, sub = jax.random.split(jstate.key)
            eps = torch.tensor(np.asarray(
                jax.random.normal(sub, (js.max_obs, 2))))
            jstate, jo = jobserve(jstate)
            tstate, to = ts.observe_step(tstate, noise=eps)
            _assert_obs(to, jo)
    assert tstate.tick == int(jstate.tick)


def test_rollout_controls_matches_jax(ring40):
    cfg, slam_map = ring40
    cfg = cfg.replace(SWITCH_CONTROL_NOISE=0, NUMBER_LOOPS=1)
    js, ts = jsim.Simulator(cfg, slam_map), tsim.Simulator(cfg, slam_map)
    n = 600
    _, jposes, jdones = jax.jit(js.rollout_controls,
                                static_argnums=1)(js.init(seed=1), n)
    _, tposes, tdones = ts.rollout_controls(ts.init(seed=1), n)
    np.testing.assert_allclose(tposes.numpy(), np.asarray(jposes), **TOL)
    np.testing.assert_array_equal(tdones.numpy(), np.asarray(jdones))


def test_default_max_obs_matches_jax(ring40):
    cfg, slam_map = ring40
    dense = read_map_file(os.path.join(DATA, "dense200.mat"))
    for m in (slam_map, dense):
        for r in (cfg.MAX_RANGE, 10.0, 60.0):
            assert tsim._default_max_obs(m, r) == jsim._default_max_obs(m, r)


def test_heading_measurement_is_truth_plus_scaled_uniform(ring40):
    cfg, slam_map = ring40
    ts = tsim.Simulator(cfg, slam_map)
    state, _ = ts.control_step(ts.init(seed=2))
    _, phi = ts.heading_measurement(state, u=torch.tensor(0.25))
    np.testing.assert_allclose(
        float(phi), float(state.vehicle.pose[2]) + cfg.sigmaT * 0.25,
        rtol=1e-6)
