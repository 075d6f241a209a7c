"""The port's EKF-SLAM (slam_tpu_torch.models.ekf) against the JAX
package's (slam_tpu.models.ekf), on the CPU.

Each function of the module runs on the same injected state in both
packages (the scenarios of tests/test_models.py:41-198, and the edges:
capacity overflow, a row of the association with no live landmark,
masked observations between new ones). Float outputs are held at the
stated float32 tolerances; ``assoc``, ``is_new``, ``n`` and ``da_table``
exactly.

Then both packages' ``EkfSlam`` are driven for 160 supersteps of
data/ring40 on one stream of noisy controls, IMU headings and
observations made by the port's simulator from a seed: association known
and unknown, heading known and unknown. The EKF draws no random numbers,
so the two runs see the same inputs throughout."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu import config as jconfig
from slam_tpu.models import ekf as jekf
from slam_tpu_torch import config as tconfig
from slam_tpu_torch import maps as tmaps
from slam_tpu_torch.models import ekf as tekf
from slam_tpu_torch.sim.simulator import Simulator

DATA = os.path.join(os.path.dirname(__file__), os.pardir, "data")
R = np.diag([0.01, 0.0003]).astype(np.float32)
Q = np.diag([0.09, 0.003]).astype(np.float32)
# Float32 tolerances of one step (a few roundings of O(1) values, and of
# the products' other summation order).
TOL = dict(rtol=1e-5, atol=2e-6)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's products here are tiny: one thread is faster, and it
    does not compete with the JAX side's thread pool in this process
    (with torch's default threads a drive took 16 s, not 3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(lms=(), P_diag=0.05, n_map=10, capacity=5, seed=None):
    """Numpy EKF state arrays: the given landmark means with a diagonal
    covariance, or (``seed``) a random PSD joint covariance and pose
    over them."""
    N = 3 + 2 * capacity
    x = np.zeros(N, np.float32)
    P = np.zeros((N, N), np.float32)
    lms = np.asarray(lms, np.float32).reshape(-1, 2)
    k = len(lms)
    x[3:3 + 2 * k] = lms.reshape(-1)
    P[3:3 + 2 * k, 3:3 + 2 * k] = np.eye(2 * k) * P_diag
    if seed is not None:
        rng = np.random.default_rng(seed)
        A = rng.normal(size=(3 + 2 * k, 3 + 2 * k)).astype(np.float32)
        P[:3 + 2 * k, :3 + 2 * k] = 0.01 * A @ A.T + 0.02 * np.eye(3 + 2 * k)
        x[:3] = rng.normal(size=3) * [1.0, 1.0, 0.5]
    table = np.full(n_map, -1, np.int32)
    table[:k] = np.arange(k)
    return dict(x=x, P=P, n=np.int32(k), da_table=table)


def _states(arrays):
    """(JAX EKFState, port EKFState) from the same arrays."""
    j = jekf.EKFState(x=jnp.asarray(arrays["x"]), P=jnp.asarray(arrays["P"]),
                      n=jnp.int32(arrays["n"]),
                      da_table=jnp.asarray(arrays["da_table"]))
    return j, tekf.ekf_state_from_numpy(arrays, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def assert_state_matches(jstate, tstate, tol=TOL):
    """x and P within ``tol``; n and da_table exactly."""
    np.testing.assert_allclose(tstate.x.numpy(), np.asarray(jstate.x), **tol)
    np.testing.assert_allclose(tstate.P.numpy(), np.asarray(jstate.P), **tol)
    assert int(tstate.n) == int(jstate.n)
    np.testing.assert_array_equal(tstate.da_table.numpy(),
                                  np.asarray(jstate.da_table))


# --- predict and heading ---------------------------------------------------

@pytest.mark.parametrize("seed", [None, 3])
def test_predict_matches_jax(seed):
    """Zero state, and a random joint covariance with cross terms (the
    landmark blocks must stay as they were)."""
    arrays = _arrays([[5.0, 1.0], [2.0, -3.0]], capacity=4, seed=seed)
    js, ts = _states(arrays)
    j1 = jekf.ekf_predict(js, 1.0, 0.1, Q, wheelbase=2.0, dt=0.025)
    t1 = tekf.ekf_predict(ts, _t(np.float32(1.0)), _t(np.float32(0.1)),
                          _t(Q), 2.0, 0.025)
    assert_state_matches(j1, t1)
    P1 = t1.P.numpy()
    np.testing.assert_array_equal(P1[3:, 3:], arrays["P"][3:, 3:])
    np.testing.assert_allclose(P1, P1.T, atol=1e-7)


@pytest.mark.parametrize("phi", [0.5, 3.1])
def test_observe_heading_matches_jax(phi):
    """The Joseph update, here on a random joint covariance and across
    the wrap at pi."""
    arrays = _arrays([[5.0, 1.0]], capacity=3, seed=4)
    arrays["x"][2] = -3.1
    js, ts = _states(arrays)
    j1 = jekf.ekf_observe_heading(js, jnp.float32(phi), 0.0174)
    t1 = tekf.ekf_observe_heading(ts, _t(np.float32(phi)), 0.0174)
    assert_state_matches(j1, t1)


# --- association -----------------------------------------------------------

ASSOC_CASES = {
    # tests/test_models.py: a match near landmark 0 and a far new one.
    "near-and-far": (dict(lms=[[5.0, 0.0], [0.0, 5.0]]),
                     [[5.0, 0.0], [8.0, 2.0]], [True, True]),
    "masked": (dict(lms=[[5.0, 0.0]]), [[5.0, 0.0]], [False]),
    # No live landmark: every row of the statistics is +inf.
    "no-live-landmark": (dict(lms=[]), [[5.0, 0.0], [3.0, 1.0],
                                        [0.0, 0.0]], [True, True, False]),
    # A random joint covariance, masked observations among live ones.
    "random": (dict(lms=[[5.0, 0.5], [4.0, -2.0], [9.0, 3.0], [6.0, 0.0]],
                    capacity=6, seed=5),
               [[5.1, 0.1], [4.4, -0.45], [9.5, 0.32], [20.0, 1.0],
                [6.0, 0.0], [4.5, -0.4]],
               [True, True, True, True, False, True]),
}


@pytest.mark.parametrize("name", ASSOC_CASES)
def test_associate_matches_jax(name):
    kw, z, mask = ASSOC_CASES[name]
    js, ts = _states(_arrays(**kw))
    z = np.asarray(z, np.float32)
    mask = np.asarray(mask)
    j_nis, j_nd = jekf._innovation_stats(js, jnp.asarray(z),
                                         jnp.asarray(mask), R)
    t_nis, t_nd = tekf._innovation_stats(ts, _t(z), _t(mask), _t(R))
    np.testing.assert_allclose(t_nis.numpy(), np.asarray(j_nis), rtol=1e-4)
    np.testing.assert_allclose(t_nd.numpy(), np.asarray(j_nd), rtol=1e-4,
                               atol=1e-5)
    ja, jn = jekf.ekf_data_associate(js, jnp.asarray(z), jnp.asarray(mask),
                                     R, 4.0, 25.0)
    ta, tn = tekf.ekf_data_associate(ts, _t(z), _t(mask), _t(R), 4.0, 25.0)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert ta.dtype == torch.int32 and tn.dtype == torch.bool
    if name == "no-live-landmark":
        assert np.isinf(t_nis.numpy()).all()
        np.testing.assert_array_equal(ta.numpy(), [-1, -1, -1])
        np.testing.assert_array_equal(tn.numpy(), [True, True, False])
    if name == "near-and-far":
        np.testing.assert_array_equal(ta.numpy(), [0, -1])


def test_associate_known_matches_jax():
    js, ts = _states(_arrays([[5.0, 0.0], [0.0, 5.0]]))
    ids = np.array([1, 7, 0, 12, -3], np.int32)    # 7 unseen, two outside
    mask = np.array([True, True, True, True, False])
    ja, jn = jekf.ekf_data_associate_known(js, jnp.asarray(ids),
                                           jnp.asarray(mask))
    ta, tn = tekf.ekf_data_associate_known(ts, _t(ids), _t(mask))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ta.numpy(), [1, -1, 0, -1, -1])


# --- batch update ----------------------------------------------------------

UPDATE_CASES = {
    "one-matched": ([[5.0, 0.0]], [[5.0, 0.0]], [0]),
    "unmatched-is-a-noop": ([[5.0, 0.0]], [[5.0, 0.0]], [-1]),
    # Three matched of five, one landmark observed twice.
    "mixed": ([[5.0, 0.5], [4.0, -2.0], [9.0, 3.0]],
              [[5.1, 0.1], [4.4, -0.45], [9.5, 0.32], [3.0, 1.0],
               [5.0, 0.12]], [0, 1, 2, -1, 0]),
}


@pytest.mark.parametrize("name", UPDATE_CASES)
def test_batch_update_matches_jax(name):
    lms, z, assoc = UPDATE_CASES[name]
    js, ts = _states(_arrays(lms, P_diag=0.5, seed=6))
    z = np.asarray(z, np.float32)
    assoc = np.asarray(assoc, np.int32)
    j1 = jekf.ekf_batch_update(js, jnp.asarray(z), jnp.asarray(assoc), R)
    t1 = tekf.ekf_batch_update(ts, _t(z), _t(assoc), _t(R))
    assert_state_matches(j1, t1, dict(rtol=1e-4, atol=2e-6))
    P1 = t1.P.numpy()
    np.testing.assert_allclose(P1, P1.T, atol=1e-6)
    if name == "unmatched-is-a-noop":
        np.testing.assert_allclose(t1.x.numpy(), ts.x.numpy(), atol=1e-6)
    else:
        assert np.trace(P1[:3, :3]) < np.trace(ts.P.numpy()[:3, :3])


# --- augment ---------------------------------------------------------------

AUGMENT_CASES = {
    # tests/test_models.py: two new features on an empty map.
    "two-new": ([], [[2.0, 0.0], [3.0, np.pi / 2]], [4, 6], [True, True]),
    # Capacity 5 full: the new one is dropped.
    "full": ([[1, 1], [2, 2], [3, 3], [4, 4], [5, 5]], [[2.0, 0.0]], [9],
             [True]),
    # Room for two of four; masked observations between the new ones.
    "overflow": ([[1, 1], [2, 2], [3, 3]],
                 [[2.0, 0.1], [4.0, -0.7], [3.0, 0.2], [6.0, 0.4],
                  [7.0, -0.3]], [5, 6, 7, 8, 9],
                 [True, False, True, True, True]),
}


@pytest.mark.parametrize("name", AUGMENT_CASES)
def test_augment_matches_jax(name):
    lms, z, ids, new = AUGMENT_CASES[name]
    arrays = _arrays(lms, seed=7 if lms else None)
    arrays["P"][:3, :3] = [[0.2, 0.05, 0.01], [0.05, 0.3, 0.02],
                           [0.01, 0.02, 0.04]]
    js, ts = _states(arrays)
    z = np.asarray(z, np.float32)
    ids = np.asarray(ids, np.int32)
    new = np.asarray(new)
    j1 = jekf.ekf_augment(js, jnp.asarray(z), jnp.asarray(ids),
                          jnp.asarray(new), R)
    t1 = tekf.ekf_augment(ts, _t(z), _t(ids), _t(new), _t(R))
    assert_state_matches(j1, t1)
    P1 = t1.P.numpy()
    np.testing.assert_allclose(P1, P1.T, atol=1e-6)
    expect_n = {"two-new": 2, "full": 5, "overflow": 5}[name]
    assert int(t1.n) == expect_n
    if name == "full":
        assert int(t1.da_table[9]) == -1
        np.testing.assert_array_equal(t1.P.numpy(), arrays["P"])
    if name == "overflow":
        # ids 5 and 7 took slots 3 and 4; 8 and 9 found no room, 6 was
        # masked.
        np.testing.assert_array_equal(t1.da_table.numpy()[5:],
                                      [3, -1, 4, -1, -1])


def test_augment_sequential_equivalence():
    """The port's batch augment of two features equals two single
    augments (the reference adds them one at a time)."""
    arrays = _arrays(capacity=4)
    arrays["P"][:3, :3] = [[0.2, 0.05, 0.01], [0.05, 0.3, 0.02],
                           [0.01, 0.02, 0.04]]
    arrays["x"][:3] = [1.0, -2.0, 0.3]
    z = _t(np.array([[2.0, 0.1], [4.0, -0.7]], np.float32))
    ids = _t(np.array([0, 1], np.int32))
    state = lambda: tekf.ekf_state_from_numpy(arrays, device="cpu")
    both = tekf.ekf_augment(state(), z, ids, _t(np.array([True, True])),
                            _t(R))
    one = tekf.ekf_augment(state(), z[:1], ids[:1], _t(np.array([True])),
                           _t(R))
    two = tekf.ekf_augment(one, z[1:], ids[1:], _t(np.array([True])), _t(R))
    np.testing.assert_allclose(both.x.numpy(), two.x.numpy(), atol=1e-5)
    np.testing.assert_allclose(both.P.numpy(), two.P.numpy(), atol=1e-4)
    np.testing.assert_array_equal(both.da_table.numpy(),
                                  two.da_table.numpy())


@pytest.mark.parametrize("known", [True, False])
def test_step_matches_jax(known):
    lms = [[5.0, 0.5], [4.0, -2.0], [9.0, 3.0]]
    js, ts = _states(_arrays(lms, capacity=6, seed=8))
    z = np.array([[5.1, 0.1], [4.4, -0.45], [12.0, 0.9], [3.0, -1.0],
                  [0.0, 0.0]], np.float32)
    ids = np.array([0, 1, 5, 6, 2], np.int32)
    mask = np.array([True, True, True, True, False])
    kw = dict(association_known=known, gate_reject=4.0, gate_augment=25.0)
    j1 = jekf.ekf_step(js, jnp.asarray(z), jnp.asarray(ids),
                       jnp.asarray(mask), R, R * 2, **kw)
    t1 = tekf.ekf_step(ts, _t(z), _t(ids), _t(mask), _t(R), _t(R * 2), **kw)
    assert_state_matches(j1, t1, dict(rtol=1e-4, atol=2e-6))
    assert int(t1.n) > 3                      # new features were added


def test_state_carries_over_from_numpy():
    arrays = _arrays([[5.0, 1.0]], seed=9)
    back = tekf.ekf_state_to_numpy(tekf.ekf_state_from_numpy(arrays,
                                                             device="cpu"))
    assert set(back) == set(jekf.EKFState._fields)
    for f in arrays:
        np.testing.assert_array_equal(back[f], arrays[f])


# --- same-input drive of both estimators -----------------------------------

def ring40_configs(**overrides):
    """data/ring40's config read by each package, with ``overrides``:
    (JAX config, port config, port map)."""
    ini = os.path.join(DATA, "ring40.ini")
    ov = {k: str(v) for k, v in overrides.items()}
    return (jconfig.SlamConfig.from_ini(ini, overrides=ov),
            tconfig.SlamConfig.from_ini(ini, overrides=ov),
            tmaps.read_map_file(os.path.join(DATA, "ring40.mat")))


def input_stream(cfg, slam_map, n_supersteps: int, seed: int = 3):
    """One run's estimator inputs from the port's simulator on the CPU:
    per superstep ``steps_per_observe`` (v, g, phi) control ticks with
    the noisy IMU heading, then (z, ids, mask). Numpy arrays."""
    sim = Simulator(cfg, slam_map, device="cpu")
    state = sim.init(seed=seed)
    stream = []
    for _ in range(n_supersteps):
        ticks = []
        for _ in range(cfg.steps_per_observe):
            state, ctl = sim.control_step(state)
            state, phi = sim.heading_measurement(state)
            ticks.append(np.array([float(ctl.v_noisy), float(ctl.g_noisy),
                                   float(phi)], np.float32))
        state, obs = sim.observe_step(state)
        stream.append((ticks, obs.z.numpy(), obs.ids.numpy(),
                       obs.mask.numpy()))
    return stream


def drive(jest, test, stream, on_superstep=None):
    """Feed one stream to a JAX and a port estimator: (JAX state, port
    state, [(JAX pose, port pose)] per superstep)."""
    js, ts = jest.init(), test.init()
    poses = []
    for ticks, z, ids, mask in stream:
        for v, g, phi in ticks:
            js = jest.predict(js, None, jnp.float32(v), jnp.float32(g),
                              jnp.float32(phi))
            ts = test.predict(ts, None, _t(v), _t(g), _t(phi))
        js = jest.update(js, None, jnp.asarray(z), jnp.asarray(ids),
                         jnp.asarray(mask))
        ts = test.update(ts, None, _t(z), _t(ids), _t(mask))
        poses.append((np.asarray(jest.pose(js)), test.pose(ts).numpy()))
    return js, ts, poses


# ring40's vehicle first sees a landmark at superstep 37 and has mapped
# 5-7 of them by superstep 160.
DRIVE_SUPERSTEPS = 160
# Over 1,280 predicts the two packages' float32 products sum in other
# orders. With the heading known the gaps stay near 1e-5 m; without it
# the filter amplifies them to ~2e-4 m (a few ulp of the 74 m
# coordinates) and ~2e-5 of covariance. The bounds are 5x those; a
# wrong term moves the pose by centimetres or more.
DRIVE_POSE_ATOL, DRIVE_X_ATOL, DRIVE_P_ATOL = 1e-3, 1e-3, 1e-4


@pytest.mark.parametrize("assoc_known", [1, 0])
@pytest.mark.parametrize("heading_known", [1, 0])
def test_drive_matches_jax(assoc_known, heading_known):
    jcfg, tcfg, slam_map = ring40_configs(
        SWITCH_ASSOCIATION_KNOWN=assoc_known,
        SWITCH_HEADING_KNOWN=heading_known)
    stream = input_stream(tcfg, slam_map, DRIVE_SUPERSTEPS)
    jest = jekf.EkfSlam(jcfg, slam_map.n_landmarks)
    test = tekf.EkfSlam(tcfg, slam_map.n_landmarks, device="cpu")
    js, ts, poses = drive(jest, test, stream)
    err = max(float(np.abs(jp - tp).max()) for jp, tp in poses)
    assert err < DRIVE_POSE_ATOL, err
    assert int(ts.n) == int(js.n) >= 4
    np.testing.assert_array_equal(ts.da_table.numpy(),
                                  np.asarray(js.da_table))
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0,
                               atol=DRIVE_X_ATOL)
    np.testing.assert_allclose(ts.P.numpy(), np.asarray(js.P), rtol=0,
                               atol=DRIVE_P_ATOL)
