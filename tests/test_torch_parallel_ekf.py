"""The port's landmark-sharded EKF (slam_tpu_torch.parallel.ekf) on the
CPU. On 4 gloo ranks (``torch_parallel_workers.ekf_world``) against the
JAX package's ``ShardedEkfSlam`` on ``make_mesh(4, axis="l")`` over the
forced CPU devices (tests/conftest.py):

- one stream of data/ring40 inputs, association known and unknown, with
  3 deferred columns, fewer than the 8 predicts per observe, so that
  ``fold_now`` writes every shard's rows; compared through the gathered
  ``dense_covariance``, x, n, the table and hk_n at the drive
  tolerances of test_torch_ekf.py, after the stream and with three
  heading terms pending;
- capacity padding (tests/test_parallel_ekf.py's world: 10 landmarks on
  4 ranks, 12 slots, as in JAX), run through Runner against the port's
  dense EKF at that file's tolerance;
- a mesh of one rank, bit for bit equal to no mesh.

The one-card arm, in this process:

- against the JAX package's ``ShardedEkfSlam`` on a one-device mesh,
  both driven by one stream of data/ring40 inputs (as in
  test_torch_ekf.py), compared through ``dense_covariance``, with the
  deferred heading terms pending and folded;
- against the port's dense ``EkfSlam`` through ``Runner`` on the worlds
  of tests/test_parallel_ekf.py:38-67, at that file's tolerances;
- on its ``fold_now`` arm: fewer deferred columns than predicts per
  observe.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from slam_tpu.config import SlamConfig as JSlamConfig
from slam_tpu.parallel import ekf as jpekf
from slam_tpu.parallel.mesh import make_mesh
from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.maps import synthetic_map
from slam_tpu_torch.parallel import ekf as tpekf
from slam_tpu_torch.runtime import Runner
from test_torch_ekf import (
    DRIVE_P_ATOL,
    DRIVE_POSE_ATOL,
    DRIVE_X_ATOL,
    _t,
    drive,
    input_stream,
    ring40_configs,
)

import torch_parallel_workers as tw


@pytest.fixture(autouse=True)
def one_torch_thread():
    """As in test_torch_ekf.py: tiny products, a JAX pool beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_blocks_match(js, ts):
    """The joint covariances (deferred terms folded), the means, n, the
    table and the deferred count."""
    np.testing.assert_allclose(tpekf.dense_covariance(ts).numpy(),
                               np.asarray(jpekf.dense_covariance(js)),
                               rtol=0, atol=DRIVE_P_ATOL)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0,
                               atol=DRIVE_X_ATOL)
    assert int(ts.n) == int(js.n)
    assert ts.hk_n == int(js.hk_n)
    np.testing.assert_array_equal(ts.da_table.numpy(),
                                  np.asarray(js.da_table))


@pytest.mark.parametrize("assoc_known", [1, 0])
def test_matches_jax_on_a_one_device_mesh(assoc_known):
    """120 supersteps with the heading known (the deferral at work),
    then three predicts more, so that three heading terms are pending
    when the states are compared again."""
    jcfg, tcfg, slam_map = ring40_configs(
        SWITCH_ASSOCIATION_KNOWN=assoc_known, SWITCH_HEADING_KNOWN=1)
    stream = input_stream(tcfg, slam_map, 120)
    jest = jpekf.ShardedEkfSlam(jcfg, slam_map.n_landmarks,
                                make_mesh(1, axis="l"))
    test = tpekf.ShardedEkfSlam(tcfg, slam_map.n_landmarks, device="cpu")
    assert test.capacity == jest.capacity
    js, ts, poses = drive(jest, test, stream)
    err = max(float(np.abs(jp - tp).max()) for jp, tp in poses)
    assert err < DRIVE_POSE_ATOL, err
    assert int(ts.n) >= 4 and ts.hk_n == 0
    _assert_blocks_match(js, ts)
    for v, g, phi in stream[-1][0][:3]:
        js = jest.predict(js, None, jnp.float32(v), jnp.float32(g),
                          jnp.float32(phi))
        ts = test.predict(ts, None, _t(v), _t(g), _t(phi))
    assert ts.hk_n == 3
    _assert_blocks_match(js, ts)


WORLDS = {
    # tests/test_parallel_ekf.py:38-57: pose and covariance atol 5e-3,
    # the pose block 5e-4.
    "heading-known": (dict(n_landmarks=16, n_waypoints=12, radius=40.0,
                           seed=7),
                      dict(SWITCH_HEADING_KNOWN=1, max_landmarks=16),
                      30 * 8, 5e-3),
    # tests/test_parallel_ekf.py:60-67: gated association, pose 1e-2.
    "gated": (dict(n_landmarks=12, n_waypoints=10, radius=35.0, seed=3),
              dict(SWITCH_HEADING_KNOWN=1, max_landmarks=12,
                   SWITCH_ASSOCIATION_KNOWN=0),
              25 * 8, 1e-2),
}


def _sharded(cfg, n_map, n_defer):
    """The port's ShardedEkfSlam on the CPU, its state made with
    ``n_defer`` columns for deferred heading terms."""
    est = tpekf.ShardedEkfSlam(cfg, n_map, device="cpu")
    est.init = lambda n_particles=None: tpekf.sharded_ekf_init(
        est.capacity, n_map, n_defer=n_defer, device="cpu")
    return est


def _run_both(world, n_defer):
    map_kw, cfg_kw, ticks, _ = WORLDS[world]
    slam_map = synthetic_map(**map_kw)
    cfg = SlamConfig(**cfg_kw)
    res_d = Runner(cfg, slam_map, "EKF1", device="cpu").run(seed=5,
                                                             n_ticks=ticks)
    est = _sharded(cfg, slam_map.n_landmarks, n_defer)
    res_s = Runner(cfg, slam_map, "EKF1", estimator=est).run(seed=5,
                                                              n_ticks=ticks)
    return res_d, res_s


@pytest.mark.parametrize("n_defer", [16, 3])
@pytest.mark.parametrize("world", WORLDS)
def test_matches_the_dense_ekf(world, n_defer):
    """n_defer 3 < 8 predicts per observe: each superstep's last five
    heading terms take the fold_now arm, straight into Pmm."""
    res_d, res_s = _run_both(world, n_defer)
    atol = WORLDS[world][3]
    np.testing.assert_allclose(res_s.est_pose, res_d.est_pose, atol=atol)
    d, s = res_d.final_state, res_s.final_state
    assert int(s.n) == int(d.n) > 0
    assert res_s.host_syncs == res_d.host_syncs == 0
    if world == "heading-known":
        Ps = tpekf.dense_covariance(s).numpy()
        Pd = d.P.numpy()
        np.testing.assert_allclose(Ps[:3, :3], Pd[:3, :3], atol=5e-4)
        np.testing.assert_allclose(Ps, Pd, atol=5e-3)
        np.testing.assert_allclose(s.x.numpy(), d.x.numpy(), atol=5e-3)


def test_fold_now_arm_equals_the_deferral():
    """The same 45 supersteps at n_defer 3 and at 16, the last without
    its update: the first run folds five of each superstep's eight
    heading terms into Pmm at once, the second defers all eight; the
    joint covariances agree."""
    _, cfg, slam_map = ring40_configs(SWITCH_HEADING_KNOWN=1)
    stream = input_stream(cfg, slam_map, 45)
    states = []
    for n_defer in (3, 16):
        est = _sharded(cfg, slam_map.n_landmarks, n_defer)
        st = est.init()
        for ticks, z, ids, mask in stream[:-1]:
            for v, g, phi in ticks:
                st = est.predict(st, None, _t(v), _t(g), _t(phi))
            st = est.update(st, None, _t(z), _t(ids), _t(mask))
        for v, g, phi in stream[-1][0]:
            st = est.predict(st, None, _t(v), _t(g), _t(phi))
        states.append(st)
    folded, deferred = states
    assert folded.hk_n == 3 and deferred.hk_n == 8
    assert int(folded.n) == int(deferred.n) > 0
    np.testing.assert_allclose(tpekf.dense_covariance(folded).numpy(),
                               tpekf.dense_covariance(deferred).numpy(),
                               rtol=1e-5, atol=1e-6)
    assert not torch.equal(folded.Pmm, deferred.Pmm)


def test_state_carries_over_from_numpy():
    _, cfg, slam_map = ring40_configs()
    est = tpekf.ShardedEkfSlam(cfg, slam_map.n_landmarks, device="cpu")
    arrays = tpekf.sharded_state_to_numpy(est.init())
    assert set(arrays) == set(jpekf.ShardedEKFState._fields)
    arrays["hk_n"] = 2
    arrays["Pmm"][0, 1] = 0.5
    back = tpekf.sharded_state_from_numpy(arrays, device="cpu")
    assert back.hk_n == 2 and float(back.Pmm[0, 1]) == 0.5
    assert back.n.dtype == torch.int32 and back.x.dtype == torch.float32


# ---------------------------------------------------------------------------
# Several ranks
# ---------------------------------------------------------------------------

S = 4
# ring40's vehicle sees its first landmark at superstep 37 and has
# mapped 4 or more by superstep 120.
MESH_SUPERSTEPS, N_DEFER, EXTRA = 120, 3, 3
MESH_CASES = {"assoc-known": dict(SWITCH_ASSOCIATION_KNOWN=1,
                                  SWITCH_HEADING_KNOWN=1),
              "assoc-unknown": dict(SWITCH_ASSOCIATION_KNOWN=0,
                                    SWITCH_HEADING_KNOWN=1)}
# tests/test_parallel_ekf.py:test_sharded_ekf_capacity_padding's world.
PADDING = dict(world=dict(synthetic=(10, 8, 30.0, 1),
                          config=dict(SWITCH_HEADING_KNOWN=1,
                                      max_landmarks=10)),
               seed=2, ticks=20 * 8)


def _jax_drive(jest, stream, n_defer, extra):
    """``torch_parallel_workers._drive_ekf`` on the JAX estimator, its
    state made with ``n_defer`` columns and placed on the mesh."""
    state = jpekf.sharded_ekf_init(jest.capacity, jest.n_map,
                                   n_defer=n_defer)
    js = jax.device_put(state, jax.tree.map(
        lambda s: NamedSharding(jest.mesh, s), jpekf.state_specs(jest.axis),
        is_leaf=lambda x: isinstance(x, P)))
    f32 = jnp.float32
    poses = []
    for ticks, z, ids, mask in stream:
        for v, g, phi in ticks:
            js = jest.predict(js, None, f32(v), f32(g), f32(phi))
        js = jest.update(js, None, jnp.asarray(z), jnp.asarray(ids),
                         jnp.asarray(mask))
        poses.append(np.asarray(jest.pose(js)))
    end = js
    for v, g, phi in stream[-1][0][:extra]:
        js = jest.predict(js, None, f32(v), f32(g), f32(phi))
    return end, js, np.stack(poses)


def _assert_gathered_match(js, got):
    np.testing.assert_allclose(got["P"],
                               np.asarray(jpekf.dense_covariance(js)),
                               rtol=0, atol=DRIVE_P_ATOL)
    np.testing.assert_allclose(got["x"], np.asarray(js.x), rtol=0,
                               atol=DRIVE_X_ATOL)
    assert got["n"] == int(js.n)
    assert got["hk_n"] == int(js.hk_n)
    np.testing.assert_array_equal(got["da_table"], np.asarray(js.da_table))


@pytest.fixture(scope="module")
def streams():
    return {name: input_stream(ring40_configs(**cfg)[1],
                               ring40_configs()[2], MESH_SUPERSTEPS)
            for name, cfg in MESH_CASES.items()}


@pytest.fixture(scope="module")
def ekf_world(streams):
    drives = [dict(config=MESH_CASES[name], stream=streams[name],
                   n_defer=N_DEFER, extra=EXTRA) for name in MESH_CASES]
    single = dict(drives[1], stream=streams["assoc-unknown"][:60])
    return tw.run_world(tw.ekf_world, S, drives=drives, padding=PADDING,
                        single=single)


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_matches_jax_on_four_ranks(ekf_world, streams, case):
    """Every pose within DRIVE_POSE_ATOL; the gathered states at the
    drive tolerances, after the stream (hk_n 0) and with three heading
    terms pending; every rank gathers the same."""
    jcfg, _, slam_map = ring40_configs(**MESH_CASES[case])
    jest = jpekf.ShardedEkfSlam(jcfg, slam_map.n_landmarks,
                                make_mesh(S, axis="l"))
    j_end, j_pending, j_poses = _jax_drive(jest, streams[case], N_DEFER,
                                           EXTRA)
    i = list(MESH_CASES).index(case)
    for rank, world in enumerate(ekf_world):
        got = world["drives"][i]
        assert got["capacity"] == jest.capacity
        assert got["rows"] == 2 * jest.capacity // S
        err = float(np.abs(got["poses"] - j_poses).max())
        assert err < DRIVE_POSE_ATOL, (rank, err)
        assert got["end"]["n"] >= 4 and got["end"]["hk_n"] == 0
        assert got["pending"]["hk_n"] == EXTRA
        _assert_gathered_match(j_end, got["end"])
        _assert_gathered_match(j_pending, got["pending"])


def test_capacity_padding_on_four_ranks(ekf_world):
    """10 landmarks on 4 ranks: 12 slots, as JAX pads them; the padded
    slots never fill; the run agrees with the port's dense EKF on the
    same world and seed (tests/test_parallel_ekf.py's 5e-3)."""
    cfg, slam_map = tw.port_world(PADDING["world"])
    jest = jpekf.ShardedEkfSlam(JSlamConfig(**PADDING["world"]["config"]),
                                slam_map.n_landmarks, make_mesh(S, axis="l"))
    dense = Runner(cfg, slam_map, "EKF1", device="cpu").run(
        seed=PADDING["seed"], n_ticks=PADDING["ticks"])
    for world in ekf_world:
        got = world["padding"]
        assert got["capacity"] == jest.capacity == 12
        assert got["host_syncs"] == 0
        assert 0 < got["n"] <= 10 and got["n"] == int(dense.final_state.n)
        assert (got["x"][3 + 2 * 10:] == 0).all()
        assert got["da_table"].max() < 10
        np.testing.assert_allclose(got["est_pose"], dense.est_pose,
                                   atol=5e-3)


def test_mesh_ranks_update_eagerly(ekf_world, streams):
    """Every update on the gloo ranks, on meshes of four ranks and of
    one and with no mesh, runs the segments eagerly (a mesh rank's
    collectives stay out of CUDA graphs; the CPU has none): all counted
    in ``update_graphs.eager``, none replayed or captured."""
    cfg, _ = tw.port_world(PADDING["world"])
    updates = (sum(len(streams[name]) for name in MESH_CASES)
               + PADDING["ticks"] // cfg.steps_per_observe
               + 2 * len(streams["assoc-unknown"][:60]))
    for world in ekf_world:
        assert world["graphs"] == dict(replays=0, captures=0, eager=updates)


def test_one_rank_mesh_equals_no_mesh(ekf_world):
    """On each rank, a mesh of that rank alone and no mesh: the same
    states, bit for bit, with the fold arm and pending terms."""
    for world in ekf_world:
        on_mesh, alone = world["single"]
        assert on_mesh["hk_n"] == alone["hk_n"] == EXTRA
        for key, value in alone.items():
            np.testing.assert_array_equal(on_mesh[key], value, err_msg=key)
