"""The port's particle-sharded layer (``slam_tpu_torch.parallel``:
``mesh``, ``resampling``, ``filter``) against the JAX package's, 4 gloo
ranks against JAX's ``shard_map`` on ``make_mesh(4)`` over the forced
CPU devices (tests/conftest.py).

One spawned world (``torch_parallel_workers.particle_world``) runs every
multi-rank check; the JAX side runs here. Inputs come from seeded numpy;
each rank's stratified dither is JAX's own draw,
``jax.random.uniform(fold_in(key, me), (Pl,))``, injected.

- ``global_neff`` and ``sharded_estimate_position`` within 1e-5;
- ``ring_resample``: the gate equal; the selected ancestors (xv[0] holds
  each particle's global index) and every gathered field bit for bit;
  the new log weights at rtol 1e-6 (float32 logs of the same values);
- the one-rank arm (each rank on a mesh of its own) likewise, against
  JAX on ``make_mesh(1)``; and the card's G2 arm at Pl = 512 against
  JAX's ``_local_bounds_resample(..., interpret=True)``, in this
  process, with JAX's prefix sum and dither injected, bit for bit;
- one ``ShardedFastSlam2.update`` from that state after 8 noise-off
  predict ticks, with JAX's proposal draw injected (JAX draws one eps
  [3, Pl] from the same key on every shard), at
  ``test_torch_fastslam2.py``'s tolerances for one round;
- one ``ShardedFastSlam1.update`` with SWITCH_RESAMPLE = 0 from the state
  of a JAX run on ring40 (P = 64), its last batch again with one of its
  landmarks unmapped: planes and weights at rtol 1e-5, atol
  1e-5 (the tolerance of ``test_torch_fastslam1.test_superstep_matches_
  jax``), n and da_table exactly;
- a ring40 run (P = 64, 800 ticks, seed 3): ATE below twice JAX's
  ``ShardedFastSlam1`` on the same world, ticks and seed, one host sync
  per superstep, the same truth and estimate on every rank.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from slam_tpu.config import SlamConfig as JSlamConfig
from slam_tpu.maps import read_map_file as jread_map_file
from slam_tpu.models import fastslam2 as jfs2
from slam_tpu.models.particles import init_particles as jinit
from slam_tpu.ops import resampling as jrs
from slam_tpu.parallel import ShardedFastSlam1 as JShardedFastSlam1
from slam_tpu.parallel import ShardedFastSlam2 as JShardedFastSlam2
from slam_tpu.parallel import make_mesh as jmake_mesh
from slam_tpu.parallel.mesh import particle_state_specs as jspecs
from slam_tpu.parallel.resampling import _local_bounds_resample as jbounds
from slam_tpu.parallel.resampling import global_neff as jglobal_neff
from slam_tpu.parallel.resampling import ring_resample as jring
from slam_tpu.parallel.resampling import (
    sharded_estimate_position as jestimate,
)
from slam_tpu.runtime import Runner as JRunner
from slam_tpu.runtime import compute_metrics as jmetrics
from slam_tpu_torch.models.particles import FIELDS, state_from_numpy
from slam_tpu_torch.ops import resampling as trs
from slam_tpu_torch.parallel import resampling as tpr

import torch_parallel_workers as tw

S = 4
N = 64
Pl = N // S
RING40 = dict(ini="ring40.ini", mat="ring40.mat")
DRIVE = dict(P=64, ticks=800, seed=3)
TOL = dict(rtol=1e-5, atol=1e-5)
# tests/test_torch_fastslam2.py's, for one fs2_update round.
TOL_FS2 = {"logw": dict(rtol=1e-3, atol=1e-5),
           "xv": dict(rtol=1e-4, atol=1e-5), "lm": dict(rtol=1e-4, atol=1e-5),
           "Pv": dict(rtol=1e-3, atol=1e-6), "lm_P": dict(rtol=1e-3, atol=1e-6)}


def _numpy(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


def _toy_state(n, seed, capacity=4):
    """A JAX state with every per-particle field random; xv[0] is each
    particle's global index, so a gather shows its ancestors."""
    rng = np.random.default_rng(seed)
    xv = rng.normal(size=(3, n)).astype(np.float32)
    xv[0] = np.arange(n)
    return jinit(n, capacity, 4)._replace(
        xv=jnp.asarray(xv),
        Pv=jnp.asarray(rng.normal(size=(6, n)).astype(np.float32)),
        lm=jnp.asarray(rng.normal(size=(2, capacity, n)).astype(np.float32)),
        lm_P=jnp.asarray(rng.normal(size=(3, capacity, n))
                         .astype(np.float32)))


def _dithers(key, n_shards, n_local):
    """Each shard's JAX dither, [S, Pl]."""
    return np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(key, me), (n_local,), dtype=jnp.float32))
        for me in range(n_shards)])


def _jax_ring(mesh, n_shards):
    def run(state, key, n_min):
        new, logw, need = jring(state, state.logw, key, n_min, True, "p",
                                static_ring_size=n_shards)
        return new._replace(logw=logw), need
    return jax.jit(shard_map(run, mesh=mesh, in_specs=(jspecs(), P(), P()),
                             out_specs=(jspecs(), P()), check_vma=False))


def _ring_cases():
    """(name, JAX state, key, n_min): a random fired gate, two heavy
    particles on two shards (tests/test_parallel.py's case) and uniform
    weights, whose gate holds."""
    rng = np.random.default_rng(1)
    heavy = np.full(N, -50.0, np.float32)
    heavy[3], heavy[45] = np.log(0.75), np.log(0.25)
    cases = []
    for i, (name, logw, n_min) in enumerate((
            ("fires", rng.normal(size=N).astype(np.float32) * 3, N),
            ("heavy", heavy, 48.0),
            ("holds", np.full(N, -np.log(N), np.float32), 48.0))):
        state = _toy_state(N, seed=10 + i)._replace(logw=jnp.asarray(logw))
        cases.append((name, state, jax.random.PRNGKey(20 + i), n_min))
    return cases


@pytest.fixture(scope="module")
def drive_world():
    """ring40 (JAX's config and map, as the port's spec names them)."""
    return (JSlamConfig.from_ini(f"{tw.DATA}/ring40.ini"),
            jread_map_file(f"{tw.DATA}/ring40.mat"))


@pytest.fixture(scope="module")
def jax_drive(drive_world):
    """JAX's ShardedFastSlam1 on make_mesh(4): the 800-tick run, and the
    run that stops after the first superstep whose batch sees two
    landmarks (the 66th, seed 3)."""
    cfg, slam_map = drive_world

    def run(ticks):
        est = JShardedFastSlam1(cfg, slam_map.n_landmarks, jmake_mesh(S),
                                DRIVE["P"])
        return JRunner(cfg, slam_map, "FASTSLAM1", estimator=est,
                       n_particles=DRIVE["P"]).run(seed=DRIVE["seed"],
                                                   n_ticks=ticks)
    full = run(DRIVE["ticks"])
    t = int(np.argmax(full.obs_count >= 2))
    assert full.obs_count[t] >= 2
    return full, run((t + 1) * cfg.steps_per_observe)


@pytest.fixture(scope="module")
def update_case(drive_world, jax_drive):
    """The state of the shorter run and the observation batch it last
    took in, with one of the batch's landmarks dropped from the id table
    so that the update maps it anew (the particles' poses fit the
    batch); JAX's update of it with SWITCH_RESAMPLE = 0."""
    cfg, slam_map = drive_world
    _, part = jax_drive
    state = part.final_state
    obs = (part.obs_z[-1], part.obs_ids[-1], part.obs_mask[-1])
    seen = obs[1][obs[2]]
    table = np.asarray(state.da_table).copy()
    assert len(seen) >= 2 and (table[seen] >= 0).all()
    table[seen[-1]] = -1
    state = state._replace(da_table=jnp.asarray(table))
    cfg0 = cfg.replace(SWITCH_RESAMPLE=0)
    est = JShardedFastSlam1(cfg0, slam_map.n_landmarks, jmake_mesh(S),
                            DRIVE["P"])
    want = est.update(state, jax.random.PRNGKey(0),
                      *(jnp.asarray(a) for a in obs))
    return _numpy(state), obs, _numpy(want)


@pytest.fixture(scope="module")
def fs2_update_case(drive_world, update_case):
    """update_case's state after 8 noise-off FastSLAM 2 predict ticks
    (so that Pv is not zero), and JAX's ShardedFastSlam2 update of it
    with SWITCH_RESAMPLE = 0; JAX draws the proposal noise from the same
    key on every shard, eps [3, Pl], which the port is given."""
    cfg, slam_map = drive_world
    before, obs, _ = update_case
    state = jinit(N, before["lm"].shape[1], slam_map.n_landmarks)._replace(
        **{f: jnp.asarray(a) for f, a in before.items()})
    Q = jnp.asarray(np.diag(np.asarray(cfg.Qe, np.float32)))
    for t in range(cfg.steps_per_observe):
        state = jfs2.fs2_predict(state, jax.random.PRNGKey(t),
                                 jnp.float32(cfg.V), jnp.float32(0.0), Q,
                                 wheelbase=cfg.WHEELBASE,
                                 dt=cfg.DT_CONTROLS, add_noise=False)
    assert float(jnp.abs(state.Pv).max()) > 0
    key = jax.random.PRNGKey(1)
    est = JShardedFastSlam2(cfg.replace(SWITCH_RESAMPLE=0),
                            slam_map.n_landmarks, jmake_mesh(S), N)
    want = est.update(state, key, *(jnp.asarray(a) for a in obs))
    eps = np.asarray(jax.random.normal(jax.random.split(key)[1], (3, Pl),
                                       dtype=jnp.float32))
    return _numpy(state), eps, _numpy(want)


@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(4)
    return dict(logw=rng.normal(size=N).astype(np.float32) * 2,
                xv=rng.normal(size=(3, N)).astype(np.float32))


@pytest.fixture(scope="module")
def local_cases():
    """One case per rank for the one-rank arm: its own state, weights
    and JAX's dither on a one-device mesh (fold_in(key, 0))."""
    cases = []
    for r in range(S):
        rng = np.random.default_rng(30 + r)
        state = _toy_state(Pl, seed=40 + r)._replace(logw=jnp.asarray(
            rng.normal(size=Pl).astype(np.float32) * 3))
        key = jax.random.PRNGKey(50 + r)
        cases.append((state, key, float(Pl)))
    return cases


@pytest.fixture(scope="module")
def world(toy, local_cases, update_case, fs2_update_case):
    rings = [dict(state=_numpy(state), n_min=n_min,
                  dither=_dithers(key, S, Pl))
             for _, state, key, n_min in _ring_cases()]
    locals_ = [dict(state=_numpy(state), n_min=n_min,
                    dither=_dithers(key, 1, Pl))
               for state, key, n_min in local_cases]
    state, obs, _ = update_case
    fs2_state, eps, _ = fs2_update_case
    ranks = tw.run_world(
        tw.particle_world, S, toy=toy, rings=rings, locals_=locals_,
        update=dict(world=dict(RING40, config=dict(SWITCH_RESAMPLE=0)),
                    state=state, obs=obs, fs2_state=fs2_state, eps=eps),
        drive=dict(DRIVE, world=RING40))
    return ranks


def test_collectives_match_jax(world, toy):
    mesh = jmake_mesh(S)
    logw, xv = jnp.asarray(toy["logw"]), jnp.asarray(toy["xv"])
    neff = jax.jit(shard_map(lambda w: jglobal_neff(w, "p"), mesh=mesh,
                             in_specs=(P("p"),), out_specs=P(),
                             check_vma=False))(logw)
    pose = jax.jit(shard_map(lambda w, x: jestimate(w, x, "p"), mesh=mesh,
                             in_specs=(P("p"), P(None, "p")),
                             out_specs=P(), check_vma=False))(logw, xv)
    for r in world:
        np.testing.assert_allclose(r["neff"], float(neff), rtol=1e-5)
        np.testing.assert_allclose(r["pose"], np.asarray(pose), rtol=1e-5,
                                   atol=1e-5)


def _same_resample(got, want, need, name):
    assert got["need"] == bool(need), name
    np.testing.assert_array_equal(got["xv"][0], want["xv"][0],
                                  err_msg=f"{name}: ancestors")
    for f in ("xv", "Pv", "lm", "lm_P"):
        np.testing.assert_array_equal(got[f], want[f],
                                      err_msg=f"{name}: {f}")
    np.testing.assert_allclose(got["logw"], want["logw"], rtol=1e-6,
                               err_msg=f"{name}: logw")


@pytest.mark.parametrize("case", [0, 1, 2], ids=["fires", "heavy", "holds"])
def test_ring_resample_matches_jax(world, case):
    name, state, key, n_min = _ring_cases()[case]
    new, need = _jax_ring(jmake_mesh(S), S)(state, key, jnp.float32(n_min))
    assert bool(need) == (name != "holds")
    want = _numpy(new)
    for r in world:
        _same_resample(r["rings"][case], want, need, name)


def test_one_rank_arm_matches_jax(world, local_cases):
    ring1 = _jax_ring(jmake_mesh(1), 1)
    for rank, (state, key, n_min) in enumerate(local_cases):
        new, need = ring1(state, key, jnp.float32(n_min))
        assert bool(need)
        _same_resample(world[rank]["locals"], _numpy(new), need,
                       f"rank {rank}")


def test_local_bounds_resample_matches_jax(monkeypatch):
    """The card's one-rank arm (G2 from the offspring bounds, here its
    twin) against JAX's TPU arm in interpret mode, at Pl = 512: the
    mirror of tests/test_parallel.py's check, with JAX's prefix sum and
    dither injected."""
    n = 512
    fields = ("logw", "xv", "Pv", "lm", "lm_P")
    state = _toy_state(n, seed=2)._replace(logw=jnp.asarray(
        np.random.default_rng(8).normal(size=n).astype(np.float32) * 2))
    wn = jnp.exp(jrs.normalize_log_weights(state.logw))
    key = jax.random.PRNGKey(3)
    want = jbounds(state, wn, key, jnp.int32(0), n, fields, interpret=True)

    csum = torch.tensor(np.asarray(jrs._cumsum_2d(wn)))
    U = torch.tensor(np.asarray(jrs._uniform_at(
        jax.random.fold_in(key, 0), jnp.arange(n, dtype=jnp.int32))))
    monkeypatch.setattr(trs, "_cumsum_blocked", lambda x: csum)
    got = tpr._local_bounds_resample(
        state_from_numpy(_numpy(state), device="cpu"),
        torch.tensor(np.asarray(wn)), lambda pos: U[pos], fields)
    assert not np.array_equal(np.asarray(want.xv[0]), np.arange(n))
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_sharded_fs1_update_matches_jax(world, update_case):
    before, _, want = update_case
    for r in world:
        got = r["update"]
        for f in ("logw", "xv", "Pv", "lm", "lm_P"):
            np.testing.assert_allclose(got[f], want[f], **TOL, err_msg=f)
        for f in ("n", "da_table"):
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert int(want["n"]) > int(before["n"])          # new features


def test_sharded_fs2_update_matches_jax(world, fs2_update_case):
    """ShardedFastSlam2: the proposal (K3's twin), the likelihood and
    the map update on each rank's block, on JAX's eps."""
    before, _, want = fs2_update_case
    for r in world:
        got = r["update_fs2"]
        for f, tol in TOL_FS2.items():
            np.testing.assert_allclose(got[f], want[f], **tol, err_msg=f)
        for f in ("n", "da_table"):
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        assert not np.any(got["Pv"])                  # zeroed after a fix
    assert int(want["n"]) > int(before["n"])


def test_sharded_fs1_run_within_jax_bound(world, jax_drive):
    full, _ = jax_drive
    bound = 2.0 * jmetrics(full).ate_rmse
    drives = [r["drive"] for r in world]
    for d in drives:
        assert math.isfinite(d["ate"]) and d["ate"] < bound, (d["ate"],
                                                              bound)
        assert d["syncs"] == 1.0
        # The pose estimate is all-reduced: the same on every rank.
        # Every rank simulates the same world: the same truth; and the
        # pose estimate is all-reduced: the same on every rank.
        np.testing.assert_array_equal(d["true_pose"],
                                      drives[0]["true_pose"])
        np.testing.assert_array_equal(d["est_pose"], drives[0]["est_pose"])
