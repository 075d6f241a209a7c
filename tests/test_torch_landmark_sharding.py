"""The port's landmark-sharded FastSLAM (``slam_tpu_torch.parallel.
landmarks``) against the JAX package's, and its own invariants, on
spawned gloo worlds (``torch_parallel_workers``); JAX runs here on
``make_mesh_2d`` over the forced CPU devices (tests/conftest.py). The
world and settings are tests/test_landmark_sharding.py's: 12 landmarks
on a synthetic map, heading known, capacity 12, 25 supersteps, seed 9.

- One update of ``LandmarkShardedFastSlam1`` on a 2x2 world with
  SWITCH_RESAMPLE = 0, from the state of a JAX run (P = 256, so each
  block of 128 takes K4's arm) and its last batch with one landmark
  unmapped, against JAX's: planes and weights at rtol 1e-5, atol 1e-5,
  n and da_table exactly. The port runs its update through K4's
  cross-shard arm (the twin here) and through the unfused arm.
- K4's cross-shard arm against the unfused arm on that world, at the
  JAX test's tolerance for the same pair (rtol 2e-4, atol 1e-5).
- On 8 ranks, as the JAX tests: (p=4, l=2) equals (p=4) (poses atol
  2e-3, n equal); (2, 1) equals (2, 4) for FastSLAM 1 (poses atol 2e-3,
  landmark means atol 5e-3) and FastSLAM 2 (poses atol 5e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_tpu.config import SlamConfig as JSlamConfig
from slam_tpu.maps import synthetic_map as jsynthetic_map
from slam_tpu.parallel.landmarks import (
    LandmarkShardedFastSlam1 as JLandmarkShardedFastSlam1,
)
from slam_tpu.parallel.landmarks import make_mesh_2d as jmake_mesh_2d
from slam_tpu.runtime import Runner as JRunner
from slam_tpu_torch.models.particles import FIELDS

import torch_parallel_workers as tw

CONFIG = dict(SWITCH_HEADING_KNOWN=1, max_landmarks=12, NPARTICLES=64,
              NEFFECTIVE=48)
WORLD = dict(synthetic=(12, 10, 35.0, 11), config=CONFIG)
SEED, TICKS = 9, 25 * 8
P_UPDATE = 256
TOL = dict(rtol=1e-5, atol=1e-5)


def _numpy(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


@pytest.fixture(scope="module")
def update_case():
    """A JAX run of LandmarkShardedFastSlam1 on make_mesh_2d(2, 2); its
    final state with the last batch's last landmark dropped from the id
    table, that batch, and JAX's update of them with SWITCH_RESAMPLE = 0
    (its unfused arm, the one JAX takes off a TPU)."""
    cfg = JSlamConfig(**CONFIG)
    slam_map = jsynthetic_map(*WORLD["synthetic"][:2],
                              radius=WORLD["synthetic"][2],
                              seed=WORLD["synthetic"][3])
    mesh = jmake_mesh_2d(2, 2)
    est = JLandmarkShardedFastSlam1(cfg, slam_map.n_landmarks, mesh,
                                    P_UPDATE)
    run = JRunner(cfg, slam_map, "FASTSLAM1", estimator=est,
                  n_particles=P_UPDATE).run(seed=SEED, n_ticks=TICKS)
    obs = (run.obs_z[-1], run.obs_ids[-1], run.obs_mask[-1])
    seen = obs[1][obs[2]]
    table = np.asarray(run.final_state.da_table).copy()
    assert len(seen) >= 2 and (table[seen] >= 0).all()
    table[seen[-1]] = -1
    state = run.final_state._replace(da_table=jnp.asarray(table))
    est0 = JLandmarkShardedFastSlam1(cfg.replace(SWITCH_RESAMPLE=0),
                                     slam_map.n_landmarks, mesh, P_UPDATE)
    want = est0.update(state, jax.random.PRNGKey(0),
                       *(jnp.asarray(a) for a in obs))
    return _numpy(state), obs, _numpy(want)


@pytest.fixture(scope="module")
def update_world(update_case):
    state, obs, _ = update_case
    return tw.run_world(
        tw.landmark_update_world, 4,
        world=dict(WORLD, config=dict(CONFIG, SWITCH_RESAMPLE=0)),
        state=state, obs=obs, P=P_UPDATE)


@pytest.fixture(scope="module")
def invariance_world():
    """Rank 0's runs of the 8-rank world."""
    return tw.run_world(tw.landmark_invariance_world, 8, world=WORLD,
                        P1=64, P2=32, seed=SEED, ticks=TICKS)[0]


@pytest.mark.parametrize("arm", ["fused", "unfused"])
def test_landmark_sharded_update_matches_jax(update_world, update_case, arm):
    before, _, want = update_case
    for r in update_world:
        got = r[arm]
        for f in ("logw", "xv", "Pv", "lm", "lm_P"):
            np.testing.assert_allclose(got[f], want[f], **TOL, err_msg=f)
        for f in ("n", "da_table"):
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert int(want["n"]) == int(before["n"]) + 1      # the one new


def test_cross_shard_arm_matches_unfused(update_world):
    for r in update_world:
        fused, unfused = r["fused"], r["unfused"]
        for f in ("n", "da_table"):
            np.testing.assert_array_equal(fused[f], unfused[f], err_msg=f)
        for f in ("logw", "xv", "lm", "lm_P"):
            np.testing.assert_allclose(fused[f], unfused[f], rtol=2e-4,
                                       atol=1e-5, err_msg=f)


def test_fs1_landmark_sharding_matches_particle_only(invariance_world):
    """(p=4, l=2) == (p=4): the l split is invisible."""
    r1, r2 = invariance_world["fs1 p4"], invariance_world["fs1 p4l2"]
    assert r2["capacity"] == 12 and r1["capacity"] == 16
    np.testing.assert_allclose(r2["est_pose"], r1["est_pose"], atol=2e-3)
    assert r2["n"] == r1["n"] > 0
    assert r1["syncs"] == r2["syncs"] == 1.0


def test_fs1_landmark_shard_degree_invariance(invariance_world):
    """(p=2, l=1) == (p=2, l=4): only the landmark split changes."""
    r1, r4 = invariance_world["fs1 p2l1"], invariance_world["fs1 p2l4"]
    np.testing.assert_allclose(r4["est_pose"], r1["est_pose"], atol=2e-3)
    np.testing.assert_allclose(r4["lm"], r1["lm"], atol=5e-3)
    assert r4["n"] == r1["n"] > 0


def test_fs2_landmark_shard_degree_invariance(invariance_world):
    """FastSLAM 2's refinement survives the landmark split (the gathered
    planes summed over l)."""
    r1, r4 = invariance_world["fs2 p2l1"], invariance_world["fs2 p2l4"]
    np.testing.assert_allclose(r4["est_pose"], r1["est_pose"], atol=5e-3)
    assert r4["n"] == r1["n"] > 0
    assert np.isfinite(r4["ate"])
