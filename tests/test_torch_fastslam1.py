"""The port's FastSLAM 1 superstep against the JAX package's, from the
same particle state, on data/ring40.

P = 64 runs the port's K2 + G1 dispatch, P = 512 its K4 + G2 dispatch
(their plain twins on the CPU); the JAX side runs its unfused jnp path
(use_pallas=False). The random steps are fed from one draw: the motion
noise as numpy V and G, the stratified dither as JAX's U, and the
resample's prefix sum as JAX's csum (a 1-ulp difference in
torch.cumsum may move a stratum boundary).

Tolerance: planes and log weights at rtol 1e-5, atol 1e-5 (float32
rounding through 8 predict ticks, the Jacobians and the EKF); n,
da_table, the Neff gate decision and the ancestors exactly."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.config import SlamConfig
from slam_tpu.maps import read_map_file
from slam_tpu.models import fastslam1 as jfs1
from slam_tpu.models import rbpf as jrbpf
from slam_tpu.models.particles import init_particles as jinit
from slam_tpu.ops import resampling as jrs
from slam_tpu.sim.simulator import Simulator as JSimulator
from slam_tpu_torch.models import fastslam1 as tfs1
from slam_tpu_torch.models import rbpf as trbpf
from slam_tpu_torch.models.particles import (
    FIELDS,
    state_from_numpy,
    state_to_numpy,
)
from slam_tpu_torch.ops import kernels as tk
from slam_tpu_torch.ops import resampling as trs

DATA = os.path.join(os.path.dirname(__file__), os.pardir, "data")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def scene():
    """ring40 config and map, and the first JAX observation batch (on
    the superstep grid) that sees at least four landmarks; the vehicle
    starts at the ring's centre, out of sensor range."""
    cfg = SlamConfig.from_ini(os.path.join(DATA, "ring40.ini"))
    slam_map = read_map_file(os.path.join(DATA, "ring40.mat"))
    sim = JSimulator(cfg, slam_map)
    s = sim.init(seed=3)
    step, observe = jax.jit(sim.control_step), jax.jit(sim.observe_step)
    for tick in range(1, 4001):
        s, _ = step(s)
        if tick % cfg.steps_per_observe == 0:
            s, obs = observe(s)
            if int(obs.count) >= 4:
                return cfg, slam_map, np.asarray(s.vehicle.pose), obs
    raise AssertionError("no observation batch with four landmarks")


def _jax_state(cfg, slam_map, pose, obs, P, seed=0):
    """A mid-run JAX state: half of the visible landmarks (and a few
    hidden ones) already mapped, per-particle poses and maps scattered
    around the truth, uneven weights."""
    rng = np.random.default_rng(seed)
    n_map = slam_map.n_landmarks
    L = -(-n_map // 8) * 8
    vis = np.asarray(obs.ids)[np.asarray(obs.mask)]
    hidden = np.setdiff1d(np.arange(n_map), vis)[:5]
    known = np.concatenate([vis[::2], hidden])
    table = np.full(n_map, -1, np.int32)
    table[known] = rng.permutation(len(known))
    lm = np.zeros((2, L, P), np.float32)
    lm[:, table[known]] = slam_map.landmarks[known].T[:, :, None]
    lm[:, :len(known)] += rng.normal(size=(2, len(known), P)) * 0.3
    lm_P = np.zeros((3, L, P), np.float32)
    lm_P[0, :len(known)] = 0.05
    lm_P[1, :len(known)] = 0.005
    lm_P[2, :len(known)] = 0.04
    xv = (pose[:, None] + rng.normal(size=(3, P))
          * np.array([[0.3], [0.3], [0.02]])).astype(np.float32)
    logw = (rng.normal(size=P) * 0.5 - math.log(P)).astype(np.float32)
    return jinit(P, L, n_map)._replace(
        logw=jnp.asarray(logw), xv=jnp.asarray(xv),
        lm=jnp.asarray(lm), lm_P=jnp.asarray(lm_P),
        n=jnp.int32(len(known)), da_table=jnp.asarray(table))


def _as_numpy(state):
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


def test_state_numpy_round_trip_is_exact(scene):
    cfg, slam_map, pose, obs = scene
    want = _as_numpy(_jax_state(cfg, slam_map, pose, obs, P=48))
    ts = state_from_numpy(want)
    assert ts.n_particles == 48 and ts.capacity == 40
    got = state_to_numpy(ts)
    for f in FIELDS:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.mark.parametrize("P", [64, 512], ids=["K2-G1", "K4-G2"])
@pytest.mark.parametrize("gate", ["fires", "holds"])
def test_superstep_matches_jax(scene, P, gate, monkeypatch):
    cfg, slam_map, pose, obs = scene
    jstate = _jax_state(cfg, slam_map, pose, obs, P)
    tstate = state_from_numpy(_as_numpy(jstate))

    rng = np.random.default_rng(P)
    V = (cfg.V + rng.normal(size=(8, P)) * 0.3).astype(np.float32)
    G = (rng.normal(size=(8, P)) * 0.05).astype(np.float32)
    jxv, txv = jstate.xv, tstate.xv
    for t in range(8):
        jxv = jrbpf.propagate_poses(jxv, jnp.asarray(V[t]),
                                    jnp.asarray(G[t]), cfg.WHEELBASE,
                                    cfg.DT_CONTROLS)
        txv = trbpf.propagate_poses(txv, torch.tensor(V[t]),
                                    torch.tensor(G[t]), cfg.WHEELBASE,
                                    cfg.DT_CONTROLS)
    np.testing.assert_allclose(txv.numpy(), np.asarray(jxv), **TOL)
    jstate, tstate = jstate._replace(xv=jxv), tstate._replace(xv=txv)

    R = np.diag(np.asarray(cfg.Re, np.float32))
    n_min = float(P) if gate == "fires" else 0.0
    key = jax.random.PRNGKey(11)
    z, ids, zmask = (np.asarray(a) for a in (obs.z, obs.ids, obs.mask))
    jargs = (jnp.asarray(z), jnp.asarray(ids), jnp.asarray(zmask),
             jnp.asarray(R), jnp.float32(n_min))
    want = jfs1.fs1_update(jstate, key, *jargs, use_pallas=False)
    # JAX's pre-resample weights, its gate, and its stratified draws.
    logw_n = jfs1.fs1_update(jstate, key, *jargs, do_resample=False,
                             use_pallas=False).logw
    need = bool(jrs.effective_particles(logw_n) < n_min)
    assert need == (gate == "fires")
    csum = np.asarray(jrs._cumsum_2d(jnp.exp(
        jrs.normalize_log_weights(logw_n))))
    U = torch.tensor(np.asarray(jrs._uniform_at(
        key, jnp.arange(P, dtype=jnp.int32))))
    monkeypatch.setattr(trs, "cumulative_weights",
                        lambda logw: torch.tensor(csum))

    # The port's gate decision, from its own pre-resample weights.
    targs = (torch.tensor(z), torch.tensor(ids), torch.tensor(zmask), R)
    held = tfs1.fs1_update(state_from_numpy(_as_numpy(tstate)), *targs,
                           n_min, lambda pos: U[pos], do_resample=False)
    assert bool(trs.effective_particles(held.logw) < n_min) == need

    # Ancestors, bit for bit, from the same csum and U.
    want_idx = np.asarray(jrs.stratified_indices(key, logw_n))
    got_idx = trs.stratified_indices(held.logw, lambda pos: U[pos])
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)

    tk.reset_launch_counts()
    got = tfs1.fs1_update(tstate, *targs, n_min, lambda pos: U[pos])
    assert sum(tk.launch_counts().values()) == 0   # CPU: twins only
    got, want = state_to_numpy(got), _as_numpy(want)
    for f in ("logw", "xv", "Pv", "lm", "lm_P"):
        np.testing.assert_allclose(got[f], want[f], **TOL, err_msg=f)
    for f in ("n", "da_table"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert int(got["n"]) > int(np.asarray(jstate.n))  # new features added


@pytest.mark.parametrize("P,want", [(64, {"K2", "G1"}),
                                     (128, {"K4", "G1"}),
                                     (512, {"K4", "G2"})])
def test_fs1_update_dispatch_follows_particle_count(scene, P, want,
                                                    monkeypatch):
    """K4 exactly when P % 128 == 0, G2 exactly when P % 512 == 0: the
    gates the JAX package applies on a TPU."""
    from slam_tpu_torch.models import particles as tparticles

    calls = set()

    def record(module, name, kid):
        fn = getattr(module, name)

        def wrapped(*args, **kw):
            calls.add(kid)
            return fn(*args, **kw)
        monkeypatch.setattr(module, name, wrapped)

    record(tfs1, "observe", "K2")
    record(tfs1, "fused_update", "K4")
    record(tparticles, "sorted_gather_multi", "G1")
    record(tparticles, "bounds_gather_multi", "G2")
    cfg, slam_map, pose, obs = scene
    state = state_from_numpy(_as_numpy(_jax_state(cfg, slam_map, pose,
                                                  obs, P)))
    R = np.diag(np.asarray(cfg.Re, np.float32))
    g = torch.Generator().manual_seed(0)
    tfs1.fs1_update(state, *(torch.tensor(np.asarray(a))
                             for a in (obs.z, obs.ids, obs.mask)), R,
                    float(P), trs.uniform_from_generator(P, g))
    assert calls == want
