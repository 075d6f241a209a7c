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
da_table, the Neff gate decision and the ancestors exactly.

``test_drive_matches_jax`` runs both packages' ``fs1_update`` for 24
supersteps on the JAX simulator's observation stream, each side on its
own state, on both dispatch arms; there rounding compounds over the
supersteps, so poses, weights and planes are held at rtol 1e-4, atol
1e-4."""

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
    ts = state_from_numpy(want, device="cpu")
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
    tstate = state_from_numpy(_as_numpy(jstate), device="cpu")

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
    held = tfs1.fs1_update(state_from_numpy(_as_numpy(tstate),
                                            device="cpu"), *targs,
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
                                                  obs, P)), device="cpu")
    R = np.diag(np.asarray(cfg.Re, np.float32))
    g = torch.Generator().manual_seed(0)
    tfs1.fs1_update(state, *(torch.tensor(np.asarray(a))
                             for a in (obs.z, obs.ids, obs.mask)), R,
                    float(P), trs.uniform_from_generator(P, g))
    assert calls == want


# ---------------------------------------------------------------------------
# Many supersteps against JAX
# ---------------------------------------------------------------------------

DRIVE_SUPERSTEPS = 24
TOL_DRIVE = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def stream():
    """ring40's JAX simulator, seed 3, from the first superstep whose
    observation batch sees three landmarks (a fourth comes into view
    nine supersteps later): the true pose before it, then for each of
    DRIVE_SUPERSTEPS supersteps the noisy controls of its ticks [T, 2]
    and its batch (z, ids, mask) as numpy."""
    cfg = SlamConfig.from_ini(os.path.join(DATA, "ring40.ini"))
    slam_map = read_map_file(os.path.join(DATA, "ring40.mat"))
    sim = JSimulator(cfg, slam_map)
    s = sim.init(seed=3)
    step, observe = jax.jit(sim.control_step), jax.jit(sim.observe_step)
    pose, steps, ctl = None, [], []
    for _ in range(4000 // cfg.steps_per_observe):
        for _ in range(cfg.steps_per_observe):
            s, c = step(s)
            ctl.append((c.v_noisy, c.g_noisy))
        s, obs = observe(s)
        if steps or int(obs.count) >= 3:
            steps.append((np.asarray(ctl, np.float32),
                          tuple(np.asarray(a)
                                for a in (obs.z, obs.ids, obs.mask))))
            if len(steps) == DRIVE_SUPERSTEPS:
                return cfg, slam_map, pose, steps
        else:
            pose = np.asarray(s.vehicle.pose)
        ctl = []
    raise AssertionError("the vehicle never sees a landmark")


@jax.jit
def _jax_predict(xv, V, G, wheelbase, dt):
    for t in range(V.shape[0]):
        xv = jrbpf.propagate_poses(xv, V[t], G[t], wheelbase, dt)
    return xv


@jax.jit
def _jax_drive_update(state, key, z, ids, zmask, R, n_min):
    """JAX's fs1_update (use_pallas=False) and what the port is fed and
    held to: the pre-resample state, the gate, the prefix sum of the
    stratified resample, its dither U and its ancestors."""
    pre = []

    def resample(s, key, n_min):
        pre.append(s)
        return jrbpf.resample(s, key, n_min, True)
    post = jfs1.fs1_update(state, key, z, ids, zmask, R, n_min,
                           use_pallas=False, resample_fn=resample)
    logw_n = jrs.normalize_log_weights(pre[0].logw)
    P = logw_n.shape[0]
    return dict(post=post, need=jrs.effective_particles(logw_n) < n_min,
                csum=jrs._cumsum_2d(jnp.exp(jrs.normalize_log_weights(
                    logw_n))),
                U=jrs._uniform_at(key, jnp.arange(P, dtype=jnp.int32)),
                idx=jrs.stratified_indices(key, logw_n))


@pytest.mark.parametrize("P", [64, 512], ids=["K2-G1", "K4-G2"])
def test_drive_matches_jax(stream, P, monkeypatch):
    """24 supersteps of FastSLAM 1, each package on its own state from
    the same start (every particle at the true pose, no landmark
    mapped), on one observation stream: per superstep the motion noise
    from one numpy draw, JAX's stratified dither and prefix sum injected.
    After each superstep: poses, weights and planes at TOL_DRIVE; n,
    da_table, the gate and the ancestors exactly. The resample fires
    and holds along the way. About 3 s per particle count on one CPU
    worker, JAX's compiles included (the stream fixture: 1.5 s)."""
    cfg, slam_map, pose, steps = stream
    n_map = slam_map.n_landmarks
    L = -(-n_map // 8) * 8
    jstate = jinit(P, L, n_map)._replace(
        xv=jnp.asarray(np.repeat(pose[:, None], P, axis=1)))
    tstate = state_from_numpy(_as_numpy(jstate), device="cpu")
    R = np.diag(np.asarray(cfg.Re, np.float32))
    n_min = float(cfg.NEFFECTIVE * P / cfg.NPARTICLES)
    sig = np.sqrt(np.asarray(cfg.Qe, np.float32))
    rng = np.random.default_rng(P)

    seen = dict(gates=[], ancestors=[])
    resample_gate, gather = trbpf.resample_gate, {}

    def gate(logw, n_min, do_resample):
        logw_n, fired = resample_gate(logw, n_min, do_resample)
        seen["gates"].append(fired)
        return logw_n, fired
    monkeypatch.setattr(trbpf, "resample_gate", gate)
    for name, to_ancestors in (
            ("gather_particles", lambda idx: idx),
            ("gather_particles_bounds",
             lambda S: trs.ancestors_from_bounds(S, P))):
        def wrapped(state, sel, _fn=getattr(trbpf, name), _a=to_ancestors):
            seen["ancestors"].append(_a(sel))
            return _fn(state, sel)
        monkeypatch.setattr(trbpf, name, wrapped)
    csum = {}
    monkeypatch.setattr(trs, "cumulative_weights", lambda logw: csum["now"])

    for i, (ctl, (z, ids, zmask)) in enumerate(steps):
        T = ctl.shape[0]
        V = (ctl[:, 0:1] + rng.normal(size=(T, P)) * sig[0]).astype(
            np.float32)
        G = (ctl[:, 1:2] + rng.normal(size=(T, P)) * sig[1]).astype(
            np.float32)
        jstate = jstate._replace(xv=_jax_predict(
            jstate.xv, jnp.asarray(V), jnp.asarray(G), cfg.WHEELBASE,
            cfg.DT_CONTROLS))
        txv = tstate.xv
        for t in range(T):
            txv = trbpf.propagate_poses(txv, torch.tensor(V[t]),
                                        torch.tensor(G[t]), cfg.WHEELBASE,
                                        cfg.DT_CONTROLS)
        tstate = tstate._replace(xv=txv)

        want = _jax_drive_update(jstate, jax.random.PRNGKey(100 + i),
                                 jnp.asarray(z), jnp.asarray(ids),
                                 jnp.asarray(zmask), jnp.asarray(R),
                                 jnp.float32(n_min))
        csum["now"] = torch.tensor(np.asarray(want["csum"]))
        U = torch.tensor(np.asarray(want["U"]))
        n_seen = len(seen["ancestors"])
        tstate = tfs1.fs1_update(tstate, torch.tensor(z), torch.tensor(ids),
                                 torch.tensor(zmask), R, n_min,
                                 lambda pos: U[pos])
        jstate = want["post"]

        need = bool(want["need"])
        assert seen["gates"][-1] == need, f"superstep {i}: gate"
        assert len(seen["ancestors"]) == n_seen + need
        if need:
            np.testing.assert_array_equal(
                seen["ancestors"][-1].numpy(), np.asarray(want["idx"]),
                err_msg=f"superstep {i}: ancestors")
        got, exp = state_to_numpy(tstate), _as_numpy(jstate)
        for f in ("logw", "xv", "lm", "lm_P"):
            np.testing.assert_allclose(got[f], exp[f], **TOL_DRIVE,
                                       err_msg=f"superstep {i}: {f}")
        for f in ("n", "da_table"):
            np.testing.assert_array_equal(got[f], exp[f],
                                          err_msg=f"superstep {i}: {f}")
    assert True in seen["gates"] and False in seen["gates"]
    assert int(tstate.n) == 4
