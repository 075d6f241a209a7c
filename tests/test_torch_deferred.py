"""The port's deferred-resample FastSLAM 1 (K5 and the carry around it)
against the JAX package's, and against the port's own eager path.

- K5's twin against JAX's ``fs1_resample_update_tpu`` in interpret mode.
- Rounds of ``fs1_update_deferred`` from one state carried across both
  packages, with the gate firing (back to back), holding after a fire,
  and never firing; then ``finalize_deferred``. Each round's stratified
  dither U and prefix sum are JAX's, injected into the port (a 1-ulp
  difference in the prefix sum could move a stratum edge). n, da_table
  and S must match exactly; the floats within the tolerances of
  tests/test_deferred.py: logw, xv and lm at rtol 1e-4, atol 1e-5, lm_P
  at rtol 1e-3 (float32 rounding through the EKF over several rounds).
- The Runner: the deferred path against the eager one on the CPU, which
  run the same twins on the same numbers, so bit for bit.
- The dispatch of the multi-tick predict, config #5's setup, the carry's
  numpy round trip, and on a card K5 against its twin.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.models import fastslam1 as jfs1
from slam_tpu.models.particles import init_particles as jinit
from slam_tpu.ops import resampling as jrs
from slam_tpu.ops.pallas import kernels as jkernels
from slam_tpu.runtime import config5 as jconfig5
from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.maps import synthetic_map
from slam_tpu_torch.models import fastslam1 as tfs1
from slam_tpu_torch.models.particles import (
    FIELDS,
    deferred_state_from_numpy,
    deferred_state_to_numpy,
    state_to_numpy,
)
from slam_tpu_torch.ops import kernels as tk
from slam_tpu_torch.ops import resampling as trs
from slam_tpu_torch.ops.kernels import kernels as tkernels
from slam_tpu_torch.runtime import Runner
from slam_tpu_torch.runtime import config5 as tconfig5

R = np.diag([0.01, 0.0003]).astype(np.float32)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, device="cpu"):
    return torch.tensor(np.asarray(a), device=device)


def _as_numpy(state):
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


def _jax_state(P, L, n_map, seed=0):
    rng = np.random.default_rng(seed)
    return jinit(P, L, n_map)._replace(
        xv=jnp.asarray(rng.normal(size=(3, P)).astype(np.float32) * 0.1))


def _obs_round(rng, n_map, K):
    """An observation batch: a moving subset of the first half of the map
    ids (so consecutive batches share landmarks), some masked."""
    ids = np.sort(rng.choice(n_map // 2, K, replace=False)).astype(np.int32)
    z = np.column_stack([rng.uniform(3, 8, K),
                         rng.uniform(-0.5, 0.5, K)]).astype(np.float32)
    return z, ids, rng.uniform(size=K) < 0.9


def _bounds(logw, key):
    """JAX's offspring bounds for weights ``logw``."""
    csum = jrs._cumsum_2d(jnp.exp(jrs.normalize_log_weights(
        jnp.asarray(logw))))
    return np.asarray(jrs.offspring_bounds(key, csum, logw.shape[0]))


def _update_batch(P=1024, L=16, n_map=24, seed=11):
    """A JAX state with 10 live slots (the rows at and past n zero, as
    the filter keeps them) and a batch with matched, new and masked
    entries, and the bookkeeping the update derives from it."""
    from slam_tpu.models import rbpf as jrbpf

    rng = np.random.default_rng(seed)
    table = -np.ones(n_map, np.int32)
    table[2:12] = np.arange(10)
    lm = rng.normal(size=(2, L, P)).astype(np.float32) * 5
    lm[:, 10:] = 0.0
    lm_P = np.zeros((3, L, P), np.float32)
    lm_P[0, :10], lm_P[2, :10], lm_P[1, :10] = 0.1, 0.1, 0.01
    state = jinit(P, L, n_map)._replace(
        logw=jnp.asarray((rng.normal(size=P) * 0.3 - np.log(P))
                         .astype(np.float32)),
        xv=jnp.asarray(rng.normal(size=(3, P)).astype(np.float32) * 0.1),
        lm=jnp.asarray(lm), lm_P=jnp.asarray(lm_P), n=jnp.int32(10),
        da_table=jnp.asarray(table))
    K = 5
    z = jnp.asarray(np.column_stack([rng.uniform(3, 8, K),
                                     rng.uniform(-0.5, 0.5, K)]
                                    ).astype(np.float32))
    ids = jnp.asarray(np.array([3, 15, 11, 20, 4], np.int32))
    zmask = jnp.asarray(np.array([True, True, True, True, False]))
    assoc, is_new = jrbpf.associate_known(state, ids, zmask)
    matched = assoc >= 0
    slot = jnp.where(matched, assoc, 0)
    new = is_new.astype(jnp.int32)
    slot_new = state.n + jnp.cumsum(new) - new
    ok = is_new & (slot_new < L)
    S = _bounds(rng.normal(size=P).astype(np.float32) * 2,
                jax.random.PRNGKey(seed))
    return state, S, z, slot, matched, slot_new, ok


def _k5_args(state, S, z, slot, matched, slot_new, ok, device="cpu"):
    i32 = torch.int32
    return (_t(state.xv, device), _t(state.logw, device),
            _t(state.lm, device), _t(state.lm_P, device),
            _t(S, device).to(i32), _t(z, device),
            _t(slot, device).to(i32), _t(matched, device),
            _t(slot_new, device).to(i32), _t(ok, device), R,
            _t(state.n, device).to(i32))


# ---------------------------------------------------------------------------
# K5's twin
# ---------------------------------------------------------------------------

def test_k5_twin_matches_fs1_resample_update_tpu():
    state, S, *batch = _update_batch()
    assert not np.array_equal(S, np.arange(1, S.shape[0] + 1))
    want = jkernels.fs1_resample_update_tpu(
        state, jnp.asarray(S), jkernels.deferred_bounds_meta(jnp.asarray(S)),
        *batch, jnp.asarray(R), interpret=True)
    args = _k5_args(state, S, *batch)
    lm0 = args[2].clone()
    lm, lm_P = tkernels.resample_update_plain(*args)
    np.testing.assert_allclose(args[1].numpy(), np.asarray(want.logw),
                               **TOL)
    np.testing.assert_allclose(lm.numpy(), np.asarray(want.lm), **TOL)
    np.testing.assert_allclose(lm_P.numpy(), np.asarray(want.lm_P), **TOL)
    assert torch.equal(args[2], lm0)        # fresh outputs, old kept


def test_k5_wrapper_runs_the_twin_on_cpu():
    tk.reset_launch_counts()
    state, S, *batch = _update_batch(P=512)
    a1, a2 = _k5_args(state, S, *batch), _k5_args(state, S, *batch)
    for g, w in zip(tk.resample_update(*a1),
                    tkernels.resample_update_plain(*a2)):
        assert torch.equal(g, w)
    assert torch.equal(a1[1], a2[1])
    assert tk.launch_counts()["K5"] == 0


# ---------------------------------------------------------------------------
# fs1_update_deferred against JAX, over rounds
# ---------------------------------------------------------------------------

# Rounds 0 and 1 see no landmark mapped before them, so they leave the
# weights equal and their gates hold whatever the threshold.
@pytest.mark.parametrize("n_min_fracs", [
    (0.0, 0.0, 0.999, 0.999, 0.0, 0.999),
    (0.0, 0.0, 0.0),
], ids=["fires-holds", "never-fires"])
def test_deferred_rounds_match_jax(n_min_fracs, monkeypatch):
    P, L, n_map, K = 1024, 16, 24, 5
    rng = np.random.default_rng(7)
    jps = _jax_state(P, L, n_map, seed=7)
    lo, nch, ident = jkernels.identity_bounds_meta(P)
    jd = jfs1.DeferredState(ps=jps, S=jnp.arange(1, P + 1, dtype=jnp.int32),
                            lo=lo, nch=nch, ident=ident)
    td = deferred_state_from_numpy({"ps": _as_numpy(jps),
                                    "S": np.asarray(jd.S)}, device="cpu")
    assert not td.pending
    jR = jnp.asarray(R)
    identity = np.arange(1, P + 1)
    fired = []
    for t, frac in enumerate(n_min_fracs):
        z, ids, zmask = _obs_round(rng, n_map, K)
        key = jax.random.key(100 + t)
        # Perturb poses so the weights spread (drives the Neff gate).
        dxv = rng.normal(size=(3, P)).astype(np.float32) * 0.05
        jd = jd._replace(ps=jd.ps._replace(xv=jd.ps.xv + dxv))
        td = td._replace(ps=td.ps._replace(xv=td.ps.xv + _t(dxv)))
        n_min = float(np.float32(frac * P))
        jargs = (jnp.asarray(z), jnp.asarray(ids), jnp.asarray(zmask), jR,
                 jnp.float32(n_min))

        # JAX's prefix sum and dither for this round, injected.
        held = jfs1.fs1_update_deferred(jd, key, *jargs, do_resample=False,
                                        interpret=True)
        csum = np.asarray(jrs._cumsum_2d(jnp.exp(held.ps.logw)))
        U = _t(jrs._uniform_at(key, jnp.arange(P, dtype=jnp.int32)))
        monkeypatch.setattr(trs, "cumulative_weights",
                            lambda logw_n, c=csum: _t(c))

        jd = jfs1.fs1_update_deferred(jd, key, *jargs, interpret=True)
        td = tfs1.fs1_update_deferred(td, _t(z), _t(ids), _t(zmask), R,
                                      n_min, lambda pos, U=U: U[pos])
        fired.append(not np.array_equal(np.asarray(jd.S), identity))
        assert td.pending == fired[-1], t
        np.testing.assert_array_equal(td.S.numpy(), np.asarray(jd.S))

    assert fired == [f > 0 for f in n_min_fracs]
    got = state_to_numpy(tfs1.finalize_deferred(td))
    want = _as_numpy(jfs1.finalize_deferred(jd, interpret=True))
    for f in ("n", "da_table"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in ("logw", "xv", "lm"):
        np.testing.assert_allclose(got[f], want[f], rtol=1e-4, atol=1e-5,
                                   err_msg=f)
    np.testing.assert_allclose(got["lm_P"], want["lm_P"], rtol=1e-3,
                               atol=1e-5)
    assert int(got["n"]) > 0


# ---------------------------------------------------------------------------
# The Runner
# ---------------------------------------------------------------------------

def _scene():
    """The config and map of tests/test_deferred.py's Runner test."""
    cfg = SlamConfig(SWITCH_HEADING_KNOWN=0, max_landmarks=16,
                     max_observations=8, NPARTICLES=1024, NEFFECTIVE=768)
    return cfg, synthetic_map(16, 9, radius=40.0, seed=2)


def test_runner_deferred_matches_eager(monkeypatch):
    """Same generator draws, and K5's twin is G2's then K4's: the
    deferred run equals the eager one bit for bit on the CPU."""
    cfg, slam_map = _scene()
    fires = []
    k5 = tkernels.resample_update
    monkeypatch.setattr(tkernels, "resample_update",
                        lambda *a: fires.append(1) or k5(*a))
    r_e = Runner(cfg, slam_map, "FASTSLAM1", n_particles=1024,
                 device="cpu").run(seed=3, n_ticks=200)
    est = tfs1.FastSlam1Deferred(cfg, slam_map.n_landmarks, device="cpu",
                                 fused_predict=False)
    r_d = Runner(cfg, slam_map, "FASTSLAM1", n_particles=1024,
                 estimator=est).run(seed=3, n_ticks=200)
    assert len(fires) >= 2
    assert r_d.host_syncs == len(r_d.active)   # the gate, once a superstep
    np.testing.assert_array_equal(r_d.est_pose, r_e.est_pose)
    got = state_to_numpy(est.finalize(r_d.final_state))
    want = state_to_numpy(r_e.final_state)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.mark.parametrize("estimator,P,multi", [
    ("deferred", 1024, True),
    ("deferred", 512, False),
    ("deferred-per-tick", 1024, False),
    ("eager", 1024, False),
])
def test_multi_tick_predict_dispatch(estimator, P, multi):
    """predict_multi exactly when the estimator has it and P % 1024 == 0,
    as the JAX runner dispatches; otherwise the per-tick predict."""
    cfg, slam_map = _scene()
    if estimator == "eager":
        est = tfs1.FastSlam1(cfg, slam_map.n_landmarks, device="cpu")
    else:
        est = tfs1.FastSlam1Deferred(
            cfg, slam_map.n_landmarks, device="cpu",
            fused_predict=estimator == "deferred")
    calls = {"predict": 0, "predict_multi": 0}
    for name in calls:
        if hasattr(est, name):
            fn = getattr(est, name)

            def counted(*a, fn=fn, name=name):
                calls[name] += 1
                return fn(*a)
            setattr(est, name, counted)
    result = Runner(cfg, slam_map, "FASTSLAM1", n_particles=P,
                    estimator=est).run(seed=3, n_ticks=16)
    assert np.isfinite(result.est_pose).all()
    if multi:
        assert calls == {"predict": 0, "predict_multi": 2}
    else:
        assert calls == {"predict": 16, "predict_multi": 0}


def test_deferred_refuses_unaligned_particle_counts():
    cfg, slam_map = _scene()
    est = tfs1.FastSlam1Deferred(cfg, slam_map.n_landmarks, device="cpu")
    with pytest.raises(ValueError, match="multiple of 512"):
        est.init(768)


def test_runner_refuses_an_estimator_on_another_device():
    cfg, slam_map = _scene()
    est = tfs1.FastSlam1Deferred(cfg, slam_map.n_landmarks, device="cpu")
    with pytest.raises(ValueError, match="estimator is on"):
        Runner(cfg, slam_map, estimator=est, device="meta")


# ---------------------------------------------------------------------------
# A drive against JAX, superstep by superstep
# ---------------------------------------------------------------------------

DRIVE_SUPERSTEPS = 16
TOL_DRIVE = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def stream():
    """ring40's JAX simulator, seed 3, from the first superstep whose
    observation batch sees three landmarks: the true pose before it,
    then for each of DRIVE_SUPERSTEPS supersteps the noisy controls of
    its ticks [T, 2] and its batch (z, ids, mask) as numpy (the stream of
    test_torch_fastslam1.py's drive)."""
    import os

    from slam_tpu.config import SlamConfig as JSlamConfig
    from slam_tpu.maps import read_map_file
    from slam_tpu.sim.simulator import Simulator as JSimulator

    data = os.path.join(os.path.dirname(__file__), os.pardir, "data")
    cfg = JSlamConfig.from_ini(os.path.join(data, "ring40.ini"))
    slam_map = read_map_file(os.path.join(data, "ring40.mat"))
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


def test_deferred_drive_matches_jax(stream, monkeypatch):
    """16 supersteps of FastSlam1Deferred's update at P = 512 (K5's and
    K4's twins, G2's), each package on its own carry from the same start
    (every particle at the true pose, nothing mapped), on one
    observation stream, the JAX side as tests/test_deferred.py runs it
    (interpret mode). Injected: the motion noise from one numpy draw,
    JAX's stratified dither and prefix sum. After each superstep: the
    gate, the offspring bounds (the ancestors) and n, da_table exactly;
    weights, poses and planes (pending permutation included) at
    TOL_DRIVE. The resample fires and holds along the way; then both
    finalized states."""
    from slam_tpu.models import rbpf as jrbpf
    from slam_tpu_torch.models import rbpf as trbpf

    cfg, slam_map, pose, steps = stream
    P = 512
    n_map = slam_map.n_landmarks
    L = -(-n_map // 8) * 8
    jps = jinit(P, L, n_map)._replace(
        xv=jnp.asarray(np.repeat(pose[:, None], P, axis=1)))
    lo, nch, ident = jkernels.identity_bounds_meta(P)
    jd = jfs1.DeferredState(ps=jps, S=jnp.arange(1, P + 1, dtype=jnp.int32),
                            lo=lo, nch=nch, ident=ident)
    td = deferred_state_from_numpy({"ps": _as_numpy(jps),
                                    "S": np.asarray(jd.S)}, device="cpu")
    R = np.diag(np.asarray(cfg.Re, np.float32))
    n_min = float(cfg.NEFFECTIVE * P / cfg.NPARTICLES)
    sig = np.sqrt(np.asarray(cfg.Qe, np.float32))
    rng = np.random.default_rng(P)

    bounds = jfs1.deferred_resample_bounds
    pre = []

    def spy(logw, key, n_min, do_resample):
        pre.append(logw)
        return bounds(logw, key, n_min, do_resample)
    monkeypatch.setattr(jfs1, "deferred_resample_bounds", spy)

    @jax.jit
    def jax_update(jd, key, z, ids, zmask, n_min):
        """JAX's update, and what the port is fed: the prefix sum and
        dither of its resample, and its gate."""
        pre.clear()
        post = jfs1.fs1_update_deferred(jd, key, z, ids, zmask,
                                        jnp.asarray(R), n_min,
                                        interpret=True)
        logw_n = jrs.normalize_log_weights(pre[0])
        return dict(post=post, need=jrs.effective_particles(logw_n) < n_min,
                    csum=jrs._cumsum_2d(jnp.exp(logw_n)),
                    U=jrs._uniform_at(key, jnp.arange(P, dtype=jnp.int32)))

    @jax.jit
    def jax_predict(xv, V, G):
        for t in range(V.shape[0]):
            xv = jrbpf.propagate_poses(xv, V[t], G[t], cfg.WHEELBASE,
                                       cfg.DT_CONTROLS)
        return xv

    csum = {}
    monkeypatch.setattr(trs, "cumulative_weights", lambda logw: csum["now"])
    gates = []
    for i, (ctl, (z, ids, zmask)) in enumerate(steps):
        T = ctl.shape[0]
        V = (ctl[:, 0:1] + rng.normal(size=(T, P)) * sig[0]).astype(
            np.float32)
        G = (ctl[:, 1:2] + rng.normal(size=(T, P)) * sig[1]).astype(
            np.float32)
        jd = jd._replace(ps=jd.ps._replace(xv=jax_predict(
            jd.ps.xv, jnp.asarray(V), jnp.asarray(G))))
        txv = td.ps.xv
        for t in range(T):
            txv = trbpf.propagate_poses(txv, _t(V[t]), _t(G[t]),
                                        cfg.WHEELBASE, cfg.DT_CONTROLS)
        td = td._replace(ps=td.ps._replace(xv=txv))

        want = jax_update(jd, jax.random.key(100 + i), jnp.asarray(z),
                          jnp.asarray(ids), jnp.asarray(zmask),
                          jnp.float32(n_min))
        csum["now"] = _t(want["csum"])
        U = _t(want["U"])
        td = tfs1.fs1_update_deferred(td, _t(z), _t(ids), _t(zmask), R,
                                      n_min, lambda pos, U=U: U[pos])
        jd = want["post"]

        need = bool(want["need"])
        gates.append(need)
        assert td.pending == need, f"superstep {i}: gate"
        np.testing.assert_array_equal(td.S.numpy(), np.asarray(jd.S),
                                      err_msg=f"superstep {i}: bounds")
        got, exp = state_to_numpy(td.ps), _as_numpy(jd.ps)
        for f in ("logw", "xv", "lm", "lm_P"):
            np.testing.assert_allclose(got[f], exp[f], **TOL_DRIVE,
                                       err_msg=f"superstep {i}: {f}")
        for f in ("n", "da_table"):
            np.testing.assert_array_equal(got[f], exp[f],
                                          err_msg=f"superstep {i}: {f}")
    assert True in gates and False in gates
    got = state_to_numpy(tfs1.finalize_deferred(td))
    exp = _as_numpy(jfs1.finalize_deferred(jd, interpret=True))
    for f in ("logw", "xv", "lm", "lm_P"):
        np.testing.assert_allclose(got[f], exp[f], **TOL_DRIVE, err_msg=f)
    for f in ("n", "da_table"):
        np.testing.assert_array_equal(got[f], exp[f], err_msg=f)
    assert int(got["n"]) >= 3


# ---------------------------------------------------------------------------
# Config #5 and the carry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(n_landmarks=10_000,
                                             capacity=192, max_obs=96)],
                         ids=["defaults", "single-chip"])
def test_config5_setup_matches_jax(kw):
    jcfg, jmap = jconfig5.config5_setup(**kw)
    tcfg, tmap = tconfig5.config5_setup(**kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    np.testing.assert_array_equal(tmap.landmarks, jmap.landmarks)
    np.testing.assert_array_equal(tmap.waypoints, jmap.waypoints)


@pytest.mark.parametrize("pending", [True, False])
def test_deferred_state_numpy_round_trip_is_exact(pending):
    state, S, *_ = _update_batch(P=512)
    if not pending:
        S = np.arange(1, 513, dtype=np.int32)
    lo, nch, ident = jkernels.deferred_bounds_meta(jnp.asarray(S))
    jd = jfs1.DeferredState(ps=state, S=jnp.asarray(S), lo=lo, nch=nch,
                            ident=ident)
    arrays = {"ps": _as_numpy(jd.ps), "S": np.asarray(jd.S), "lo": lo,
              "nch": nch, "ident": ident}
    td = deferred_state_from_numpy(arrays, device="cpu")
    assert td.pending == pending
    back = deferred_state_to_numpy(td)
    np.testing.assert_array_equal(back["S"], S)
    assert back["S"].dtype == np.int32
    for f in FIELDS:
        assert back["ps"][f].dtype == arrays["ps"][f].dtype, f
        np.testing.assert_array_equal(back["ps"][f], arrays["ps"][f],
                                      err_msg=f)
    again = deferred_state_from_numpy(back, device="cpu")
    assert again.pending == pending and torch.equal(again.S, td.S)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fired", [True, False])
def test_k5_kernel_matches_twin_on_card(cuda, fired):
    state, S, *batch = _update_batch(P=2048)
    if not fired:
        S = np.arange(1, 2049, dtype=np.int32)
    a1 = _k5_args(state, S, *batch, device=cuda)
    a2 = _k5_args(state, S, *batch, device=cuda)
    before = tk.resample_update.launches
    got = tk.resample_update(*a1)
    assert tk.resample_update.launches == before + 1
    want = tkernels.resample_update_plain(*a2)
    for g, w in zip((a1[1], *got), (a2[1], *want)):
        torch.testing.assert_close(g, w, **TOL)


# K5's tiles, as in csrc/resample_update.cu (kTile, kStageWidth).
K5_TILE, K5_STAGE_WIDTH = tkernels.K5_TILE, 768
K5_EDGE_CASES = ("one ancestor", "identity but one tile", "wide run", "L=40",
                 "no matched observation", "one landmark observed twice")


def _k5_edge_case(case, P=8192, seed=5):
    """K5 inputs (numpy) for one edge case at P particles: the landmark
    state, an observation batch run through the port's association,
    and offspring bounds S built from a chosen ancestor vector."""
    from slam_tpu_torch.models import rbpf as trbpf
    from slam_tpu_torch.models.particles import init_particles

    rng = np.random.default_rng(seed)
    L = 40 if case == "L=40" else 192
    n_map, live, n_new = 2 * L, L // 2, 3
    n_match = 0 if case == "no matched observation" else 8
    K = n_match + n_new + 1
    table = np.full(n_map, -1, np.int32)
    table[:live] = rng.permutation(live)
    truth = rng.uniform(-20.0, 20.0, size=(n_map, 2))
    lm = np.zeros((2, L, P), np.float32)
    lm[:, table[:live]] = truth[:live].T[:, :, None]
    lm += rng.normal(size=(2, L, P)).astype(np.float32) * 0.2
    lm_P = np.zeros((3, L, P), np.float32)
    lm_P[0, :live], lm_P[1, :live], lm_P[2, :live] = 0.05, 0.01, 0.04
    seen = rng.choice(live, n_match, replace=False)
    if case == "one landmark observed twice":
        seen[1] = seen[0]
    ids = np.concatenate([seen, np.arange(live, live + n_new),
                          rng.choice(live, 1)]).astype(np.int32)
    state = init_particles(1, L, n_map, device="cpu")._replace(
        n=torch.tensor(live, dtype=torch.int32),
        da_table=torch.tensor(table))
    zmask = torch.tensor(np.arange(K) < n_match + n_new)
    assoc, is_new = trbpf.associate_known(state, torch.tensor(ids), zmask)
    matched = assoc >= 0
    slot = torch.where(matched, assoc, 0).to(torch.int32)
    slot_new, ok = trbpf.new_slots(state, is_new)
    d = truth[ids]
    z = np.column_stack([np.hypot(d[:, 0], d[:, 1]),
                         np.arctan2(d[:, 1], d[:, 0])]).astype(np.float32)

    anc = np.sort(rng.integers(0, P, P))
    if case == "one ancestor":
        anc[:] = P // 3 + 1
    elif case == "identity but one tile":
        j0 = 5 * K5_TILE
        anc = np.arange(P)
        anc[j0:j0 + K5_TILE] = np.sort(rng.integers(j0, j0 + K5_TILE,
                                                    K5_TILE))
    elif case == "wide run":
        anc[:K5_TILE] = 8 * np.arange(K5_TILE)
        anc[K5_TILE:] = np.sort(rng.integers(8 * K5_TILE, P, P - K5_TILE))
    S = np.searchsorted(anc, np.arange(P), side="right").astype(np.int32)
    xv = (rng.normal(size=(3, P)) * 0.1).astype(np.float32)
    logw = rng.normal(size=P).astype(np.float32)
    return dict(xv=xv, logw=logw, lm=lm, lm_P=lm_P, S=S, z=z,
                slot=slot.numpy(), matched=matched.numpy(),
                slot_new=slot_new.numpy(), ok=ok.numpy(), anc=anc,
                n=np.int32(live))


def _k5_tile_runs(anc):
    """Per tile of K5: its ancestor run widened to 16-byte edges."""
    first, last = anc[::K5_TILE], anc[K5_TILE - 1::K5_TILE]
    return ((last | 3) + 1) - (first & ~3)


def _k5_case_args(c, device):
    return (_t(c["xv"], device), _t(c["logw"], device), _t(c["lm"], device),
            _t(c["lm_P"], device), _t(c["S"], device), _t(c["z"], device),
            _t(c["slot"], device), _t(c["matched"], device),
            _t(c["slot_new"], device), _t(c["ok"], device), R,
            _t(c["n"], device))


@pytest.mark.parametrize("case", K5_EDGE_CASES)
def test_k5_edge_cases_are_what_they_say(case):
    """The inputs the card's K5 edge cases run: valid bounds that decode
    to the intended ancestors, the intended association, and on the CPU
    the wrapper's twin updates them."""
    c = _k5_edge_case(case)
    P = c["S"].shape[0]
    assert c["S"][-1] == P and np.all(np.diff(c["S"]) >= 0)
    anc = trs.ancestors_from_bounds(torch.tensor(c["S"]), P).numpy()
    np.testing.assert_array_equal(anc, c["anc"])
    runs = _k5_tile_runs(anc)
    n_match = int(c["matched"].sum())
    slots = c["slot"][c["matched"]]
    assert (n_match == 0) == (case == "no matched observation")
    assert (len(set(slots)) < n_match) == (case == "one landmark observed "
                                           "twice")
    assert int(c["ok"].sum()) == 3
    if case == "one ancestor":
        assert len(set(anc)) == 1 and np.all(runs <= K5_STAGE_WIDTH)
    elif case == "identity but one tile":
        tiles = anc.reshape(-1, K5_TILE) != np.arange(P).reshape(-1, K5_TILE)
        assert np.flatnonzero(tiles.any(axis=1)).tolist() == [5]
    elif case == "wide run":
        assert runs[0] > K5_STAGE_WIDTH and np.all(runs[1:] <= K5_STAGE_WIDTH)
    args = _k5_case_args(c, "cpu")
    lm0 = args[2].clone()
    lm, lm_P = tk.resample_update(*args)
    assert lm.shape == lm0.shape and torch.isfinite(lm).all()
    assert torch.isfinite(lm_P).all() and torch.isfinite(args[1]).all()
    assert torch.equal(args[2], lm0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", K5_EDGE_CASES)
def test_k5_edge_cases_on_card(cuda, case):
    """K5 on each edge case: bit-equal to G2's gather followed by K4
    with the empty rows zeroed (one operation order) and across its
    staged and direct branches, and within TOL of its twin; for the
    landmark observed twice the twin computes both updates from the old
    values, so only the first two hold. The rows past n hold noise,
    which K5 neither reads nor keeps."""
    c = _k5_edge_case(case)
    runs = [_k5_case_args(c, cuda) for _ in range(4)]
    L, P = c["lm"].shape[1], c["lm"].shape[2]
    got = tk.resample_update(*runs[0])
    direct = tkernels.resample_update_launch(*runs[1], staged=False)
    xv, logw, lm, lm_P, S, *batch, _, n = runs[2]
    lm_g, lmP_g = tk.bounds_gather_multi(
        [lm.reshape(2 * L, P), lm_P.reshape(3 * L, P)], S)
    lm_g, lmP_g = lm_g.reshape(2, L, P), lmP_g.reshape(3, L, P)
    tk.fused_update(xv, logw, lm_g, lmP_g, *batch, R)
    tkernels.zero_empty_rows(lm_g, lmP_g, n, *batch[1:])
    torch.cuda.synchronize()
    for ref in ((runs[1][1], *direct), (logw, lm_g, lmP_g)):
        for g, w in zip((runs[0][1], *got), ref):
            assert torch.equal(g, w)
    if case != "one landmark observed twice":
        want = tkernels.resample_update_plain(*runs[3])
        for g, w in zip((runs[0][1], *got), (runs[3][1], *want)):
            torch.testing.assert_close(g, w, **TOL)
