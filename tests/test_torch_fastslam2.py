"""The port's FastSLAM 2 against the JAX package's, and K1, K3 and K6b.

- The plane functions of the pose covariance (sym3_*, chol3_mul_vec,
  log_gauss3_planes, refine_pose_planes) on random SPD planes.
- The predict: ``fs2_predict`` and K6b's twin, noise off, against 8 JAX
  ``fs2_predict`` steps and the TPU kernel in interpret mode; K6b's twin
  with the noise on against a reference built from ``normal_pair``, bit
  for bit.
- K3's twin against JAX's ``_refine_proposal`` and ``fs2_refine_tpu`` in
  interpret mode, on the fixture of tests/test_pallas.py; K1's twin
  against ``jacobians_tpu`` in interpret mode.
- One ``fs2_update`` round against JAX's (use_pallas=False) on
  data/ring40, at P = 64 (K2 + G1) and P = 512 (K4 + G2), the resample
  gate firing and holding, with JAX's proposal draw and stratified
  dither injected.
- A drive: both packages' FastSLAM 2 superstep (predict and
  ``fs2_update``) for 24 supersteps on ring40's JAX observation stream,
  each on its own state, at P = 64 and 512, with one numpy draw of
  motion noise and JAX's proposal draw, dither and prefix sum injected.
- On a card, K1, K3 and K6b against their twins.

Tolerances, each with its reason:

- plane functions, predict poses, K1: rtol 1e-5, atol 1e-5 (float32
  rounding of the two frameworks' libm and elementwise ops); the
  predicted covariances at rtol 1e-4, atol 1e-6, as tests/test_deferred.py
  holds the TPU kernel to the jnp steps;
- K3 and the update round: xv and lm at rtol 1e-4, atol 1e-5; Pv and
  lm_P at rtol 1e-3, atol 1e-6, the JAX package's own golden test of the
  refinement (tests/test_pallas.py): the chain over K observations
  compounds rounding;
- the update round's logw at rtol 1e-3, atol 1e-5: the prior / proposal
  term is a difference of two 3x3 quadratic forms through the adjugate
  of a pose covariance whose determinant is ~1e-13 after a superstep,
  which moves float32 rounding up to ~1.1e-4 relative (measured on the
  ring40 fixture below); in the drive at rtol 2e-3, since the weights
  sum that term over the supersteps between two resamples;
- n, da_table, the gate decision and the ancestors exactly.
"""

import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.config import SlamConfig as JSlamConfig
from slam_tpu.maps import read_map_file
from slam_tpu.models import fastslam2 as jfs2
from slam_tpu.models import rbpf as jrbpf
from slam_tpu.models.particles import init_particles as jinit
from slam_tpu.ops import planes as jpk
from slam_tpu.ops import resampling as jrs
from slam_tpu.ops.pallas import kernels as jkernels
from slam_tpu.sim.simulator import Simulator as JSimulator
from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.geometry import wrap_angle
from slam_tpu_torch.models import fastslam2 as tfs2
from slam_tpu_torch.models import rbpf as trbpf
from slam_tpu_torch.models.particles import (
    FIELDS,
    init_particles,
    state_from_numpy,
    state_to_numpy,
)
from slam_tpu_torch.ops import kernels as tk
from slam_tpu_torch.ops import planes as tpk
from slam_tpu_torch.ops import resampling as trs
from slam_tpu_torch.ops.kernels import kernels as tkernels
from slam_tpu_torch.ops.kernels import predict as tp
from test_torch_fastslam1 import stream  # noqa: F401 (a fixture)

DATA = os.path.join(os.path.dirname(__file__), os.pardir, "data")
R = np.diag([0.01, 0.0003]).astype(np.float32)
Q = np.diag([0.09, 0.0025]).astype(np.float32)
WHEELBASE, DT = 4.0, 0.025
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_PV = dict(rtol=1e-4, atol=1e-6)
TOL_REFINE_XV = dict(rtol=1e-4, atol=1e-5)
TOL_REFINE_PV = dict(rtol=1e-3, atol=1e-6)
TOL_LOGW = dict(rtol=1e-3, atol=1e-5)

# The JAX side jitted, as the JAX package's FastSlam2 runs it: compiled
# once per particle count, where op-by-op dispatch compiles every
# primitive anew at each new shape.
_jax_predict = jax.jit(jfs2.fs2_predict,
                       static_argnames=("wheelbase", "dt", "add_noise"))
_jax_update = jax.jit(jfs2.fs2_update,
                      static_argnames=("do_resample", "use_pallas"))


def _t(a, device="cpu"):
    return torch.tensor(np.asarray(a), device=device)


def _as_numpy(state):
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


def _spd_planes(P, seed=0, scale=1.0):
    """Packed symmetric 3x3 planes of A A' + 0.05 I, A random."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(3, 3, P)) * scale
    M = np.einsum("ikp,jkp->ijp", A, A) + 0.05 * scale ** 2 * np.eye(3)[
        :, :, None]
    return [M[i, j].astype(np.float32)
            for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))]


def _vec(P, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=P).astype(np.float32) for _ in range(3)]


def _jac_planes(P, seed):
    """JacobianPlanes of both packages at random poses and landmarks."""
    rng = np.random.default_rng(seed)
    xv = rng.normal(size=(3, P)).astype(np.float32)
    lm = (xv[:2] + rng.normal(size=(2, P)) * 5 + 2).astype(np.float32)
    a = (rng.normal(size=P) * 0.3).astype(np.float32)
    pf = [a * a + 0.05, 0.2 * a, np.full(P, 0.07, np.float32)]
    args = [*xv, *lm, *pf]
    jJ = jpk.jacobians_planes(*map(jnp.asarray, args), *R[[0, 0, 1],
                                                          [0, 1, 1]])
    tJ = tpk.jacobians_planes(*map(_t, args), *tpk.sym2_host(R))
    return jJ, tJ


def _close(got, want, tol=TOL):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# Plane functions
# ---------------------------------------------------------------------------

def _plane_cases(name, P=300):
    P6 = _spd_planes(P, seed=1)
    Q6 = _spd_planes(P, seed=2, scale=0.1)
    v = _vec(P, seed=3)
    if name == "sym3_mul_vec":
        return (P6, *v), {}
    if name in ("sym3_quadform_inv", "log_gauss3_planes"):
        return (P6, *v), {"jitter": 1e-9}
    if name in ("sym3_inv", "sym3_chol"):
        return (P6,), {"jitter": 1e-9}
    if name == "sym3_add":
        return (P6, Q6), {}
    if name == "chol3_mul_vec":
        return (list(np.asarray(jpk.sym3_chol(tuple(map(jnp.asarray, P6))))),
                *v), {}
    raise AssertionError(name)


def _to(pkg, a):
    conv = jnp.asarray if pkg == "jax" else _t
    if isinstance(a, list):
        return tuple(conv(x) for x in a)
    return conv(a)


@pytest.mark.parametrize("name", ["sym3_mul_vec", "sym3_quadform_inv",
                                  "log_gauss3_planes", "sym3_inv",
                                  "sym3_add", "sym3_chol", "chol3_mul_vec"])
def test_sym3_plane_function_matches_jax(name):
    args, kw = _plane_cases(name)
    want = getattr(jpk, name)(*[_to("jax", a) for a in args], **kw)
    got = getattr(tpk, name)(*[_to("torch", a) for a in args], **kw)
    _close(got, want)


def test_sym3_chol_reproduces_the_matrix():
    P6 = [_t(p) for p in _spd_planes(64, seed=4)]
    l00, l10, l11, l20, l21, l22 = tpk.sym3_chol(tuple(P6), jitter=0.0)
    L = torch.zeros((64, 3, 3))
    L[:, 0, 0], L[:, 1, 0], L[:, 1, 1] = l00, l10, l11
    L[:, 2, 0], L[:, 2, 1], L[:, 2, 2] = l20, l21, l22
    M = L @ L.transpose(1, 2)
    for (i, j), p in zip(((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)),
                         P6):
        torch.testing.assert_close(M[:, i, j], p, rtol=1e-5, atol=1e-6)


def test_refine_pose_planes_matches_jax():
    P = 300
    jJ, tJ = _jac_planes(P, seed=5)
    # Pose covariances at the scale the predict accumulates between
    # observations (Q dt per tick), where the refinement runs.
    P6 = _spd_planes(P, seed=6, scale=0.03)
    rng = np.random.default_rng(7)
    v0, v1 = (rng.normal(size=P).astype(np.float32) * s for s in (0.1, 0.02))
    want = jpk.refine_pose_planes(jJ, tuple(map(jnp.asarray, P6)),
                                  jnp.asarray(v0), jnp.asarray(v1))
    got = tpk.refine_pose_planes(tJ, tuple(map(_t, P6)), _t(v0), _t(v1))
    _close(got[0], want[0])
    _close(got[1], want[1], TOL_PV)


# ---------------------------------------------------------------------------
# The predict: fs2_predict and K6b's twin
# ---------------------------------------------------------------------------

def _predict_fixture(P=512, seed=5, T=8):
    """The pose and covariance state of tests/test_deferred.py's K6b
    test, and T ticks of controls."""
    rng = np.random.default_rng(seed)
    xv = rng.normal(size=(3, P)).astype(np.float32)
    Pv = np.zeros((6, P), np.float32)
    Pv[0], Pv[3], Pv[5] = 0.02, 0.02, 0.01
    ctl = np.column_stack([rng.uniform(1, 4, T),
                           rng.uniform(-0.3, 0.3, T)]).astype(np.float32)
    return xv, Pv, ctl


def _jax_predict_steps(xv, Pv, ctl):
    P = xv.shape[1]
    state = jinit(P, 4, 4)._replace(xv=jnp.asarray(xv), Pv=jnp.asarray(Pv))
    for t in range(ctl.shape[0]):
        state = _jax_predict(state, jax.random.key(1), ctl[t, 0],
                                 ctl[t, 1], jnp.asarray(Q),
                                 wheelbase=WHEELBASE, dt=DT,
                                 add_noise=False)
    return np.asarray(state.xv), np.asarray(state.Pv)


def test_fs2_predict_noise_off_matches_jax():
    xv, Pv, ctl = _predict_fixture()
    want_xv, want_Pv = _jax_predict_steps(xv, Pv, ctl)
    state = init_particles(xv.shape[1], 4, 4, device="cpu")._replace(xv=_t(xv),
                                                       Pv=_t(Pv))
    g = torch.Generator().manual_seed(0)
    for t in range(ctl.shape[0]):
        state = tfs2.fs2_predict(state, g, _t(ctl[t, 0]), _t(ctl[t, 1]), Q,
                                 wheelbase=WHEELBASE, dt=DT,
                                 add_noise=False)
    np.testing.assert_allclose(state.xv.numpy(), want_xv, **TOL)
    np.testing.assert_allclose(state.Pv.numpy(), want_Pv, **TOL_PV)


def _check_k6b_twin_noise_off_against_jax(T):
    """The twin against T JAX fs2_predict steps and against the TPU
    kernel in interpret mode (its noise-off arm, which runs on the CPU);
    T = 8 is the superstep's tick count, 3 and 11 are no multiple of
    the unrolling of the CUDA kernel's tick loop."""
    xv, Pv, ctl = _predict_fixture(T=T)
    want_xv, want_Pv = _jax_predict_steps(xv, Pv, ctl)
    k_xv, k_Pv = jkernels.fs2_predict_multi_tpu(
        jnp.asarray(xv), jnp.asarray(Pv), jax.random.key(0),
        jnp.asarray(ctl), jnp.asarray(Q), wheelbase=WHEELBASE, dt=DT,
        add_noise=False, interpret=True)
    got_xv, got_Pv = _t(xv), _t(Pv)
    out = tp.fs2_predict_multi_plain(got_xv, got_Pv, _t([1, 2]).int(),
                                     _t(ctl), Q, wheelbase=WHEELBASE, dt=DT,
                                     add_noise=False)
    assert out[0] is got_xv and out[1] is got_Pv      # in place
    for w_xv, w_Pv in ((want_xv, want_Pv), (k_xv, k_Pv)):
        np.testing.assert_allclose(got_xv.numpy(), np.asarray(w_xv), **TOL)
        np.testing.assert_allclose(got_Pv.numpy(), np.asarray(w_Pv),
                                   **TOL_PV)


def test_k6b_twin_noise_off_matches_jax():
    _check_k6b_twin_noise_off_against_jax(8)


@pytest.mark.parametrize("T", [3, 11])
def test_k6b_twin_noise_off_matches_jax_at_other_tick_counts(T):
    _check_k6b_twin_noise_off_against_jax(T)


def test_k6b_twin_noise_on_is_normal_pair_draw_for_draw():
    """Bit for bit against a reference built from normal_pair and the
    per-tick step; its poses are K6's on the same seed."""
    xv, Pv, ctl = _predict_fixture(P=1024, seed=8)
    seed = _t([-77, 123456]).int()
    l00, l10, l11 = trbpf.control_noise_factor(Q)
    ref_xv, ref_Pv = _t(xv), _t(Pv)
    for t in range(ctl.shape[0]):
        e0, e1 = tp.normal_pair(xv.shape[1], t, seed)
        V = _t(ctl[t, 0]) + l00 * e0
        G = _t(ctl[t, 1]) + l10 * e0 + l11 * e1
        ref_xv, ref_Pv = tfs2.propagate_pose_covariance(
            ref_xv, ref_Pv, V, G, Q, WHEELBASE, DT)
    got_xv, got_Pv = tp.fs2_predict_multi_plain(
        _t(xv), _t(Pv), seed, _t(ctl), Q, wheelbase=WHEELBASE, dt=DT)
    assert torch.equal(got_xv, ref_xv) and torch.equal(got_Pv, ref_Pv)
    fs1 = tp.fs1_predict_multi_plain(_t(xv), seed, _t(ctl), Q,
                                     wheelbase=WHEELBASE, dt=DT)
    assert torch.equal(got_xv, fs1)
    assert not torch.equal(got_xv, tp.fs2_predict_multi_plain(
        _t(xv), _t(Pv), seed, _t(ctl), Q, wheelbase=WHEELBASE, dt=DT,
        add_noise=False)[0])


# ---------------------------------------------------------------------------
# K1 and K3: the twins against the JAX kernels
# ---------------------------------------------------------------------------

def test_k1_twin_matches_jacobians_tpu():
    """The fixture of tests/test_pallas.py's Jacobian golden test."""
    rng = np.random.default_rng(0)
    P, K = 300, 5
    xv = rng.normal(size=(3, P)).astype(np.float32)
    lmx = (xv[0] + rng.normal(size=(K, P)) * 5 + 2).astype(np.float32)
    lmy = (xv[1] + rng.normal(size=(K, P)) * 5 + 1).astype(np.float32)
    A = rng.normal(size=(K, P)).astype(np.float32) * 0.3
    B = rng.normal(size=(K, P)).astype(np.float32) * 0.3
    planes = [lmx, lmy, A * A + 0.05, 0.3 * A * B, B * B + 0.05]
    want = jkernels.jacobians_tpu(jnp.asarray(xv),
                                  *map(jnp.asarray, planes),
                                  jnp.asarray(R), interpret=True)
    tk.reset_launch_counts()
    got = tk.jacobians(_t(xv), *map(_t, planes), R)
    assert tk.launch_counts()["K1"] == 0
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        assert g.shape == (K, P), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


def _refine_fixture():
    """tests/test_pallas.py's golden fixture of the refinement: P = 220,
    L = 8, K = 5, two unmatched slots."""
    P, L, K = 220, 8, 5
    rng = np.random.default_rng(11)
    state = jinit(P, L, L)
    lm = rng.normal(size=(2, L, P)).astype(np.float32) * 5
    lm_P = np.zeros((3, L, P), np.float32)
    lm_P[0] = 0.1
    lm_P[2] = 0.1
    Pv = np.zeros((6, P), np.float32)
    Pv[0] = 0.02
    Pv[3] = 0.02
    Pv[5] = 0.01
    state = state._replace(
        xv=jnp.asarray(rng.normal(size=(3, P)).astype(np.float32) * 0.1),
        Pv=jnp.asarray(Pv),
        lm=jnp.asarray(lm), lm_P=jnp.asarray(lm_P), n=jnp.int32(L))
    z = jnp.asarray(
        np.column_stack([rng.uniform(3, 8, K),
                         rng.uniform(-0.5, 0.5, K)]).astype(np.float32))
    slot = jnp.asarray(np.array([1, 3, 0, 6, 2], np.int32))
    matched = jnp.asarray(np.array([True, False, True, True, False]))
    return state, z, slot, matched


def test_k3_twin_matches_refine_proposal_and_tpu_kernel():
    state, z, slot, matched = _refine_fixture()
    gathered = jrbpf.gather_landmarks(state, slot)
    want_jnp = jfs2._refine_proposal(state, z, matched, gathered,
                                     jnp.asarray(R))
    want_tpu = jkernels.fs2_refine_tpu(state.xv, state.Pv, *gathered, z,
                                       matched, jnp.asarray(R),
                                       interpret=True)
    ts = state_from_numpy(_as_numpy(state), device="cpu")
    tg = trbpf.gather_landmarks(ts, _t(slot))
    tk.reset_launch_counts()
    got = tfs2._refine_proposal(ts, _t(z), _t(matched), tg, R)
    assert tk.launch_counts()["K3"] == 0               # CPU: the twin
    plain = tkernels.fs2_refine_plain(ts.xv, ts.Pv, *tg, _t(z),
                                      _t(matched), R)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    for want in (want_jnp, want_tpu):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   **TOL_REFINE_XV)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   **TOL_REFINE_PV)
    # The inputs are not written, and the refinement moved the state.
    assert torch.equal(ts.xv, _t(state.xv))
    assert not torch.equal(got[1], ts.Pv)


def test_k3_twin_passes_unmatched_slots_through():
    state, z, slot, _ = _refine_fixture()
    ts = state_from_numpy(_as_numpy(state), device="cpu")
    tg = trbpf.gather_landmarks(ts, _t(slot))
    none = torch.zeros(z.shape[0], dtype=torch.bool)
    xv_r, Pv_r = tkernels.fs2_refine_plain(ts.xv, ts.Pv, *tg, _t(z), none,
                                           R)
    assert torch.equal(xv_r, ts.xv) and torch.equal(Pv_r, ts.Pv)


# ---------------------------------------------------------------------------
# One fs2_update round against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    """ring40 config and map, and the first JAX observation batch (on
    the superstep grid) that sees at least four landmarks."""
    cfg = JSlamConfig.from_ini(os.path.join(DATA, "ring40.ini"))
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
    hidden ones) mapped, poses and maps scattered around the truth,
    uneven weights, Pv zero as after an observation."""
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


def _predicted(cfg, jstate, tstate):
    """8 noise-off predict ticks on both sides, from Pv = 0: the
    covariance the refinement meets after a superstep."""
    Qd = np.diag(np.asarray(cfg.Qe, np.float32))
    g = torch.Generator().manual_seed(0)
    for t in range(8):
        vn, gn = np.float32(cfg.V), np.float32(0.02 * (t - 3))
        jstate = _jax_predict(jstate, jax.random.key(t), vn, gn,
                                  jnp.asarray(Qd), wheelbase=cfg.WHEELBASE,
                                  dt=cfg.DT_CONTROLS, add_noise=False)
        tstate = tfs2.fs2_predict(tstate, g, _t(vn), _t(gn), Qd,
                                  wheelbase=cfg.WHEELBASE,
                                  dt=cfg.DT_CONTROLS, add_noise=False)
    np.testing.assert_allclose(tstate.xv.numpy(), np.asarray(jstate.xv),
                               **TOL)
    np.testing.assert_allclose(tstate.Pv.numpy(), np.asarray(jstate.Pv),
                               **TOL_PV)
    return jstate, tstate


@pytest.mark.parametrize("P", [64, 512], ids=["K2-G1", "K4-G2"])
@pytest.mark.parametrize("gate", ["fires", "holds"])
def test_fs2_update_matches_jax(scene, P, gate, monkeypatch):
    cfg, slam_map, pose, obs = scene
    jstate = _jax_state(cfg, slam_map, pose, obs, P)
    jstate, tstate = _predicted(cfg, jstate,
                                state_from_numpy(_as_numpy(jstate),
                                                 device="cpu"))
    assert float(np.abs(np.asarray(jstate.Pv)).max()) > 0

    n_min = float(P) if gate == "fires" else 0.0
    key = jax.random.PRNGKey(11)
    z, ids, zmask = (np.asarray(a) for a in (obs.z, obs.ids, obs.mask))
    jargs = (jnp.asarray(z), jnp.asarray(ids), jnp.asarray(zmask),
             jnp.asarray(R), jnp.float32(n_min))
    want = _jax_update(jstate, key, *jargs, use_pallas=False)
    # JAX's draws: fs2_update splits its key into the resample's key and
    # the proposal's; the proposal's normal draw is made from the second.
    rkey, sub = jax.random.split(key)
    eps = torch.tensor(np.asarray(jax.random.normal(sub, (3, P),
                                                    dtype=jnp.float32)))
    logw_n = _jax_update(jstate, key, *jargs, do_resample=False,
                             use_pallas=False).logw
    need = bool(jrs.effective_particles(logw_n) < n_min)
    assert need == (gate == "fires")
    csum = np.asarray(jrs._cumsum_2d(jnp.exp(
        jrs.normalize_log_weights(logw_n))))
    U = torch.tensor(np.asarray(jrs._uniform_at(
        rkey, jnp.arange(P, dtype=jnp.int32))))
    monkeypatch.setattr(trs, "cumulative_weights",
                        lambda logw: torch.tensor(csum))

    targs = (torch.tensor(z), torch.tensor(ids), torch.tensor(zmask), R)
    held = tfs2.fs2_update(state_from_numpy(state_to_numpy(tstate),
                                            device="cpu"), *targs,
                           n_min, eps, lambda pos: U[pos],
                           do_resample=False)
    assert bool(trs.effective_particles(held.logw) < n_min) == need
    want_idx = np.asarray(jrs.stratified_indices(rkey, logw_n))
    got_idx = trs.stratified_indices(held.logw, lambda pos: U[pos])
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)

    tk.reset_launch_counts()
    got = tfs2.fs2_update(tstate, *targs, n_min, eps, lambda pos: U[pos])
    assert sum(tk.launch_counts().values()) == 0   # CPU: twins only
    got, want = state_to_numpy(got), _as_numpy(want)
    np.testing.assert_allclose(got["logw"], want["logw"], **TOL_LOGW)
    for f in ("xv", "lm"):
        np.testing.assert_allclose(got[f], want[f], **TOL_REFINE_XV,
                                   err_msg=f)
    for f in ("Pv", "lm_P"):
        np.testing.assert_allclose(got[f], want[f], **TOL_REFINE_PV,
                                   err_msg=f)
    for f in ("n", "da_table"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert int(got["n"]) > int(np.asarray(jstate.n))  # new features added
    assert not np.any(got["Pv"])                      # zeroed after a fix


def test_fs2_update_without_observations_keeps_the_state(scene):
    """With every observation masked, the sample, the weight term and
    the Pv reset are switched off on the device: the state comes back
    as it was (the gate holds at n_min 0)."""
    cfg, slam_map, pose, obs = scene
    jstate = _jax_state(cfg, slam_map, pose, obs, 64)
    _, tstate = _predicted(cfg, jstate, state_from_numpy(_as_numpy(jstate),
                                                         device="cpu"))
    before = state_to_numpy(tstate)
    K = obs.z.shape[0]
    g = torch.Generator().manual_seed(1)
    got = tfs2.fs2_update(tstate, torch.tensor(np.asarray(obs.z)),
                          torch.tensor(np.asarray(obs.ids)),
                          torch.zeros(K, dtype=torch.bool), R, 0.0,
                          tfs2.proposal_noise(64, g),
                          trs.uniform_from_generator(64, g))
    got = state_to_numpy(got)
    for f in ("xv", "Pv", "lm", "lm_P", "n", "da_table"):
        np.testing.assert_array_equal(got[f], before[f], err_msg=f)
    np.testing.assert_allclose(
        got["logw"], before["logw"] - np.log(np.exp(
            before["logw"].astype(np.float64)).sum()), rtol=1e-6, atol=1e-6)


def test_log_likelihood_at_matches_jax_and_the_k2_twin(scene):
    cfg, slam_map, pose, obs = scene
    jstate = _jax_state(cfg, slam_map, pose, obs, 64)
    z, ids, zmask = (jnp.asarray(np.asarray(a))
                     for a in (obs.z, obs.ids, obs.mask))
    assoc, _ = jrbpf.associate_known(jstate, ids, zmask)
    matched = assoc >= 0
    slot = jnp.where(matched, assoc, 0)
    gathered = jrbpf.gather_landmarks(jstate, slot)
    want = jfs2._log_likelihood_at(jstate.xv, z, matched, gathered,
                                   jnp.asarray(R))
    tg = tuple(map(_t, gathered))
    got = tfs2._log_likelihood_at(_t(jstate.xv), _t(z), _t(matched), tg, R)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # K2's twin, from zero weights and with no new feature, adds exactly
    # this term to logw.
    tstate = state_from_numpy(_as_numpy(jstate), device="cpu")
    logw = torch.zeros_like(tstate.logw)
    K = z.shape[0]
    tkernels.observe_plain(tstate.xv, logw, tstate.lm, tstate.lm_P, _t(z),
                           _t(slot).to(torch.int32), _t(matched),
                           torch.zeros(K, dtype=torch.int32),
                           torch.zeros(K, dtype=torch.bool), R)
    assert torch.equal(got, logw)


@pytest.mark.parametrize("P,want", [(64, {"K3", "K2", "G1"}),
                                     (512, {"K3", "K4", "G2"})])
def test_fs2_update_dispatch_follows_particle_count(scene, P, want,
                                                    monkeypatch):
    """K4 exactly when P % 128 == 0, G2 exactly when P % 512 == 0; K3 on
    every update (``kernels.landmark_update`` picks K4 or K2)."""
    from slam_tpu_torch.models import particles as tparticles
    from slam_tpu_torch.ops.kernels import kernels as tkk

    calls = set()

    def record(module, name, kid):
        fn = getattr(module, name)

        def wrapped(*args, **kw):
            calls.add(kid)
            return fn(*args, **kw)
        monkeypatch.setattr(module, name, wrapped)

    record(tfs2, "fs2_refine", "K3")
    record(tkk, "observe", "K2")
    record(tkk, "fused_update", "K4")
    record(tparticles, "sorted_gather_multi", "G1")
    record(tparticles, "bounds_gather_multi", "G2")
    cfg, slam_map, pose, obs = scene
    state = state_from_numpy(_as_numpy(_jax_state(cfg, slam_map, pose,
                                                  obs, P)), device="cpu")
    g = torch.Generator().manual_seed(0)
    tfs2.fs2_update(state, *(torch.tensor(np.asarray(a))
                             for a in (obs.z, obs.ids, obs.mask)), R,
                    float(P), tfs2.proposal_noise(P, g),
                    trs.uniform_from_generator(P, g))
    assert calls == want


# ---------------------------------------------------------------------------
# The estimator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heading_known", [1, 0])
def test_predict_multi_only_with_the_heading_unknown(heading_known):
    est = tfs2.FastSlam2(SlamConfig(SWITCH_HEADING_KNOWN=heading_known), 10,
                         device="cpu")
    assert hasattr(est, "predict_multi") == (not heading_known)


def test_fs2_state_with_covariance_crosses_packages(scene):
    cfg, slam_map, pose, obs = scene
    jstate = _jax_state(cfg, slam_map, pose, obs, 48)
    jstate, _ = _predicted(cfg, jstate, state_from_numpy(_as_numpy(jstate),
                                                         device="cpu"))
    want = _as_numpy(jstate)
    assert np.abs(want["Pv"]).max() > 0
    got = state_to_numpy(state_from_numpy(want, device="cpu"))
    for f in FIELDS:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_fs2_predict_multi_runs_k6b_twin_in_place():
    est = tfs2.FastSlam2(SlamConfig(SWITCH_HEADING_KNOWN=0,
                                    SWITCH_PREDICT_NOISE=1), 10,
                         device="cpu")
    state = est.init(1024)
    xv, Pv = state.xv, state.Pv
    ctl = torch.tensor([[3.0, 0.1]] * 8)
    tk.reset_launch_counts()
    out = est.predict_multi(state, torch.Generator().manual_seed(0), ctl)
    assert out.xv is xv and out.Pv is Pv
    assert float(Pv[0].min()) > 0 and float(xv[0].std()) > 0
    assert tk.launch_counts()["K6b"] == 0


# ---------------------------------------------------------------------------
# Many supersteps against JAX
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("wheelbase", "dt"))
def _jax_drive_predict(state, V, G, Q, wheelbase, dt):
    """JAX's fs2_predict over the ticks of a superstep, its control draw
    switched off and the per-particle controls V, G [T, P] fed in as the
    nominal ones."""
    shape = jrbpf.tile_shape(state.n_particles)
    for t in range(V.shape[0]):
        state = jfs2.fs2_predict(state, jax.random.key(0),
                                 V[t].reshape(shape), G[t].reshape(shape),
                                 Q, wheelbase=wheelbase, dt=dt,
                                 add_noise=False)
    return state


@jax.jit
def _jax_drive_update(state, key, z, ids, zmask, R, n_min):
    """JAX's fs2_update (use_pallas=False) and what the port is fed and
    held to: its proposal draw eps, the gate, the prefix sum of the
    stratified resample, its dither U and its ancestors."""
    pre = []

    def resample(s, rkey, n_min):
        pre.append((s, rkey))
        return jrbpf.resample(s, rkey, n_min, True)
    post = jfs2.fs2_update(state, key, z, ids, zmask, R, n_min,
                           use_pallas=False, resample_fn=resample)
    s, rkey = pre[0]
    logw_n = jrs.normalize_log_weights(s.logw)
    P = logw_n.shape[0]
    return dict(post=post,
                eps=jax.random.normal(jax.random.split(key)[1], (3, P),
                                      dtype=jnp.float32),
                need=jrs.effective_particles(logw_n) < n_min,
                csum=jrs._cumsum_2d(jnp.exp(jrs.normalize_log_weights(
                    logw_n))),
                U=jrs._uniform_at(rkey, jnp.arange(P, dtype=jnp.int32)),
                idx=jrs.stratified_indices(rkey, logw_n))


# The drive's logw: test_fs2_update_matches_jax's round moves float32
# rounding of the prior / proposal term up to ~1.1e-4 relative per
# round, and the weights sum those terms over every superstep between
# two resamples; measured 1.05e-3 relative at superstep 18 at P = 64,
# 6.1e-4 at P = 512. The gate and the ancestors, which the weights
# decide, are held exactly.
TOL_LOGW_DRIVE = dict(rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("P", [64, 512], ids=["K2-G1", "K4-G2"])
def test_drive_matches_jax(stream, P, monkeypatch):
    """DRIVE_SUPERSTEPS supersteps of FastSLAM 2 on ring40's JAX
    observation stream (tests/test_torch_fastslam1.py's ``stream``, seed
    3), each package on its own state from the same start (every
    particle at the true pose, Pv zero, no landmark mapped): per
    superstep the motion noise from one numpy draw, then JAX's proposal
    draw, stratified dither and prefix sum injected. After each
    superstep: xv and lm at TOL_REFINE_XV, Pv and lm_P at TOL_REFINE_PV
    (test_fs2_update_matches_jax's tolerances), logw at TOL_LOGW_DRIVE;
    n, da_table, the gate and the ancestors exactly. The resample fires
    and holds along the way. About 6 s per particle count on one CPU
    worker, JAX's compiles included."""
    cfg, slam_map, pose, steps = stream
    n_map = slam_map.n_landmarks
    L = -(-n_map // 8) * 8
    jstate = jinit(P, L, n_map)._replace(
        xv=jnp.asarray(np.repeat(pose[:, None], P, axis=1)))
    tstate = state_from_numpy(_as_numpy(jstate), device="cpu")
    Qd = np.diag(np.asarray(cfg.Qe, np.float32))
    n_min = float(cfg.NEFFECTIVE * P / cfg.NPARTICLES)
    sig = np.sqrt(np.asarray(cfg.Qe, np.float32))
    rng = np.random.default_rng(P)

    seen = dict(gates=[], ancestors=[])
    resample_gate = trbpf.resample_gate

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
        jstate = _jax_drive_predict(jstate, jnp.asarray(V), jnp.asarray(G),
                                    jnp.asarray(Qd), cfg.WHEELBASE,
                                    cfg.DT_CONTROLS)
        xv, Pv = tstate.xv, tstate.Pv
        for t in range(T):
            xv, Pv = tfs2.propagate_pose_covariance(
                xv, Pv, torch.tensor(V[t]), torch.tensor(G[t]), Qd,
                cfg.WHEELBASE, cfg.DT_CONTROLS)
        tstate = tstate._replace(xv=xv, Pv=Pv)

        want = _jax_drive_update(jstate, jax.random.PRNGKey(100 + i),
                                 jnp.asarray(z), jnp.asarray(ids),
                                 jnp.asarray(zmask), jnp.asarray(R),
                                 jnp.float32(n_min))
        csum["now"] = torch.tensor(np.asarray(want["csum"]))
        U = torch.tensor(np.asarray(want["U"]))
        n_seen = len(seen["ancestors"])
        tstate = tfs2.fs2_update(tstate, torch.tensor(z), torch.tensor(ids),
                                 torch.tensor(zmask), R, n_min,
                                 torch.tensor(np.asarray(want["eps"])),
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
        for f, tol in (("logw", TOL_LOGW_DRIVE), ("xv", TOL_REFINE_XV),
                       ("lm", TOL_REFINE_XV), ("Pv", TOL_REFINE_PV),
                       ("lm_P", TOL_REFINE_PV)):
            np.testing.assert_allclose(got[f], exp[f], **tol,
                                       err_msg=f"superstep {i}: {f}")
        for f in ("n", "da_table"):
            np.testing.assert_array_equal(got[f], exp[f],
                                          err_msg=f"superstep {i}: {f}")
    assert True in seen["gates"] and False in seen["gates"]
    assert int(tstate.n) == 4


# ---------------------------------------------------------------------------
# On the card: K1, K3 and K6b against their twins
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k3_kernel_matches_twin_on_card(cuda):
    state, z, slot, matched = _refine_fixture()
    ts = state_from_numpy(_as_numpy(state), cuda)
    tg = trbpf.gather_landmarks(ts, _t(slot, cuda))
    args = (ts.xv, ts.Pv, *tg, _t(z, cuda), _t(matched, cuda), R)
    before = tk.fs2_refine.launches
    got = tk.fs2_refine(*args)
    assert tk.fs2_refine.launches == before + 1
    want = tkernels.fs2_refine_plain(*args)
    torch.testing.assert_close(got[0][:2], want[0][:2], **TOL_REFINE_XV)
    dth = wrap_angle(got[0][2] - want[0][2])
    torch.testing.assert_close(dth, torch.zeros_like(dth), **TOL_REFINE_XV)
    torch.testing.assert_close(got[1], want[1], **TOL_REFINE_PV)


@pytest.mark.cuda
@pytest.mark.parametrize("add_noise", [True, False], ids=["noise", "nominal"])
def test_k6b_kernel_matches_twin_on_card(cuda, add_noise):
    xv, Pv, ctl = _predict_fixture(P=100_000, seed=9)
    seed = torch.tensor([-123, 456], dtype=torch.int32, device=cuda)
    kw = dict(wheelbase=WHEELBASE, dt=DT, add_noise=add_noise)
    got = tk.fs2_predict_multi(_t(xv, cuda), _t(Pv, cuda), seed,
                               _t(ctl, cuda), Q, **kw)
    want = tp.fs2_predict_multi_plain(_t(xv, cuda), _t(Pv, cuda), seed,
                                      _t(ctl, cuda), Q, **kw)
    torch.testing.assert_close(got[0][:2], want[0][:2], **TOL)
    dth = wrap_angle(got[0][2] - want[0][2])
    torch.testing.assert_close(dth, torch.zeros_like(dth), **TOL)
    torch.testing.assert_close(got[1], want[1], **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("add_noise", [True, False], ids=["noise", "nominal"])
@pytest.mark.parametrize("T,P", [(8, 2 ** 20), (8, 2 ** 20 + 37),
                                 (5, 2 ** 20 + 37), (11, 1000),
                                 (300, 4133)])
def test_k6b_kernel_is_bit_equal_to_twin_on_card(cuda, T, P, add_noise):
    """At T = 8, at a T that is no multiple of the tick loop's unrolling
    and at one that takes two launches, at 2^20 particles and a ragged
    count: the kernel keeps the twin's
    operation order and its sincosf and fast wrap return the bits of what
    they replace, so nothing separates the two."""
    xv, Pv, ctl = _predict_fixture(P=P, seed=10, T=T)
    xv[2] *= 2.0
    seed = torch.tensor([-123, 456], dtype=torch.int32, device=cuda)
    kw = dict(wheelbase=WHEELBASE, dt=DT, add_noise=add_noise)
    got = tk.fs2_predict_multi(_t(xv, cuda), _t(Pv, cuda), seed,
                               _t(ctl, cuda), Q, **kw)
    want = tp.fs2_predict_multi_plain(_t(xv, cuda), _t(Pv, cuda), seed,
                                      _t(ctl, cuda), Q, **kw)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert torch.equal(g, w), float((g - w).abs().max())


@pytest.mark.cuda
def test_k1_kernel_matches_twin_on_card(cuda):
    rng = np.random.default_rng(3)
    P, K = 5000, 15
    xv = rng.normal(size=(3, P)).astype(np.float32)
    planes = [(xv[0] + rng.normal(size=(K, P)) * 5 + 2),
              (xv[1] + rng.normal(size=(K, P)) * 5 + 1),
              np.full((K, P), 0.1), np.full((K, P), 0.01),
              np.full((K, P), 0.08)]
    planes = [_t(p.astype(np.float32), cuda) for p in planes]
    got = tk.jacobians(_t(xv, cuda), *planes, R)
    xt = _t(xv, cuda)
    want = tpk.jacobians_planes(xt[0:1], xt[1:2], xt[2:3], *planes,
                                *tpk.sym2_host(R))
    for name, g, w in zip(got._fields, got, want):
        w = w.expand_as(g)
        if name == "zb":     # wrapped: one ulp at +-pi flips it by 2 pi
            g, w = wrap_angle(g - w), torch.zeros_like(g)
        torch.testing.assert_close(g, w, **TOL)
