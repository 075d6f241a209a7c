"""The port's bundle adjustment (``slam_tpu_torch.posegraph``) against the
JAX package's, on the CPU, from the same numpy inputs.

Two problems: the JAX package's own noisy test problem (tests/test_ba.py:
a circle of T = 40 keyframes observing the K = 6 nearest of L = 12
landmarks, noisy observations, initial guess = truth + noise) and the
benchmark's ``make_ba_problem(64, 500)`` (two loops, dead-reckoned
drift), both made here with numpy and fed to both packages.

Tolerances: the factor functions at rtol/atol 1e-5 (float32 rounding of
O(1) values; headings compared wrapped); the normal blocks and the cost
at rtol 1e-4, atol 1e-5 (the port sums the landmark terms by index, JAX
by one-hot products, in another order); one trial step at atol 1e-4;
whole solves at atol 1e-3 (poses) and 1e-2 (landmarks), with the same
trial/accept counts where the solve stops before its cost reaches
float32 resolution (SOLVE_CASES says why not elsewhere). The port's own
solvers agree bit for bit.
"""

import collections
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from slam_tpu.config import SlamConfig as JSlamConfig
from slam_tpu.posegraph import ba as jba
from slam_tpu.posegraph import distributed as jdist
from slam_tpu_torch.config import SlamConfig as TSlamConfig
from slam_tpu_torch.posegraph import ba as tba
from slam_tpu_torch.posegraph import distributed as tdist
from slam_tpu_torch.posegraph.synthetic import make_ba_problem

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = [f.name for f in dataclasses.fields(tba.BAProblem)]
NO_CARD = "torch.cuda.is_available\\(\\) is False"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread: the products are small, and the JAX side's
    thread pool runs in the same process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _circle_arrays(T=40, L=12, K=6, seed=3, noise=0.05):
    """The JAX test's problem (tests/test_ba.py:_synthetic_problem) as
    numpy arrays, with its odometry computed in numpy; by default its
    noisy case (noise=0.05, seed=3). Without noise a solve ends at the
    float32 noise floor (cost ~4e-7), where whether the last trial
    lowers the cost depends on the order of the roundings, so two
    implementations part on it."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 1.5 * np.pi, T)
    poses_true = np.stack([10 * np.cos(ang), 10 * np.sin(ang),
                           np.mod(ang + np.pi / 2 + np.pi, 2 * np.pi)
                           - np.pi], -1).astype(np.float32)
    lms_true = rng.uniform(-16, 16, size=(L, 2)).astype(np.float32)
    z = np.zeros((T, K, 2), np.float32)
    idx = np.zeros((T, K), np.int32)
    for t in range(T):
        d = lms_true - poses_true[t, :2]
        order = np.argsort((d * d).sum(-1))[:K]
        idx[t] = order
        dd = lms_true[order] - poses_true[t, :2]
        z[t, :, 0] = np.sqrt((dd * dd).sum(-1))
        z[t, :, 1] = np.arctan2(dd[:, 1], dd[:, 0]) - poses_true[t, 2]
    if noise:
        z[..., 0] += rng.normal(scale=noise, size=z[..., 0].shape)
        z[..., 1] += rng.normal(scale=noise / 10, size=z[..., 1].shape)
    a, b = poses_true[:-1], poses_true[1:]
    c, s = np.cos(a[:, 2]), np.sin(a[:, 2])
    dx, dy = b[:, 0] - a[:, 0], b[:, 1] - a[:, 1]
    odom = np.stack([c * dx + s * dy, -s * dx + c * dy,
                     np.mod(b[:, 2] - a[:, 2] + np.pi, 2 * np.pi) - np.pi],
                    -1).astype(np.float32)
    poses0 = poses_true + rng.normal(scale=0.3, size=poses_true.shape
                                     ).astype(np.float32) * np.array(
        [1, 1, 0.1], np.float32)
    poses0[0] = poses_true[0]
    lms0 = lms_true + rng.normal(scale=0.5, size=lms_true.shape).astype(
        np.float32)
    return dict(poses0=poses0, landmarks0=lms0, odom=odom,
                odom_info=np.diag([100.0, 100.0, 400.0]).astype(np.float32),
                z=z, lm_idx=idx, mask=np.ones((T, K), bool),
                R=np.diag([0.01, 0.0003]).astype(np.float32))


@pytest.fixture(scope="module")
def problems():
    """{name: (the port's problem on the CPU, the JAX package's, the
    arrays)}."""
    bench = make_ba_problem(64, 500, device="cpu")[0]
    # The circle started farther out (poses 1 m and 0.3 rad off): its
    # first trials overshoot by far, so LM rejects and raises the
    # damping, each decision far from a rounding.
    far = _circle_arrays()
    rng = np.random.default_rng(11)
    far["poses0"][1:, :2] += rng.normal(size=(39, 2)).astype(np.float32)
    far["poses0"][1:, 2] += rng.normal(scale=0.3, size=39).astype(
        np.float32)
    out = {}
    for name, arrays in (("circle", _circle_arrays()), ("circle-far", far),
                         ("bench-64x500", {f: getattr(bench, f).numpy()
                                           for f in FIELDS})):
        out[name] = (tba.BAProblem.from_numpy("cpu", **arrays),
                     jba.BAProblem(**{f: jnp.asarray(a)
                                      for f, a in arrays.items()}),
                     arrays)
    return out


@pytest.fixture(params=["circle", "bench-64x500"])
def problem(problems, request):
    return problems[request.param]


def _static(prob):
    """The static arguments of the step and cost functions."""
    return (prob.odom, prob.odom_info, prob.z, prob.lm_idx, prob.mask,
            prob.R, prob.poses0[0])


def _wrapped_close(got, want, tol=TOL):
    """x, y (and other columns) close; the heading column compared
    wrapped."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[..., :2], want[..., :2], **tol)
    dth = np.mod(got[..., 2] - want[..., 2] + np.pi, 2 * np.pi) - np.pi
    np.testing.assert_allclose(dth, 0.0, atol=tol["atol"])


# ---------------------------------------------------------------------------
# Factors
# ---------------------------------------------------------------------------

def test_to_local_matches_jax():
    rng = np.random.default_rng(1)
    a = (rng.normal(size=(50, 3)) * [30, 30, 3]).astype(np.float32)
    b = (rng.normal(size=(50, 3)) * [30, 30, 3]).astype(np.float32)
    _wrapped_close(tba.to_local(torch.tensor(a), torch.tensor(b)).numpy(),
                   jba.to_local(jnp.asarray(a), jnp.asarray(b)))


def test_odom_residual_jacobians_match_jax(problem):
    t, j, _ = problem
    got = tba._odom_residual_jacobians(t.poses0, t.odom)
    want = jba._odom_residual_jacobians(j.poses0, j.odom)
    _wrapped_close(got[0].numpy(), want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_obs_terms_match_jax(problem):
    t, j, _ = problem
    got = tba._obs_terms(t.poses0, t.landmarks0, t.z, t.lm_idx, t.mask)
    want = jba._obs_terms(j.poses0, j.landmarks0, j.z, j.lm_idx, j.mask)
    for name, g, w in zip(("Hv", "Hf"), got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)
    np.testing.assert_allclose(got[2][..., 0].numpy(),
                               np.asarray(want[2])[..., 0], **TOL)
    dr = np.mod(got[2][..., 1].numpy() - np.asarray(want[2])[..., 1]
                + np.pi, 2 * np.pi) - np.pi
    np.testing.assert_allclose(dr, 0.0, atol=TOL["atol"])


def test_prior_residual_matches_jax():
    rng = np.random.default_rng(2)
    poses = (rng.normal(size=(4, 3)) * [5, 5, 3]).astype(np.float32)
    anchor = (rng.normal(size=3) * [5, 5, 3]).astype(np.float32)
    got = tba._prior_residual(torch.tensor(poses), torch.tensor(anchor))
    want = jba._prior_residual(jnp.asarray(poses), jnp.asarray(anchor))
    _wrapped_close(got.numpy(), want)


# ---------------------------------------------------------------------------
# Normal equations, cost, one step
# ---------------------------------------------------------------------------

def test_normal_blocks_and_cost_match_jax(problem):
    """Blocks at rtol 1e-4, with an atol of 1e-5 of the block's largest
    entry: an entry that is a sum of large cancelling terms (App's
    odometry blocks, bp at a drifted start) keeps a rounding of the
    terms' size, not of its own; the cost at rtol 1e-5."""
    t, j, _ = problem
    got = tba._gn_normal_blocks(t.poses0, t.landmarks0, *_static(t)[:6],
                                t.poses0[0], t.L)
    want = jba._gn_normal_blocks(j.poses0, j.landmarks0, *_static(j)[:6],
                                 j.poses0[0], j.L)
    for name, g, w in zip(("App", "W", "All", "bp", "bl"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)
    # Off the starting point too, where the prior's residual is not 0.
    for poses, lms in ((t.poses0, t.landmarks0),
                       (t.poses0 + 0.05, t.landmarks0 - 0.1)):
        got = tba._ba_cost(poses, lms, *_static(t))
        want = jba._ba_cost(jnp.asarray(poses.numpy()),
                            jnp.asarray(lms.numpy()), *_static(j))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def _step64(blocks, poses, landmarks, lam):
    """The damped Schur step in float64 from float32 blocks."""
    App, W, All, bp, bl = (np.asarray(b, np.float64) for b in blocks)
    T, L = poses.shape[0], landmarks.shape[0]
    Ainv = np.linalg.inv(All + lam * np.eye(2))
    WA = np.einsum("plc,lcd->pld", W.reshape(3 * T, L, 2),
                   Ainv).reshape(3 * T, 2 * L)
    dp = np.linalg.solve(App + lam * np.eye(3 * T) - WA @ W.T,
                         bp - WA @ bl.reshape(-1))
    dl = np.einsum("lcd,ld->lc", Ainv,
                   (bl.reshape(-1) - W.T @ dp).reshape(L, 2))
    return poses + dp.reshape(T, 3), landmarks + dl


def test_gn_step_matches_jax(problem):
    """One trial step from the same inputs. On the circle, poses and
    landmarks at atol 1e-4. At the bench problem's drifted start the
    reduced system's condition number is ~5e7 and the step ~15 m, so a
    float32 step lands centimetres from the float64 one (JAX's: 0.037 m
    in positions on this machine): there the port's step is held within
    0.05 m of the float64 step from JAX's blocks, x and y."""
    t, j, arrays = problem
    got = tba._gn_step(t.poses0, t.landmarks0, *_static(t),
                       torch.tensor(1e-3))
    want = jba._gn_step(j.poses0, j.landmarks0, *_static(j),
                        jnp.float32(1e-3))
    if t.T == 40:
        _wrapped_close(got[0].numpy(), want[0], dict(rtol=0, atol=1e-4))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=0, atol=1e-4)
        return
    blocks = jba._gn_normal_blocks(j.poses0, j.landmarks0,
                                   *_static(j)[:6], j.poses0[0], j.L)
    p64, _ = _step64(blocks, arrays["poses0"], arrays["landmarks0"], 1e-3)
    np.testing.assert_allclose(got[0][:, :2].numpy(), p64[:, :2], rtol=0,
                               atol=0.05)


# ---------------------------------------------------------------------------
# Solves
# ---------------------------------------------------------------------------

# (problem, iters, damping, the same trial/accept counts as JAX). The
# counts are held where the solve stops on its iteration cap, or on
# spent retries, before the cost reaches float32 resolution: on
# circle-far with damping 1e-4, 3 accepted steps among 9 trials; with
# 1e-6, 2 accepted, then 7 rejections that end the solve. Past it (the circle after 3 accepted
# steps, cost ~55.59 +- 1e-4; tol * cost lies below one float32 ulp of
# the cost) a trial's acceptance turns on the last bits of two sums
# taken in different orders, and at the bench problem the first steps
# are ill-conditioned (see test_gn_step_matches_jax), so there the
# two packages' (and two thread counts') trial sequences part, while
# the solutions agree at the tolerances.
SOLVE_CASES = [("circle", 3, 1e-4, True), ("circle-far", 3, 1e-4, True),
               ("circle-far", 3, 1e-6, True), ("circle", 6, 1e-4, False),
               ("bench-64x500", 6, 1e-4, False)]


@pytest.mark.parametrize("name,iters,damping,counts", SOLVE_CASES)
def test_solve_ba_matches_jax(problems, name, iters, damping, counts):
    """Poses atol 1e-3, landmarks 1e-2; the same number of accepted
    steps and of trials where ``counts``."""
    t, j, _ = problems[name]
    p, l, info = tba.solve_ba(t, iters=iters, damping=damping,
                              return_info=True)
    jp, jl, jinfo = jba.solve_ba(j, iters=iters, damping=damping,
                                 return_info=True)
    if name == "circle-far":
        assert info["n_steps"] > len(info["costs"])     # rejections
    if counts:
        assert len(info["costs"]) == len(jinfo["costs"])
        assert info["n_steps"] == jinfo["n_steps"]
        # The damping's schedule (float32 here, a Python float in JAX).
        np.testing.assert_allclose(info["final_damping"],
                                   jinfo["final_damping"], rtol=1e-6)
        # The iterates of large steps carry the reduced solve's rounding.
        np.testing.assert_allclose(info["costs"], jinfo["costs"],
                                   rtol=1e-3)
    _wrapped_close(p.numpy(), jp, dict(rtol=0, atol=1e-3))
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=1e-2)
    np.testing.assert_allclose(info["costs"][-1], jinfo["costs"][-1],
                               rtol=1e-3)
    # The plan, the first cost, one per trial and the final damping.
    assert info["host_reads"] == 3 + info["n_steps"]


@pytest.mark.parametrize("iters,damping", [(6, 1e-4), (8, 1e-3)])
def test_solve_ba_device_matches_solve_ba(problem, iters, damping):
    """The same trials and acceptances, so the same bits; one host read
    per trial (and the plan's)."""
    t, _, _ = problem
    p_h, l_h, info_h = tba.solve_ba(t, iters=iters, damping=damping,
                                    return_info=True)
    p_d, l_d, info_d = tba.solve_ba_device(t, iters=iters,
                                           damping=damping,
                                           return_info=True)
    assert info_d["n_steps"] == info_h["n_steps"]
    assert info_d["n_accepted"] == len(info_h["costs"]) - 1
    assert info_d["cost"] == info_h["costs"][-1]
    assert info_d["final_damping"] == info_h["final_damping"]
    assert torch.equal(p_d, p_h) and torch.equal(l_d, l_h)
    assert info_d["host_reads"] == 1 + info_d["n_steps"]


@pytest.mark.parametrize("name,iters,damping,counts", SOLVE_CASES)
def test_solve_ba_sharded_matches_jax_one_device(problems, name, iters,
                                                 damping, counts):
    """One shard against the JAX package's solve on a one-device mesh:
    poses atol 1e-3 and, where ``counts``, the same LM iterations; and
    against the port's solve_ba at the JAX package's own tolerances
    (tests/test_config5.py: 5e-3, 5e-2)."""
    t, j, _ = problems[name]
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("l",))
    p, l, info = tdist.solve_ba_sharded(t, iters=iters, damping=damping,
                                        return_info=True)
    jp, jl, jinfo = jdist.solve_ba_sharded(j, mesh, iters=iters,
                                           damping=damping,
                                           return_info=True)
    if counts:
        assert info["n_iters"] == jinfo["n_iters"]
        np.testing.assert_allclose(info["costs"], jinfo["costs"],
                                   rtol=1e-3)
    _wrapped_close(p.numpy(), jp, dict(rtol=0, atol=1e-3))
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=1e-2)
    assert info["host_reads"] == 2 + info["n_steps"]
    p1, l1 = tba.solve_ba(t, iters=iters, damping=damping)
    np.testing.assert_allclose(p.numpy(), p1.numpy(), atol=5e-3)
    assert l.shape == t.landmarks0.shape
    np.testing.assert_allclose(l.numpy(), l1.numpy(), atol=5e-2)


# Four landmark shards on gloo ranks (torch_parallel_workers.ba_world)
# against the JAX package's solve on four devices, on problems whose L is
# no multiple of 4, so that both pad: the far circle with 13 landmarks
# (its large early steps, rejections among them, keep the trial
# sequence away from rounding, so the counts are held) and the bench
# problem at (64, 501).
BA_SHARDS = 4
MESH_CASES = {"circle-far-13": (3, 1e-4, True),
              "bench-64x501": (6, 1e-4, False)}


@pytest.fixture(scope="module")
def mesh_problems():
    far = _circle_arrays(L=13)
    rng = np.random.default_rng(11)
    far["poses0"][1:, :2] += rng.normal(size=(39, 2)).astype(np.float32)
    far["poses0"][1:, 2] += rng.normal(scale=0.3, size=39).astype(
        np.float32)
    bench = make_ba_problem(64, 501, device="cpu")[0]
    return {"circle-far-13": far,
            "bench-64x501": {f: getattr(bench, f).numpy() for f in FIELDS}}


@pytest.fixture(scope="module")
def ba_world(mesh_problems):
    import torch_parallel_workers as tw
    cases = [dict(arrays=mesh_problems[name], iters=iters, damping=damping)
             for name, (iters, damping, _) in MESH_CASES.items()]
    return tw.run_world(tw.ba_world, BA_SHARDS, cases=cases)


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_solve_ba_sharded_matches_jax_on_four_ranks(ba_world, mesh_problems,
                                                    name):
    """4 ranks against JAX's solve on ``Mesh(jax.devices()[:4], ("l",))``
    at the one-shard test's tolerances: poses atol 1e-3, landmarks 1e-2,
    and, where held, the same LM iterations and costs at rtol 1e-3;
    against the port's solve_ba at 5e-3 / 5e-2; the host reads as on
    one shard; every rank the same result."""
    arrays = mesh_problems[name]
    iters, damping, counts = MESH_CASES[name]
    assert arrays["landmarks0"].shape[0] % BA_SHARDS
    j = jba.BAProblem(**{f: jnp.asarray(a) for f, a in arrays.items()})
    mesh = Mesh(np.asarray(jax.devices()[:BA_SHARDS]), ("l",))
    jp, jl, jinfo = jdist.solve_ba_sharded(j, mesh, iters=iters,
                                           damping=damping,
                                           return_info=True)
    t = tba.BAProblem.from_numpy("cpu", **arrays)
    p1, l1 = tba.solve_ba(t, iters=iters, damping=damping)
    i = list(MESH_CASES).index(name)
    got = ba_world[0][i]["mesh"]
    for world in ba_world[1:]:
        other = world[i]["mesh"]
        np.testing.assert_array_equal(other["poses"], got["poses"])
        np.testing.assert_array_equal(other["landmarks"], got["landmarks"])
        assert other["costs"] == got["costs"]
    if counts:
        assert got["n_iters"] == jinfo["n_iters"]
        np.testing.assert_allclose(got["costs"], jinfo["costs"], rtol=1e-3)
    assert got["landmarks"].shape == arrays["landmarks0"].shape
    _wrapped_close(got["poses"], jp, dict(rtol=0, atol=1e-3))
    np.testing.assert_allclose(got["landmarks"], np.asarray(jl), atol=1e-2)
    assert got["host_reads"] == 2 + got["n_steps"]
    np.testing.assert_allclose(got["poses"], p1.numpy(), atol=5e-3)
    np.testing.assert_allclose(got["landmarks"], l1.numpy(), atol=5e-2)


def test_solve_ba_sharded_one_rank_mesh_equals_no_mesh(ba_world):
    """On each rank, a mesh of that rank alone and no mesh: the same
    poses, landmarks, costs, trials and reads, bit for bit."""
    for world in ba_world:
        for case in world:
            single, none = case["single"], case["none"]
            np.testing.assert_array_equal(single["poses"], none["poses"])
            np.testing.assert_array_equal(single["landmarks"],
                                          none["landmarks"])
            for key in ("costs", "n_iters", "n_steps", "host_reads"):
                assert single[key] == none[key], key


def test_bench_scale_solve_reaches_the_map_floor():
    """tests/test_ba.py's check at (64, 500), on the port: the drift
    shrinks by more than 5x, the cost falls at every accepted step, and
    the solve lands within 1.25x of the solve started at the truth."""
    prob, poses, poses0, lms = make_ba_problem(64, 500, device="cpu")
    init_err = np.linalg.norm(poses0[:, :2] - poses[:, :2], axis=1).mean()
    p, _, info = tba.solve_ba_device(prob, iters=25, return_info=True)
    err = np.linalg.norm(p[:, :2].numpy() - poses[:, :2], axis=1).mean()
    assert err < 0.2 * init_err, (err, init_err)
    _, _, info_h = tba.solve_ba(prob, iters=25, return_info=True)
    assert all(b <= a for a, b in zip(info_h["costs"],
                                      info_h["costs"][1:]))
    prob_t = dataclasses.replace(prob, poses0=torch.tensor(poses),
                                 landmarks0=torch.tensor(lms))
    p_t, _ = tba.solve_ba_device(prob_t, iters=25)
    floor = np.linalg.norm(p_t[:, :2].numpy() - poses[:, :2],
                           axis=1).mean()
    assert err < max(1.25 * floor, 0.05), (err, floor)


def test_failed_factorization_is_rejected(monkeypatch):
    """A trial whose Cholesky fails gives NaN, so a non-finite cost, and
    LM rejects it and raises the damping: the next trial is the solve's
    first trial at 10x the damping."""
    t = tba.BAProblem.from_numpy("cpu", **_circle_arrays())
    S = torch.tensor([[1.0, 2.0], [2.0, 1.0]])        # indefinite
    assert torch.isnan(tba._solve_pos(S, torch.ones(2))).all()
    solve_pos, calls = tba._solve_pos, []

    def failing_first(S, rhs):
        calls.append(1)
        out = solve_pos(S, rhs)
        return torch.full_like(out, float("nan")) if len(calls) == 1 else out
    monkeypatch.setattr(tba, "_solve_pos", failing_first)
    p, l, info = tba.solve_ba_device(t, iters=1, damping=1e-4,
                                     return_info=True)
    assert info["n_steps"] == 2 and info["n_accepted"] == 1
    monkeypatch.undo()
    lam = tba._raised(torch.tensor(1e-4))
    want = tba._gn_step(t.poses0, t.landmarks0, *_static(t), lam)
    assert torch.equal(p, want[0]) and torch.equal(l, want[1])
    assert info["final_damping"] == float(tba._lowered(lam))


# ---------------------------------------------------------------------------
# The landmark-indexed sums
# ---------------------------------------------------------------------------

def test_obs_plan_sums_like_add_at():
    """Masked observations add nothing, a landmark observed twice from
    one keyframe adds both, and an index outside [0, L) is refused."""
    rng = np.random.default_rng(4)
    T, K, L = 7, 5, 9
    idx = rng.integers(0, L, size=(T, K)).astype(np.int32)
    idx[2, 3] = idx[2, 1]
    mask = rng.uniform(size=(T, K)) < 0.8
    mask[2, 1] = mask[2, 3] = True
    terms = rng.normal(size=(T, K, 3, 2)).astype(np.float32)
    plan = tba.obs_plan(torch.tensor(idx), torch.tensor(mask), L)
    want_l = np.zeros((L, 3, 2), np.float64)
    np.add.at(want_l, idx[mask], terms[mask])
    got_l = tba._segment_sum(torch.tensor(terms).reshape(-1, 3, 2),
                             plan.lm_rows)
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=1e-6, atol=1e-6)
    want_w = np.zeros((T, 3, L, 2))
    t_of = np.broadcast_to(np.arange(T)[:, None], (T, K))
    np.add.at(want_w, (t_of[mask], slice(None), idx[mask]),
              terms[mask])
    got_w = tba._dense_cross(torch.tensor(terms), plan, L)
    np.testing.assert_allclose(got_w.numpy(), want_w.reshape(3 * T, 2 * L),
                               rtol=1e-6, atol=1e-6)
    assert plan.pair_rows.shape[1] == 2
    with pytest.raises(ValueError, match="landmark indices"):
        tba.obs_plan(torch.tensor(idx), torch.tensor(mask), L - 1)


# ---------------------------------------------------------------------------
# Problems
# ---------------------------------------------------------------------------

RunRecord = collections.namedtuple(
    "RunRecord", "true_pose est_pose active obs_z obs_mask obs_ids odom")


def _run_record(T=20, K=8, n_map=50, seed=6):
    """A RunResult-like record of numpy traces: the last three supersteps
    past the run's end, some observations masked."""
    rng = np.random.default_rng(seed)
    pose = np.cumsum(rng.normal(size=(T, 3)) * [1.0, 1.0, 0.1], axis=0)
    ids = np.stack([rng.choice(n_map, K, replace=False)
                    for _ in range(T)]).astype(np.int32)
    return RunRecord(
        true_pose=pose.astype(np.float32),
        est_pose=(pose + rng.normal(size=(T, 3)) * 0.1).astype(np.float32),
        active=np.arange(T) < T - 3,
        obs_z=np.stack([rng.uniform(2, 30, (T, K)),
                        rng.uniform(-1.5, 1.5, (T, K))], -1
                       ).astype(np.float32),
        obs_mask=rng.uniform(size=(T, K)) < 0.7,
        obs_ids=ids,
        odom=(rng.normal(size=(T, 3)) * [1.0, 0.1, 0.05]).astype(
            np.float32))


def test_problem_from_run_matches_jax():
    rec = _run_record()
    got = tba.problem_from_run(rec, TSlamConfig(), device="cpu")
    want = jba.problem_from_run(rec, JSlamConfig())
    for f in FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.L == int(rec.obs_ids[rec.active][
        rec.obs_mask[rec.active]].max()) + 1


def test_make_ba_problem_matches_bench():
    """The port's copy of bench.make_ba_problem: the landmark indices
    and the mask exactly; the odometry within 1e-5; the positions within
    1e-4, about three float32 ulps of a 300 m coordinate: bench's
    odometry runs through XLA's cos and sin, and the dead reckoning
    carries their last-bit differences over 63 steps."""
    sys.path.insert(0, ROOT)
    from bench import make_ba_problem as bench_make_ba_problem

    got = make_ba_problem(64, 500, device="cpu")
    want = bench_make_ba_problem(64, 500)
    for f in FIELDS:
        g, w = getattr(got[0], f).numpy(), np.asarray(getattr(want[0], f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        if f in ("lm_idx", "mask"):
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            atol = 1e-4 if f in ("poses0", "landmarks0") else 1e-5
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f)
    np.testing.assert_array_equal(got[1], want[1])        # poses_true
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[3], want[3])        # lms_true


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["make_ba_problem", "problem_from_run",
                                   "from_numpy"])
def test_ba_problems_refuse_the_default_device_without_a_card(no_card,
                                                             entry):
    """No device named means the card; without one, an error (never a
    silent CPU run)."""
    calls = {
        "make_ba_problem": lambda: make_ba_problem(8, 30),
        "problem_from_run": lambda: tba.problem_from_run(_run_record(),
                                                         TSlamConfig()),
        "from_numpy": lambda: tba.BAProblem.from_numpy(
            **_circle_arrays(T=5, L=4, K=2)),
    }
    with pytest.raises(RuntimeError, match=NO_CARD):
        calls[entry]()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the solve runs on cuBLAS and "
                    "cuSOLVER there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["circle", "bench-64x500"])
def test_solvers_agree_and_replay_on_card(cuda, problems, name):
    """On the card: solve_ba_device and solve_ba give the same trials and
    the same bits, a second solve replays the first, and the one-shard
    solve agrees with them at the JAX package's tolerances."""
    _, _, arrays = problems[name]
    t = tba.BAProblem.from_numpy(cuda, **arrays)
    p_h, l_h, info_h = tba.solve_ba(t, iters=8, return_info=True)
    p_d, l_d, info_d = tba.solve_ba_device(t, iters=8, return_info=True)
    assert info_d["n_steps"] == info_h["n_steps"]
    assert torch.equal(p_d, p_h) and torch.equal(l_d, l_h)
    p_r, l_r, info_r = tba.solve_ba_device(t, iters=8, return_info=True)
    assert info_r == info_d
    assert torch.equal(p_r, p_d) and torch.equal(l_r, l_d)
    p_s, l_s = tdist.solve_ba_sharded(t, iters=8)
    torch.testing.assert_close(p_s, p_h, rtol=0, atol=5e-3)
    torch.testing.assert_close(l_s, l_h, rtol=0, atol=5e-2)
