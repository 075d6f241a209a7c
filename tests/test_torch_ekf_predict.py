"""E1, the block EKF's predict tick in one launch
(``ops.kernels.ekf.ekf_predict_tick``, ``csrc/ekf_predict.cu``), and
``parallel.ekf._predict_local``, which sends a CUDA state to it and any
other to the plain twin, ``_predict_local_plain``.

On the CPU:

- the wrapper's refusals: dtypes, contiguity, shapes, ``hk_n`` outside
  [0, D], and a state off the card;
- a tick on the CPU bit for bit the former eager ``_predict_local`` (kept
  below as it was), on both arms of the heading, with hk's first column
  free, its last, and none (the spill into Pmm, also on a shard's rows);
- the gate's helpers (``selfcheck.ekf_predict_case`` and
  ``ekf_predict_errors``) at a small size, where E1 is the twin;
- E1 never launched by a run on the CPU.

On a card (``-m cuda``):

- E1 against the twin run in float64 at L = 10,000 on both arms, with
  hk_n 0 and 15 (at L = 2,000 with none free, the spill): each output's
  error at most twice the eager float32 code's (the twin on the card);
- the same for a heading that the tick carries across +-pi;
- an 80-superstep drive of ``ShardedEkfSlam`` on the card, each
  superstep against ``plain_ekf`` in float64 from the port's own state
  before it, no worse than the same drive with the eager code;
- ``launch_counts()["E1"]`` equal to the ticks of a run.

Jax-free; torch on one thread.
"""

import math

import pytest
import torch

import plain_ekf as pe
import test_torch_ekf_reference as ter
from slam_tpu_torch.geometry import wrap_angle
from slam_tpu_torch.models.ekf import motion_jacobians
from slam_tpu_torch.ops import kernels as tk
from slam_tpu_torch.ops.kernels import ekf as ke
from slam_tpu_torch.ops.kernels import selfcheck
from slam_tpu_torch.parallel import ekf as pk
from slam_tpu_torch.runtime import Runner

L_SMALL, D = 32, 16
# The drive: supersteps of the simulator's stream on the reference
# test's world, capacity for all of its landmarks.
DRIVE_SUPERSTEPS = 80


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: E1 is a CUDA kernel with no CPU "
                    "mode")
    return torch.device("cuda")


def _former_predict_local(state, v, g, Q, wheelbase, dt, phi, sigma_phi,
                          heading_known, shard):
    """``parallel.ekf._predict_local`` before E1, as it was."""
    x = state.x
    v = torch.as_tensor(v, dtype=x.dtype, device=x.device)
    g = torch.as_tensor(g, dtype=x.dtype, device=x.device)
    Gv, Gu, (dx, dy, heading) = motion_jacobians(x[2], v, g, wheelbase, dt)
    P00 = (Gv @ state.P00) @ Gv.T + (Gu @ Q) @ Gu.T
    P0m = Gv @ state.P0m
    x = torch.cat([torch.stack([x[0] + dx, x[1] + dy, heading]), x[3:]])
    if not heading_known:
        return state._replace(x=x, P00=P00, P0m=P0m)
    s_inn = P00[2, 2] + sigma_phi * sigma_phi
    cp, cm = P00[:, 2], P0m[2, :]
    Wp, Wm = cp / s_inn, cm / s_inn
    vh = wrap_angle(phi - x[2])
    x = x + torch.cat([Wp, Wm]) * vh
    x[2] = wrap_angle(x[2])
    P00 = (P00 - torch.outer(Wp, cp) - torch.outer(cp, Wp)
           + s_inn * torch.outer(Wp, Wp))
    P0m = (P0m - torch.outer(Wp, cm) - torch.outer(cp, Wm)
           + s_inn * torch.outer(Wp, Wm))
    u = cm / torch.sqrt(s_inn)
    state = state._replace(x=x, P00=P00, P0m=P0m)
    if state.hk_n < state.hk.shape[1]:
        state.hk[:, state.hk_n] = u
        return state._replace(hk_n=state.hk_n + 1)
    lo = shard.row_lo
    pk.pmm_passes.count += 1
    state.Pmm.addr_(u[lo:lo + shard.rows], u, alpha=-1.0)
    return state


def _copy(state):
    return state._replace(**{f: getattr(state, f).clone()
                             for f in ("x", "P00", "P0m", "Pmm", "hk")})


def _args(L=L_SMALL, hk_n=3):
    """The wrapper's arguments on the CPU: (x, P00, P0m, hk, hk_n, v, g,
    phi, Q) and its keywords."""
    g = torch.Generator().manual_seed(0)
    state, (v, gg, phi), Q, kw, _ = selfcheck.ekf_predict_case(
        torch.device("cpu"), g, L, D, hk_n)
    return ([state.x, state.P00, state.P0m, state.hk, hk_n, v, gg, phi, Q],
            dict(kw, heading_known=True))


# --- the wrapper's refusals ---------------------------------------------

def _refused(name, args):
    x, P00, P0m, hk, hk_n, v, g, phi, Q = args
    if name == "dtype":
        x = x.double()
    elif name == "not-a-tensor":
        v = 3.0
    elif name == "contiguity":
        P0m = P0m.T.contiguous().T
    elif name == "P0m-shape":
        P0m = torch.zeros((3, P0m.shape[1] + 2))
    elif name == "hk-rows":
        hk = torch.zeros((hk.shape[0] + 2, D))
    elif name == "phi-shape":
        phi = phi.reshape(1)
    elif name == "hk_n-negative":
        hk_n = -1
    elif name == "hk_n-past-D":
        hk_n = D + 1
    return [x, P00, P0m, hk, hk_n, v, g, phi, Q]


@pytest.mark.parametrize("name,match", [
    ("dtype", "float32"), ("not-a-tensor", "float32"),
    ("contiguity", "contiguous"), ("P0m-shape", "shapes"),
    ("hk-rows", "shapes"), ("phi-shape", "shapes"),
    ("hk_n-negative", "outside"), ("hk_n-past-D", "outside"),
    ("cpu", "one CUDA device")])
def test_wrapper_refuses(name, match):
    args, kw = _args()
    launches = ke.ekf_predict_tick.launches
    with pytest.raises(ValueError, match=match):
        ke.ekf_predict_tick(*_refused(name, args), **kw)
    assert ke.ekf_predict_tick.launches == launches


def test_wrapper_reads_phi_only_with_the_heading():
    """Without the heading observed, phi is not checked: a bad one passes
    the checks and the CPU is refused as for any state."""
    args, kw = _args()
    args[7] = None
    with pytest.raises(ValueError, match="one CUDA device"):
        ke.ekf_predict_tick(*args, **dict(kw, heading_known=False))


# --- the CPU: the twin, bit for bit the former code ---------------------

@pytest.mark.parametrize("heading_known", [True, False],
                         ids=["heading", "no-heading"])
@pytest.mark.parametrize("hk_n,half", [(0, False), (15, False), (16, False),
                                       (16, True)],
                         ids=["first-free", "last-free", "spill",
                              "spill-shard"])
def test_cpu_tick_equals_the_former_code(heading_known, hk_n, half):
    g = torch.Generator().manual_seed(hk_n + 2 * half)
    L2 = 2 * L_SMALL
    rows = L_SMALL if half else L2
    state, ticks, Q, kw, _ = selfcheck.ekf_predict_case(
        torch.device("cpu"), g, L_SMALL, D, hk_n, pmm_rows=rows)
    state = state._replace(Pmm=torch.randn((rows, L2), generator=g))
    shard = pk.Shard(row_lo=L2 - rows, rows=rows)
    args = (*ticks[:2], Q, kw["wheelbase"], kw["dt"], ticks[2],
            kw["sigma_phi"], heading_known, shard)
    before = pk.pmm_passes.count
    got = pk._predict_local(_copy(state), *args)
    passes = pk.pmm_passes.count - before
    want = _former_predict_local(_copy(state), *args)
    assert pk.pmm_passes.count - before == 2 * passes
    assert passes == (1 if heading_known and hk_n == D else 0)
    assert got.hk_n == want.hk_n == hk_n + (heading_known and hk_n < D)
    for f in ("x", "P00", "P0m", "Pmm", "hk", "n", "da_table"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


@pytest.mark.parametrize("heading_known,hk_n", [(True, 15), (True, 16),
                                                (False, 0)])
def test_gate_helpers_on_the_cpu(heading_known, hk_n):
    """``selfcheck``'s E1 helpers, which the gate and chip_smoke.py run on
    the card, at a small size on the CPU, where E1 is the twin: its
    errors are the eager code's and it is the eager code."""
    g = torch.Generator().manual_seed(1)
    state, ticks, Q, kw, shard = selfcheck.ekf_predict_case(
        torch.device("cpu"), g, L_SMALL, D, hk_n, pmm_rows=2 * L_SMALL)
    errs = selfcheck.ekf_predict_errors(state, ticks, Q, kw, heading_known,
                                        shard)
    want = {"pose", "map", "P00", "P0m", "hk", "Pmm"}
    assert set(errs) == want
    for e in errs.values():
        assert e["e1"] == e["eager"] and e["diff"] == 0.0
    assert errs["pose"]["eager"] > 0.0
    # The spill wrote Pmm; float32 rounding of it is seen.
    assert (errs["Pmm"]["eager"] > 0.0) == (heading_known and hk_n == D)


def test_e1_never_launches_on_the_cpu():
    cfg = ter.config(max_landmarks=ter.N_MAP)
    slam_map = ter.world()
    est = pk.ShardedEkfSlam(cfg, slam_map.n_landmarks, device="cpu")
    runner = Runner(cfg, slam_map, "EKF1", estimator=est, device="cpu")
    tk.reset_launch_counts()
    result = runner.run(seed=3, n_ticks=6 * cfg.steps_per_observe)
    assert int(result.final_state.n) > 0
    assert tk.launch_counts()["E1"] == 0
    assert sum(tk.launch_counts().values()) == 0


# --- on the card ----------------------------------------------------------

def _assert_no_worse(errs, ratio=selfcheck.E1_ERR_RATIO):
    for name, e in errs.items():
        assert e["e1"] <= ratio * e["eager"], (name, e)


@pytest.mark.cuda
@pytest.mark.parametrize("heading_known", [True, False],
                         ids=["heading", "no-heading"])
@pytest.mark.parametrize("L,hk_n", [(10_000, 0), (10_000, 15), (2_000, 16)],
                         ids=["first-free", "last-free", "spill"])
def test_e1_against_the_float64_twin_on_card(cuda, heading_known, L, hk_n):
    g = torch.Generator(device=cuda).manual_seed(L + hk_n)
    spill = heading_known and hk_n == D
    state, ticks, Q, kw, shard = selfcheck.ekf_predict_case(
        cuda, g, L, D, hk_n, pmm_rows=2 * L if spill else 0)
    launches = ke.ekf_predict_tick.launches
    before = pk.pmm_passes.count
    errs = selfcheck.ekf_predict_errors(state, ticks, Q, kw, heading_known,
                                        shard)
    assert ke.ekf_predict_tick.launches - launches == 1
    # E1, the eager code and the float64 twin each spilt once.
    assert pk.pmm_passes.count - before == 3 * spill
    assert ("Pmm" in errs) == spill
    _assert_no_worse(errs)


@pytest.mark.cuda
@pytest.mark.parametrize("heading_known", [True, False],
                         ids=["heading", "no-heading"])
@pytest.mark.parametrize("start,steer", [(math.pi - 2e-3, 0.5),
                                         (-math.pi + 2e-3, -0.5)],
                         ids=["up-through-pi", "down-through-minus-pi"])
def test_e1_carries_the_heading_through_the_wrap_on_card(
        cuda, heading_known, start, steer):
    """A tick whose heading crosses +-pi (~9e-3 rad a tick at 3 m/s and
    a steer of 0.5), with the IMU heading past it: the wrapped heading
    within twice the eager code's error, and inside the eager wrap's
    range [-pi, pi) in float32."""
    g = torch.Generator(device=cuda).manual_seed(7)
    state, _, Q, kw, shard = selfcheck.ekf_predict_case(
        cuda, g, 10_000, D, 15, heading=start)
    f32 = dict(dtype=torch.float32, device=cuda)
    phi = wrap_angle(torch.tensor(start + math.copysign(8e-3, steer), **f32))
    ticks = (torch.tensor(3.0, **f32), torch.tensor(steer, **f32), phi)
    errs = selfcheck.ekf_predict_errors(state, ticks, Q, kw, heading_known,
                                        shard)
    _assert_no_worse(errs)
    out = pk._predict_local(_copy(state), *ticks[:2], Q, kw["wheelbase"],
                            kw["dt"], ticks[2], kw["sigma_phi"],
                            heading_known, shard)
    th = float(out.x[2])
    pi32 = float(torch.tensor(math.pi, dtype=torch.float32))
    assert -pi32 <= th < pi32
    assert math.copysign(1.0, th) != math.copysign(1.0, start)


def _cpu64(state):
    """(x, P with the deferred terms folded, n, table) in float64 on the
    CPU."""
    x, P, n, table = ter.as_reference(state)
    return x.cpu(), P.cpu(), n, table.cpu()


def _drive(est, cfg, steps, spy, cuda):
    """The drive on the card: per superstep, the largest gaps (mean,
    covariance) of the port's state after the predicts and after the
    update against the reference's from the port's state before it (the
    update with the port's association, which must be the reference's
    but at near-ties)."""
    f = lambda a: torch.tensor(a, dtype=torch.float32,     # noqa: E731
                               device=cuda)
    state = est.init()
    worst = dict(predict_mean=0.0, predict_cov=0.0, mean=0.0, cov=0.0)
    for ticks, z, ids, mask in steps:
        start = _cpu64(state)
        for v, g, phi in ticks:
            state = est.predict(state, None, f(v), f(g), f(phi))
        mid = _cpu64(state)
        spy.got.clear()
        state = est.update(state, None, z.float().to(cuda),
                           ids.to(torch.int32).to(cuda), mask.to(cuda))
        decided = tuple(t.cpu() for t in spy.got[0])
        rx, rP = ter.reference_predicts(start[0], start[1], ticks, cfg)
        pm, pc = ter.gaps(mid[0], mid[1], rx, rP)
        ref = pe.superstep(*start, ticks, z.float().double(), ids, mask,
                           ter.cfg_dict(cfg), margin=ter.MARGIN,
                           decided=(decided[0].long(), decided[1].bool()))
        ter.assert_association(decided, ref)
        end = _cpu64(state)
        mean, cov = ter.gaps(end[0], end[1], ref["x"], ref["P"])
        assert end[2] == ref["n"] and torch.equal(end[3], ref["table"])
        for k, val in (("predict_mean", pm), ("predict_cov", pc),
                       ("mean", mean), ("cov", cov)):
            worst[k] = max(worst[k], val)
    return worst, int(state.n)


@pytest.mark.cuda
def test_drive_against_the_plain_reference_on_card(cuda, monkeypatch):
    """80 supersteps of the simulator's stream through ``ShardedEkfSlam``
    on the card, with E1 and then with the eager code in its place: each
    drive within the reference test's tolerances, and E1's largest gaps
    within twice the eager drive's."""
    spy = ter.Spy(monkeypatch)
    cfg = ter.config(max_landmarks=ter.N_MAP)
    steps = ter.stream(cfg, ter.world(), DRIVE_SUPERSTEPS)
    est = pk.ShardedEkfSlam(cfg, ter.N_MAP, device=cuda)
    launches = ke.ekf_predict_tick.launches
    e1, n = _drive(est, cfg, steps, spy, cuda)
    ticks = DRIVE_SUPERSTEPS * cfg.steps_per_observe
    assert ke.ekf_predict_tick.launches - launches == ticks
    monkeypatch.setattr(pk, "_predict_local", pk._predict_local_plain)
    eager, n_eager = _drive(est, cfg, steps, spy, cuda)
    assert ke.ekf_predict_tick.launches - launches == ticks
    assert n > 40 and n_eager > 40
    for worst in (e1, eager):
        assert worst["predict_mean"] < ter.MEAN_ATOL, worst
        assert worst["predict_cov"] < ter.PREDICT_COV_RTOL, worst
        assert worst["mean"] < ter.MEAN_ATOL, worst
        assert worst["cov"] < ter.COV_RTOL, worst
    for k in e1:
        assert e1[k] <= selfcheck.E1_ERR_RATIO * eager[k], (k, e1, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("heading_known", [1, 0])
def test_e1_launches_once_a_tick_on_card(cuda, heading_known):
    cfg = ter.config(SWITCH_HEADING_KNOWN=heading_known,
                     max_landmarks=ter.N_MAP)
    slam_map = ter.world()
    est = pk.ShardedEkfSlam(cfg, slam_map.n_landmarks, device=cuda)
    runner = Runner(cfg, slam_map, "EKF1", estimator=est, device=cuda)
    tk.reset_launch_counts()
    n_ticks = 10 * cfg.steps_per_observe
    result = runner.run(seed=3, n_ticks=n_ticks)
    assert result.n_ticks == n_ticks
    counts = tk.launch_counts()
    assert counts["E1"] == n_ticks and counts["S1"] == 10
    assert sum(counts.values()) == n_ticks + 10
    assert result.final_state.x.is_cuda
