"""F2, FastSLAM 2's predict tick in one launch
(``ops.kernels.predict.fs2_predict_tick``, ``csrc/predict.cu``), and
``FastSlam2.predict``, which sends a CUDA state to it and any other to
the plain twin, ``FastSlam2._predict_plain`` (the eager tick).

On the CPU:

- ``FastSlam2.predict`` runs the twin, counted in
  ``fastslam2.fs2_predict_ticks.eager``; ``fused`` and F2's launches stay
  0, through ``Runner`` too;
- the twin bit for bit the former eager tick (kept below as it was), the
  heading known and unknown, the noise on and off, over several ticks;
- the heading update leaves a state with Pv == 0 as it was (the heading
  as the wrap leaves it);
- the wrapper's refusals: dtypes, contiguity, shapes, a state off the
  card; phi is read only with the heading;
- ``benchmark/metrics/fs2_predict_fused_share.py``: None without the
  counter or with no tick, the share with it.

On a card (``-m cuda``):

- F2 bit-equal to the twin run on CUDA tensors at P = 2^17 and 2^17 +
  37, the heading known and unknown, the noise on and off, Pv zero and
  not; across +-pi; at a wheelbase that is no power of two;
- 100 supersteps of ``Runner`` on the FastSLAM 2 cell's configuration
  at 2^17 with F2 and with the twin forced on the card: the final state
  and the nine traces hash equal, for three seeds, with one F2 launch a
  tick.

Jax-free.
"""

import hashlib
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.geometry import wrap_angle
from slam_tpu_torch.maps import SlamMap, read_map_file
from slam_tpu_torch.models import FastSlam2, rbpf
from slam_tpu_torch.models import fastslam2 as fs2
from slam_tpu_torch.ops import kernels as tk
from slam_tpu_torch.ops.kernels import predict as kp
from slam_tpu_torch.ops.kernels import selfcheck
from slam_tpu_torch.runtime import Runner
from slam_tpu_torch.spans import span

ROOT = Path(__file__).resolve().parents[1]
CELL = ROOT / "benchmark" / "configs" / "dense200-fs2-131072.json"
P_CPU = 256
P_CARD = 2 ** 17
ARMS = [(True, False), (True, True), (False, False), (False, True)]
ARM_IDS = ["heading", "heading-noise", "no-heading", "no-heading-noise"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: F2 is a CUDA kernel with no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.fixture
def ticks_counter(monkeypatch):
    """``fs2_predict_ticks`` from zero for the test."""
    counter = type(fs2.fs2_predict_ticks)(fused=0, eager=0)
    monkeypatch.setattr(fs2, "fs2_predict_ticks", counter)
    return counter


# --- the former eager tick, as it was ----------------------------------

def _former_sample_controls(vn, gn, Q, n, generator, add_noise=True):
    """``rbpf.sample_controls`` before F2, as it was."""
    l00, l10, l11 = rbpf.control_noise_factor(Q)
    eps = torch.randn((2, n), generator=generator, device=generator.device)
    n0 = l00 * eps[0]
    n1 = l10 * eps[0] + l11 * eps[1]
    on = float(add_noise)
    return vn + on * n0, gn + on * n1


def _former_predict(est, state, generator, vn, gn, phi_true):
    """``FastSlam2.predict`` before F2 (with ``fs2_predict`` inlined), as
    it was."""
    cfg = est.config
    V, G = _former_sample_controls(vn, gn, est.Q, state.n_particles,
                                   generator,
                                   bool(cfg.SWITCH_PREDICT_NOISE))
    xv, Pv = fs2.propagate_pose_covariance(state.xv, state.Pv, V, G, est.Q,
                                           cfg.WHEELBASE, cfg.DT_CONTROLS)
    state = state._replace(xv=xv, Pv=Pv)
    if cfg.SWITCH_HEADING_KNOWN:
        with span("fs2.heading"):
            state = rbpf.observe_heading_particles(state, phi_true,
                                                   cfg.sigmaT)
    return state


# --- the CPU: the twin ---------------------------------------------------

def test_cpu_predict_runs_the_twin_and_counts_it(ticks_counter):
    g = torch.Generator().manual_seed(1)
    est, state, ticks = selfcheck.fs2_tick_case(torch.device("cpu"), g,
                                                P_CPU)
    launches = kp.fs2_predict_tick.launches
    for _ in range(3):
        state = est.predict(state, g, *ticks)
    assert (ticks_counter.eager, ticks_counter.fused) == (3, 0)
    assert kp.fs2_predict_tick.launches == launches


@pytest.mark.parametrize("heading_known", [1, 0],
                         ids=["heading", "no-heading"])
def test_cpu_runner_never_launches_f2(ticks_counter, heading_known):
    cfg = SlamConfig.from_ini(str(ROOT / "data" / "dense200.ini")).replace(
        SWITCH_HEADING_KNOWN=heading_known)
    m = read_map_file(str(ROOT / "data" / "dense200.mat"))
    shift = m.waypoints[0].copy()
    slam_map = SlamMap(landmarks=m.landmarks - shift,
                       waypoints=m.waypoints - shift)
    tk.reset_launch_counts()
    n_ticks = 3 * cfg.steps_per_observe
    Runner(cfg, slam_map, "FASTSLAM2", n_particles=P_CPU,
           device="cpu").run(seed=3, n_ticks=n_ticks)
    assert (ticks_counter.eager, ticks_counter.fused) == (n_ticks, 0)
    assert tk.launch_counts()["F2"] == 0


@pytest.mark.parametrize("heading_known,noise", ARMS, ids=ARM_IDS)
@pytest.mark.parametrize("pv_zero", [False, True], ids=["pv", "pv-zero"])
def test_cpu_tick_equals_the_former_code(heading_known, noise, pv_zero):
    """Four ticks by ``FastSlam2.predict`` on the CPU and by the former
    code, each from its own generator of one seed: bit for bit."""
    g = torch.Generator().manual_seed(2 + 2 * heading_known + noise)
    est, state, ticks = selfcheck.fs2_tick_case(
        torch.device("cpu"), g, P_CPU, heading_known=heading_known,
        noise=noise, pv_zero=pv_zero)
    got = state._replace(xv=state.xv.clone(), Pv=state.Pv.clone())
    want = state
    g_got = torch.Generator().manual_seed(5)
    g_want = torch.Generator().manual_seed(5)
    for _ in range(4):
        got = est.predict(got, g_got, *ticks)
        want = _former_predict(est, want, g_want, *ticks)
    for a, b in ((got.xv, want.xv), (got.Pv, want.Pv)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not torch.equal(got.xv, state.xv)
    # Both drew the same numbers: the generators are at one place.
    assert torch.equal(g_got.get_state(), g_want.get_state())


def test_heading_update_is_a_no_op_while_pv_is_zero():
    g = torch.Generator().manual_seed(4)
    est, state, (_, _, phi) = selfcheck.fs2_tick_case(
        torch.device("cpu"), g, P_CPU, pv_zero=True)
    out = rbpf.observe_heading_particles(state, phi, est.config.sigmaT)
    assert torch.equal(out.xv[:2], state.xv[:2])
    assert torch.equal(out.xv[2], wrap_angle(state.xv[2]))
    assert float((out.xv[2] - state.xv[2]).abs().max()) < 1e-6
    assert torch.equal(out.Pv, torch.zeros_like(state.Pv))


# --- the wrapper's refusals -----------------------------------------------

def _args():
    """The wrapper's arguments on the CPU, and its keywords."""
    g = torch.Generator().manual_seed(0)
    est, state, ticks = selfcheck.fs2_tick_case(torch.device("cpu"), g, 64)
    eps = rbpf.control_noise(64, g)
    kw = dict(wheelbase=est.config.WHEELBASE, dt=est.config.DT_CONTROLS,
              r=est.config.sigmaT ** 2, add_noise=False, heading_known=True)
    return [state.xv, state.Pv, eps, *ticks, est._chol_q, est._q], kw


def _refused(name, args):
    xv, Pv, eps, vn, gn, phi, chol_q, q = args
    if name == "dtype":
        xv = xv.double()
    elif name == "not-a-tensor":
        vn = 2.0
    elif name == "contiguity":
        Pv = Pv.T.contiguous().T
    elif name == "Pv-shape":
        Pv = torch.zeros((6, Pv.shape[1] + 1))
    elif name == "eps-shape":
        eps = torch.zeros((3, eps.shape[1]))
    elif name == "phi-shape":
        phi = phi.reshape(1)
    return [xv, Pv, eps, vn, gn, phi, chol_q, q]


@pytest.mark.parametrize("name,match", [
    ("dtype", "float32"), ("not-a-tensor", "float32"),
    ("contiguity", "contiguous"), ("Pv-shape", "shapes"),
    ("eps-shape", "shapes"), ("phi-shape", "shapes"),
    ("cpu", "one CUDA device")])
def test_wrapper_refuses(name, match):
    args, kw = _args()
    launches = kp.fs2_predict_tick.launches
    with pytest.raises(ValueError, match=match):
        kp.fs2_predict_tick(*_refused(name, args), **kw)
    assert kp.fs2_predict_tick.launches == launches


def test_wrapper_reads_phi_only_with_the_heading():
    """Without the heading observed, phi is not checked: a bad one passes
    the checks and the CPU is refused as for any state."""
    args, kw = _args()
    args[5] = None
    with pytest.raises(ValueError, match="one CUDA device"):
        kp.fs2_predict_tick(*args, **dict(kw, heading_known=False))


def test_shape_check_needs_no_card():
    kp._check_tick_shapes(((3, 10), (6, 10), (2, 10), (), (), ()))
    with pytest.raises(ValueError, match="shapes"):
        kp._check_tick_shapes(((3, 10), (6, 11), (2, 10), (), (), ()))
    with pytest.raises(ValueError, match="shapes"):
        kp._check_tick_shapes(((3, 10), (6, 10), (2, 10), (1,), (), ()))


# --- the per-layer metric's reader ----------------------------------------

def _fused_share():
    path = ROOT / "benchmark" / "metrics" / "fs2_predict_fused_share.py"
    spec = importlib.util.spec_from_file_location("fused_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("counter,want", [
    (None, None), (dict(fused=0, eager=0), None),
    (dict(fused=0, eager=800), 0.0), (dict(fused=8800, eager=0), 100.0),
    (dict(fused=3, eager=1), 75.0)],
    ids=["no-counter", "no-tick", "eager-only", "fused-only", "mixed"])
def test_fused_share_reader(monkeypatch, counter, want):
    if counter is None:
        monkeypatch.delattr(fs2, "fs2_predict_ticks")
    else:
        monkeypatch.setattr(fs2, "fs2_predict_ticks",
                            type(fs2.fs2_predict_ticks)(**counter))
    assert _fused_share()({}) == want


# --- on the card ------------------------------------------------------------

def _assert_f2_is_the_twin(est, state, ticks, seed=11):
    launches = kp.fs2_predict_tick.launches
    got, want = selfcheck.fs2_tick_pair(est, state, ticks, seed)
    torch.cuda.synchronize()
    assert kp.fs2_predict_tick.launches - launches == 1
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b), float((a - b).abs().max())
    assert not torch.equal(got[0], state.xv)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("heading_known,noise", ARMS, ids=ARM_IDS)
@pytest.mark.parametrize("pv_zero", [False, True], ids=["pv", "pv-zero"])
@pytest.mark.parametrize("P", [P_CARD, P_CARD + 37],
                         ids=["2^17", "2^17+37"])
def test_f2_bit_equal_to_the_twin_on_card(cuda, P, heading_known, noise,
                                          pv_zero):
    g = torch.Generator(device=cuda).manual_seed(P + heading_known)
    est, state, ticks = selfcheck.fs2_tick_case(
        cuda, g, P, heading_known=heading_known, noise=noise,
        pv_zero=pv_zero)
    _assert_f2_is_the_twin(est, state, ticks)


@pytest.mark.cuda
@pytest.mark.parametrize("heading_known", [True, False],
                         ids=["heading", "no-heading"])
@pytest.mark.parametrize("start,steer", [(math.pi - 5e-3, 0.5),
                                         (-math.pi + 5e-3, -0.5)],
                         ids=["up-through-pi", "down-through-minus-pi"])
def test_f2_carries_the_heading_through_pi_on_card(cuda, heading_known,
                                                   start, steer):
    """A tick whose turn (~0.0125 rad at 2 m/s, a steer of 0.5 and a
    wheelbase of 2 m) carries every heading across +-pi, the true heading
    0.8 rad past it: bit-equal, and the headings wrapped."""
    g = torch.Generator(device=cuda).manual_seed(9)
    est, state, (vn, _, phi) = selfcheck.fs2_tick_case(
        cuda, g, P_CARD, heading_known=heading_known, heading=start,
        wheelbase=2.0)
    gn = torch.tensor(steer, dtype=torch.float32, device=cuda)
    xv, _ = _assert_f2_is_the_twin(est, state, (vn, gn, phi))
    th = xv[2]
    pi32 = float(torch.tensor(math.pi, dtype=torch.float32))
    assert float(th.min()) >= -pi32 and float(th.max()) < pi32
    assert bool((torch.sign(th) != math.copysign(1.0, start)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("heading_known,noise", ARMS, ids=ARM_IDS)
def test_f2_at_a_wheelbase_that_is_no_power_of_two_on_card(
        cuda, heading_known, noise):
    """ATen divides a CUDA tensor by a host scalar as a product with its
    float32 reciprocal; F2 does the same, so the twin's bits hold at any
    wheelbase."""
    g = torch.Generator(device=cuda).manual_seed(283)
    est, state, ticks = selfcheck.fs2_tick_case(
        cuda, g, P_CARD, heading_known=heading_known, noise=noise,
        wheelbase=2.83)
    _assert_f2_is_the_twin(est, state, ticks)


def _cell():
    """The FastSLAM 2 cell's configuration and world: dense200 shifted
    so that waypoint 0 is the origin."""
    cfg = SlamConfig(**json.loads(CELL.read_text())["slam"])
    m = read_map_file(str(ROOT / "data" / "dense200.mat"))
    shift = m.waypoints[0].copy()
    return cfg, SlamMap(landmarks=m.landmarks - shift,
                        waypoints=m.waypoints - shift)


def _digest(result) -> str:
    h = hashlib.sha256()
    for name in ("true_pose", "est_pose", "active", "obs_count",
                 "obs_range_sum", "obs_z", "obs_mask", "obs_ids", "odom"):
        h.update(np.ascontiguousarray(getattr(result, name)).tobytes())
    for t in result.final_state:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3250000101, 3250000102, 3250000103])
def test_runner_hashes_equal_with_f2_and_the_twin_on_card(
        cuda, monkeypatch, ticks_counter, seed):
    cfg, slam_map = _cell()
    n_ticks = 100 * cfg.steps_per_observe
    runner = Runner(cfg, slam_map, "FASTSLAM2", n_particles=P_CARD,
                    device=cuda)
    tk.reset_launch_counts()
    fused = runner.run(seed=seed, n_ticks=n_ticks)
    assert tk.launch_counts()["F2"] == n_ticks
    assert (ticks_counter.fused, ticks_counter.eager) == (n_ticks, 0)
    monkeypatch.setattr(FastSlam2, "_predict_fused",
                        FastSlam2._predict_plain)
    tk.reset_launch_counts()
    eager = runner.run(seed=seed, n_ticks=n_ticks)
    assert tk.launch_counts()["F2"] == 0
    assert (ticks_counter.fused, ticks_counter.eager) == (n_ticks, n_ticks)
    assert int(fused.final_state.n) > 0
    assert _digest(fused) == _digest(eager)
