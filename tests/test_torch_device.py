"""Where the port's entry points run when no device is named: on the
card, and nowhere when there is none.

``default_device(None)`` is ``cuda`` and raises without a card; an
explicit device is taken as given. ``Runner``, ``Simulator``, the
estimators, ``make_estimator``, the CLI and the functions that make a
particle or EKF state or carry one over from numpy go through it, so on a
machine without a card each of them fails with the same message unless
the caller asks for the CPU. The card's absence is simulated, so these
tests say the same on a machine that has one.
"""

import os
import re

import numpy as np
import pytest
import torch

import slam_tpu_torch
from slam_tpu_torch import SlamConfig, default_device, synthetic_map
from slam_tpu_torch.cli import main
from slam_tpu_torch.models import ekf, particles
from slam_tpu_torch.models import (
    EkfSlam,
    FastSlam1,
    FastSlam1Deferred,
    FastSlam2,
    make_estimator,
)
from slam_tpu_torch.parallel import ekf as pekf
from slam_tpu_torch.runtime import Runner
from slam_tpu_torch.sim.simulator import Simulator

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
RING40 = os.path.join(ROOT, "data", "ring40.mat")
NO_CARD = "torch.cuda.is_available\\(\\) is False"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def world():
    return SlamConfig(), synthetic_map(12, 9, radius=30.0)


def test_default_device_without_a_card_raises(no_card):
    with pytest.raises(RuntimeError, match=NO_CARD) as err:
        default_device()
    assert 'device="cpu"' in str(err.value)     # says how to get the CPU
    with pytest.raises(RuntimeError, match=NO_CARD):
        default_device(None)


@pytest.mark.parametrize("given,want", [
    ("cpu", torch.device("cpu")),
    (torch.device("cpu"), torch.device("cpu")),
    ("cuda:0", torch.device("cuda", 0)),
    ("cuda", torch.device("cuda")),
    (torch.device("cuda", 1), torch.device("cuda", 1)),
], ids=str)
def test_default_device_takes_an_explicit_device_as_given(no_card, given,
                                                          want):
    """No look at the machine: a named card that is absent fails where
    it is first used, not here."""
    assert default_device(given) == want


def test_default_device_is_the_card_when_there_is_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device() == torch.device("cuda")


ENTRY_POINTS = {
    "Runner": lambda cfg, m, **kw: Runner(cfg, m, **kw),
    "Runner-FASTSLAM2": lambda cfg, m, **kw: Runner(cfg, m, "FASTSLAM2",
                                                    **kw),
    "Simulator": lambda cfg, m, **kw: Simulator(cfg, m, **kw),
    "FastSlam1": lambda cfg, m, **kw: FastSlam1(cfg, m.n_landmarks, **kw),
    "FastSlam1Deferred": lambda cfg, m, **kw: FastSlam1Deferred(
        cfg, m.n_landmarks, **kw),
    "FastSlam2": lambda cfg, m, **kw: FastSlam2(cfg, m.n_landmarks, **kw),
    "make_estimator-FASTSLAM1": lambda cfg, m, **kw: make_estimator(
        "FASTSLAM1", cfg, m.n_landmarks, **kw),
    "make_estimator-FASTSLAM2": lambda cfg, m, **kw: make_estimator(
        "FASTSLAM2", cfg, m.n_landmarks, **kw),
    "Runner-FASTSLAM1": lambda cfg, m, **kw: Runner(cfg, m, "FASTSLAM1",
                                                    **kw),
    "EkfSlam": lambda cfg, m, **kw: EkfSlam(cfg, m.n_landmarks, **kw),
    "ShardedEkfSlam": lambda cfg, m, **kw: pekf.ShardedEkfSlam(
        cfg, m.n_landmarks, **kw),
    "make_estimator-EKF1": lambda cfg, m, **kw: make_estimator(
        "EKF1", cfg, m.n_landmarks, **kw),
}


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_without_a_device_refuses_to_start(no_card, world,
                                                       name):
    with pytest.raises(RuntimeError, match=NO_CARD):
        ENTRY_POINTS[name](*world)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_runs_on_the_cpu_when_asked(no_card, world, name):
    obj = ENTRY_POINTS[name](*world, device="cpu")
    assert obj.device == torch.device("cpu")
    if isinstance(obj, Runner):
        assert obj.est.device == obj.sim.device == torch.device("cpu")


def test_runner_takes_its_estimators_device(no_card, world):
    cfg, m = world
    est = FastSlam1Deferred(cfg, m.n_landmarks, device="cpu")
    runner = Runner(cfg, m, estimator=est)
    assert runner.device == runner.sim.device == torch.device("cpu")


def test_cpu_run_and_its_tick_estimate_stay_on_the_cpu(no_card, world):
    """``estimate_run_ticks`` builds its own simulator, on the CPU by
    name; nothing in a CPU run asks for the default device."""
    cfg, m = world
    runner = Runner(cfg, m, n_particles=8, device="cpu")
    assert runner.estimate_run_ticks(cap=64) % cfg.steps_per_observe == 0
    result = runner.run(seed=1, n_ticks=2 * cfg.steps_per_observe)
    assert np.isfinite(result.est_pose).all()
    assert {t.device for t in _tensors(result.final_state)} == {
        torch.device("cpu")}


def _tensors(state):
    return [t for t in state if isinstance(t, torch.Tensor)]


def _state_arrays():
    return particles.state_to_numpy(
        particles.init_particles(4, 2, 3, device="cpu"))


STATE_MAKERS = {
    "init_particles": lambda **kw: particles.init_particles(4, 2, 3, **kw),
    "state_from_numpy": lambda **kw: particles.state_from_numpy(
        _state_arrays(), **kw),
    "deferred_state_from_numpy": lambda **kw: (
        particles.deferred_state_from_numpy(
            {"ps": _state_arrays(), "S": np.arange(1, 5)}, **kw).ps),
    "ekf_init": lambda **kw: ekf.ekf_init(3, 5, **kw),
    "ekf_state_from_numpy": lambda **kw: ekf.ekf_state_from_numpy(
        ekf.ekf_state_to_numpy(ekf.ekf_init(3, 5, device="cpu")), **kw),
    "sharded_ekf_init": lambda **kw: pekf.sharded_ekf_init(3, 5, **kw),
    "sharded_state_from_numpy": lambda **kw: pekf.sharded_state_from_numpy(
        pekf.sharded_state_to_numpy(pekf.sharded_ekf_init(
            3, 5, device="cpu")), **kw),
}


@pytest.mark.parametrize("name", STATE_MAKERS)
def test_state_without_a_device_refuses_without_a_card(no_card, name):
    """The ways to make or carry a state follow the entry points: no
    device named is the card, never the CPU."""
    with pytest.raises(RuntimeError, match=NO_CARD):
        STATE_MAKERS[name]()
    state = STATE_MAKERS[name](device="cpu")
    assert {t.device for t in _tensors(state)} == {torch.device("cpu")}


def test_cli_without_a_device_fails_without_a_card(no_card, tmp_path,
                                                   capsys):
    rc = main(["-m", RING40, "-particles", "8", "-ticks", "16", "-out",
               str(tmp_path)])
    err = capsys.readouterr().err
    assert rc != 0
    assert re.search(NO_CARD, err) and "-device cpu" in err
    assert not os.listdir(tmp_path)             # nothing ran


def test_cli_with_device_cpu_runs(no_card, tmp_path, capsys):
    rc = main(["-m", RING40, "-particles", "8", "-ticks", "16", "-device",
               "cpu", "-n", "run", "-out", str(tmp_path)])
    assert rc == 0
    assert " on cpu" in capsys.readouterr().err
    assert (tmp_path / "run" / "results.txt").exists()


def test_no_module_falls_back_to_the_cpu():
    """The two fallbacks this port once had, by their text."""
    package = os.path.dirname(slam_tpu_torch.__file__)
    sources = [os.path.join(d, f) for d, _, files in os.walk(package)
               for f in files if f.endswith(".py")]
    sources.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(sources) > 20
    for path in sources:
        text = open(path).read()
        assert 'or "cpu"' not in text, path
        assert "is_available() else" not in text, path


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: checks the default device on a "
                    "machine that has a card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_entry_points_default_to_the_card(cuda, world):
    cfg, m = world
    for method in ("EKF1", "FASTSLAM1"):
        runner = Runner(cfg, m, method, n_particles=8)
        assert runner.device.type == runner.est.device.type == "cuda"
        assert runner.sim.landmarks.is_cuda
        result = runner.run(seed=1, n_ticks=2 * cfg.steps_per_observe)
        assert all(t.is_cuda for t in _tensors(result.final_state))
