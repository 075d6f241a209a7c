"""The window of ``slam_tpu_torch.runtime.profiling`` on the CPU: the
measured supersteps, their host syncs and launches, and the estimator
left as it was. The profile itself needs a card (``main`` refuses to
run without one); here the device syncs at the window's ends are
no-ops."""

import os

import pytest
import torch

from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.maps import read_map_file
from slam_tpu_torch.runtime import profiling
from slam_tpu_torch.runtime.loop import Runner

DATA = os.path.join(os.path.dirname(__file__), os.pardir, "data")


@pytest.fixture
def no_device_sync(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


@pytest.mark.parametrize("method", ["FASTSLAM1", "FASTSLAM2"])
def test_window_counts_the_measured_supersteps(no_device_sync, method):
    cfg = SlamConfig.from_ini(os.path.join(DATA, "ring40.ini"))
    slam_map = read_map_file(os.path.join(DATA, "ring40.mat"))
    runner = Runner(cfg, slam_map, method, n_particles=16, device="cpu")
    est, calls = runner.est, []
    update = est.update
    est.update = lambda *a, **k: calls.append(1) or update(*a, **k)
    out = profiling.window_run(runner, seed=3, warm=3, n=4)
    assert len(calls) == 7
    assert out["wall_ms"] > 0
    # The resample gate, once a superstep; no kernel launches on the CPU.
    assert out["host_syncs"] == 1.0 and out["launches"] == {}
    assert runner.est is est


def test_slices_build_their_runners():
    for name in ("eager-small", "fs2-small"):
        runner = profiling.slice_runner(name, torch.device("cpu"))
        assert runner.n_particles == 100 and runner.map.n_landmarks == 200
        assert runner.method == {"eager-small": "FASTSLAM1",
                                 "fs2-small": "FASTSLAM2"}[name]
    # Every slice but ba-10k, which runs no filter loop, has a window.
    assert set(profiling.WINDOWS) == set(profiling.SLICES) - {"ba-10k"}


@pytest.mark.parametrize("name", ["ekf-webmap", "ekf-10k"])
def test_ekf_slices_run_their_window(no_device_sync, monkeypatch, name):
    """The EKF slices at a tiny size on the CPU (ekf-10k cut to 300
    landmarks): the estimator the JAX package's line runs, and a window
    with no host sync and no kernel launch."""
    from slam_tpu_torch.models import EkfSlam
    from slam_tpu_torch.parallel.ekf import ShardedEkfSlam

    monkeypatch.setattr(profiling, "EKF10K_LANDMARKS", 300)
    runner = profiling.slice_runner(name, torch.device("cpu"))
    assert runner.method == "EKF1"
    if name == "ekf-10k":
        assert type(runner.est) is ShardedEkfSlam
        assert runner.est.capacity == runner.map.n_landmarks == 300
        assert runner.config.SWITCH_HEADING_KNOWN
    else:
        assert type(runner.est) is EkfSlam
        assert runner.map.n_landmarks == 35
        assert not runner.config.SWITCH_HEADING_KNOWN
    out = profiling.window_run(runner, seed=3, warm=2, n=3)
    assert out["host_syncs"] == 0.0 and out["launches"] == {}


@pytest.mark.parametrize("name", ["eager-small", "ba-10k"])
def test_main_refuses_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        profiling.main(["--slice", name])


def test_ba_products_are_the_first_trials_operands():
    """The Schur product's operands W [3T, 2L] and W All^-1, and the
    reduced system S [3T, 3T] that the first trial of a solve factors:
    the trial's step from S equals the solver's own step."""
    from slam_tpu_torch.posegraph import ba
    from slam_tpu_torch.posegraph.synthetic import make_ba_problem

    prob = make_ba_problem(12, 80, K=6, device="cpu")[0]
    W, WA, S = profiling.ba_products(prob)
    T, L = prob.T, prob.L
    assert W.shape == WA.shape == (3 * T, 2 * L) and S.shape == (3 * T,
                                                                 3 * T)
    poses, landmarks, static, plan, lam = ba._start(prob, 1e-3)
    _, _, _, bp, bl = ba._gn_normal_blocks(poses, landmarks, *static[:6],
                                           static[6], L, plan)
    dp = ba._solve_pos(S, bp - WA @ bl.reshape(-1))
    want, _ = ba._gn_step(poses, landmarks, *static, lam, plan)
    assert torch.equal(ba._step_poses(poses, dp), want)
