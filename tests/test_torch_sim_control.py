"""S1, the simulator's control ticks of a superstep in one launch
(``ops.kernels.vehicle.control_multi``, ``csrc/sim_control.cu``), and
``Simulator.control_ticks``, its one caller.

- ``control_ticks`` against T calls of ``control_step`` with the dead
  reckoning of the run loop as it was (each tick on its own), bit for
  bit: noise on and off, the IMU's draws interleaved or not, a waypoint
  switch, a loop counted and an absorbed ``done``.
- ``Runner.run`` against a replay of that per-tick loop at a pinned seed,
  bit for bit: ``FastSlam1`` at P = 100 (a predict per tick),
  ``FastSlam1Deferred`` at P = 1024 (``predict_multi``) and ``EKF1``
  (the noisy IMU heading).
- The wrapper's checks: devices, dtypes, shapes.
- On a card: the kernel against its twin over whole drives (the webmap
  world's 4000 ticks, config #5's 256 from waypoint 0 and from the
  centre, a drive to ``done``, a wheelbase whose reciprocal is inexact),
  the runs against the replay, and one launch a superstep on both
  superstep paths.
"""

import os

import numpy as np
import pytest
import torch

from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.maps import SlamMap, read_map_file, synthetic_map
from slam_tpu_torch.models import FastSlam1Deferred
from slam_tpu_torch.ops import kernels as tk
from slam_tpu_torch.ops.kernels import vehicle as kv
from slam_tpu_torch.runtime import Runner
from slam_tpu_torch.sim import Simulator, init_vehicle
from slam_tpu_torch.sim.vehicle import predict_true_position
from slam_tpu_torch.spans import span

DATA = os.path.join(os.path.dirname(__file__), os.pardir, "data")
T = 8


def _line_world():
    """Three waypoints 2 m apart straight ahead of the start: the vehicle
    passes each in ~27 ticks and runs out of them by tick ~70."""
    wp = np.array([[2.0, 0.0], [4.0, 0.0], [6.0, 0.0]], np.float32)
    return SlamMap(landmarks=np.zeros((1, 2), np.float32), waypoints=wp)


def _per_tick(sim, state, n, imu):
    """The parent's per-tick loop: ``control_step``, the dead reckoning
    of ``Runner._control_tick``, and with ``imu`` the heading measured
    after each tick. (state, controls [n, 2], poses [n, 3], odometry,
    headings or None)."""
    cfg = sim.config
    dr = torch.zeros(3, dtype=torch.float32)
    ctl, poses, phis = [], [], []
    for _ in range(n):
        state, c = sim.control_step(state)
        dr = predict_true_position(dr, c.v_noisy, c.g_noisy, cfg.WHEELBASE,
                                   cfg.DT_CONTROLS)
        ctl.append(torch.stack([c.v_noisy, c.g_noisy]))
        poses.append(state.vehicle.pose)
        if imu:
            state, phi = sim.heading_measurement(state)
            phis.append(phi)
    return (state, torch.stack(ctl), torch.stack(poses), dr,
            torch.stack(phis) if imu else None)


def _equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("noise,loops,imu", [
    (1, 2, False), (1, 1, True), (0, 2, True), (0, 1, False)],
    ids=["noise-loop", "noise-done-imu", "quiet-loop-imu", "quiet-done"])
def test_control_ticks_equal_per_tick_steps(noise, loops, imu):
    cfg = SlamConfig(SWITCH_CONTROL_NOISE=noise, NUMBER_LOOPS=loops)
    sim = Simulator(cfg, _line_world(), device="cpu")
    a, b = sim.init(seed=11), sim.init(seed=11)
    seen = []
    for _ in range(20):
        a, ticks = sim.control_ticks(a, T, imu=imu)
        b, ctl, poses, dr, phis = _per_tick(sim, b, T, imu)
        for f in a.vehicle._fields:
            assert _equal(getattr(a.vehicle, f), getattr(b.vehicle, f)), f
        assert _equal(ticks.controls, ctl) and _equal(ticks.poses, poses)
        assert _equal(ticks.odometry, dr)
        assert a.tick == b.tick
        assert torch.equal(a.generator.get_state(), b.generator.get_state())
        if imu:
            assert _equal(poses[:, 2] + cfg.sigmaT * ticks.imu_draws, phis)
            assert _equal(ticks.imu_headings, phis)
        else:
            assert ticks.imu_draws is None and ticks.imu_headings is None
        seen.append((int(a.vehicle.waypoint), int(a.vehicle.loops),
                     bool(a.vehicle.done)))
    wps, left, done = zip(*seen)
    assert len(set(wps)) >= 3                     # waypoints switched
    if loops == 2:
        assert left[0] == 2 and left[-1] == 1 and not any(done)
    else:
        first = done.index(True)                  # done, and absorbed
        assert all(done[first:]) and first < len(done) - 5
        assert len(set(seen[first:])) == 1
    if noise:
        assert not torch.equal(ticks.controls[:, 0],
                               torch.full((T,), cfg.V))


# ---------------------------------------------------------------------------
# The run loop against the per-tick replay
# ---------------------------------------------------------------------------

class PerTickRunner(Runner):
    """``Runner`` with the superstep as it was before S1: each control
    tick dispatched on its own, interleaved with the predicts."""

    def _control_tick(self, sim_state, dr):
        cfg = self.config
        sim_state, controls = self.sim.control_step(sim_state)
        dr = predict_true_position(dr, controls.v_noisy, controls.g_noisy,
                                   cfg.WHEELBASE, cfg.DT_CONTROLS)
        return sim_state, controls, dr

    def _superstep(self, sim_state, est_state, gen):
        ekf = getattr(self.est, "IS_EKF", False)
        dr = torch.zeros(3, dtype=torch.float32, device=self.device)
        for _ in range(self.config.steps_per_observe):
            with span("sim.control"):
                sim_state, controls, dr = self._control_tick(sim_state, dr)
                if ekf:
                    sim_state, phi = self.sim.heading_measurement(sim_state)
                else:
                    phi = sim_state.vehicle.pose[2]
            with span("filter.predict"):
                est_state = self.est.predict(est_state, gen,
                                             controls.v_noisy,
                                             controls.g_noisy, phi)
        return sim_state, est_state, dr

    def _superstep_multi(self, sim_state, est_state, gen):
        dr = torch.zeros(3, dtype=torch.float32, device=self.device)
        vs, gs = [], []
        for _ in range(self.config.steps_per_observe):
            with span("sim.control"):
                sim_state, controls, dr = self._control_tick(sim_state, dr)
            vs.append(controls.v_noisy)
            gs.append(controls.g_noisy)
        with span("filter.predict"):
            ctl = torch.stack([torch.stack(vs), torch.stack(gs)], dim=1)
            est_state = self.est.predict_multi(est_state, gen, ctl)
        return sim_state, est_state, dr


def _tensors(state):
    """Every tensor of a (nested) estimator state, in order."""
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, tuple):
        return [t for v in state for t in _tensors(v)]
    return []


RUNS = {"FastSlam1-100": ("FASTSLAM1", 100, False),
        "FastSlam1Deferred-1024": ("FASTSLAM1", 1024, True),
        "EKF1": ("EKF1", None, False)}


def _runs(name, device, ticks=160, seed=5):
    method, P, deferred = RUNS[name]
    # The whole ring in range: observations from the first superstep.
    cfg = SlamConfig.from_ini(os.path.join(DATA, "ring40.ini")).replace(
        MAX_RANGE=200.0)
    slam_map = read_map_file(os.path.join(DATA, "ring40.mat"))
    out = []
    for cls in (Runner, PerTickRunner):
        est = (FastSlam1Deferred(cfg, slam_map.n_landmarks, device=device)
               if deferred else None)
        runner = cls(cfg, slam_map, method, n_particles=P, estimator=est,
                     device=device)
        if deferred:
            assert runner._superstep_for(runner.est.init(P)).__name__ == (
                "_superstep_multi")
        out.append(runner.run(seed=seed, n_ticks=ticks))
    return out


def _same_run(got, want):
    for f in ("true_pose", "est_pose", "active", "obs_count",
              "obs_range_sum", "obs_z", "obs_mask", "obs_ids", "odom"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    a, b = _tensors(got.final_state), _tensors(want.final_state)
    assert len(a) == len(b) > 0
    assert all(_equal(x, y) for x, y in zip(a, b))
    assert got.host_syncs == want.host_syncs


@pytest.mark.parametrize("name", list(RUNS))
def test_runner_matches_the_per_tick_replay(name):
    torch.set_num_threads(1)
    got, want = _runs(name, "cpu")
    assert got.obs_count.sum() > 0 and got.odom.any()
    _same_run(got, want)


# ---------------------------------------------------------------------------
# The wrapper's checks
# ---------------------------------------------------------------------------

def _args(device="cpu", n_wp=3, n=T):
    vehicle = init_vehicle(2, device)
    waypoints = torch.zeros((n_wp, 2), device=device)
    noise = torch.zeros((n, 2), device=device)
    return vehicle, waypoints, noise


KW = dict(V=3.0, wheelbase=4.0, dt=0.025, at_waypoint=1.0, rateg=0.35,
          maxg=0.52, sigma_v=0.3, sigma_g=0.05)


def test_control_multi_refuses_a_call_without_cuda():
    """Tensors on no CUDA device other than the CPU (the twin's) reach
    the kernel's checks and are refused, as are mixed devices."""
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kv.control_multi(*_args("meta"), **KW)
    vehicle, waypoints, noise = _args()
    with pytest.raises(ValueError, match="lie on"):
        kv.control_multi(vehicle, waypoints.to("meta"), noise, **KW)
    assert kv.control_multi.launches == 0


@pytest.mark.parametrize("field,bad", [
    ("pose", torch.zeros(3, dtype=torch.float64)),
    ("waypoint", torch.zeros((), dtype=torch.float32)),
    ("loops", torch.zeros((), dtype=torch.int64)),
    ("done", torch.zeros((), dtype=torch.int32)),
    ("noise", torch.zeros((T, 2), dtype=torch.float64)),
    ("waypoints", torch.zeros((3, 2), dtype=torch.int32))])
def test_control_multi_refuses_wrong_dtypes(field, bad):
    vehicle, waypoints, noise = _args()
    if field == "noise":
        noise = bad
    elif field == "waypoints":
        waypoints = bad
    else:
        vehicle = vehicle._replace(**{field: bad})
    with pytest.raises(ValueError, match=f"{field} has dtype"):
        kv.control_multi(vehicle, waypoints, noise, **KW)


@pytest.mark.parametrize("field,bad", [
    ("pose", torch.zeros(2)), ("steer", torch.zeros(1)),
    ("waypoints", torch.zeros((0, 2))), ("waypoints", torch.zeros((3, 3))),
    ("noise", torch.zeros((0, 2))), ("noise", torch.zeros((T, 3)))])
def test_control_multi_refuses_wrong_shapes(field, bad):
    vehicle, waypoints, noise = _args()
    if field == "noise":
        noise = bad
    elif field == "waypoints":
        waypoints = bad
    else:
        vehicle = vehicle._replace(**{field: bad})
    with pytest.raises(ValueError, match="shapes do not match"):
        kv.control_multi(vehicle, waypoints, noise, **KW)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _drive_world(name):
    """(config, map, ticks) of each drive the kernel is held on."""
    if name.startswith("webmap"):
        cfg = SlamConfig(SWITCH_HEADING_KNOWN=0)
        if name == "webmap-wb3":
            cfg = cfg.replace(WHEELBASE=3.0)
        return cfg, synthetic_map(35, 17, radius=100.0), 4000
    if name == "done":
        return SlamConfig(NUMBER_LOOPS=1), _line_world(), 256
    cfg = SlamConfig(V=3.0, WHEELBASE=4.0, MAX_RANGE=30.0)
    slam_map = synthetic_map(10_000, n_waypoints=17, radius=200.0, seed=5)
    if name == "config5-waypoint0":
        shift = slam_map.waypoints[0].copy()
        slam_map = SlamMap(landmarks=slam_map.landmarks - shift,
                           waypoints=slam_map.waypoints - shift)
    return cfg, slam_map, 256


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["webmap", "config5-waypoint0",
                                  "config5-centre", "done", "webmap-wb3"])
def test_kernel_matches_twin_over_a_drive(cuda, name):
    """A superstep's launch at a time against the twin on the card (the
    eager code), with the same noise: every output bit for bit."""
    cfg, slam_map, ticks = _drive_world(name)
    sim = Simulator(cfg, slam_map, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1234)
    noise = torch.randn((ticks, 2), generator=g, device=cuda)
    kw = sim.tick_constants()
    a = b = sim.init(seed=1).vehicle      # neither call writes its input
    launches = kv.control_multi.launches
    for t0 in range(0, ticks, T):
        rows = noise[t0:t0 + T]
        a, ctl_a, poses_a, dr_a = kv.control_multi(a, sim.waypoints, rows,
                                                   **kw)
        b, ctl_b, poses_b, dr_b = kv.control_multi_plain(
            b, sim.waypoints, rows, **kw)
        for f in a._fields:
            assert _equal(getattr(a, f), getattr(b, f)), (t0, f)
        assert _equal(ctl_a, ctl_b) and _equal(poses_a, poses_b), t0
        assert _equal(dr_a, dr_b), t0
    assert kv.control_multi.launches - launches == ticks // T
    if name == "done":
        assert bool(a.done)
    elif name.startswith("webmap"):
        assert int(a.waypoint) > 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(RUNS))
def test_runner_matches_the_per_tick_replay_on_card(cuda, name):
    got, want = _runs(name, cuda, ticks=320)
    _same_run(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [100, 1024])
def test_one_launch_a_superstep(cuda, P):
    """S1 once a superstep on both superstep paths: per-tick predicts
    (P = 100) and ``predict_multi`` (the deferred filter at 1024)."""
    cfg = SlamConfig.from_ini(os.path.join(DATA, "ring40.ini"))
    slam_map = read_map_file(os.path.join(DATA, "ring40.mat"))
    est = (FastSlam1Deferred(cfg, slam_map.n_landmarks, device=cuda)
           if P == 1024 else None)
    runner = Runner(cfg, slam_map, "FASTSLAM1", n_particles=P,
                    estimator=est, device=cuda)
    tk.reset_launch_counts()
    result = runner.run(seed=3, n_ticks=40 * cfg.steps_per_observe)
    assert result.n_ticks == 40 * cfg.steps_per_observe
    assert tk.launch_counts()["S1"] == 40
