"""The run loop: a host loop of supersteps (counterpart:
slam_tpu.runtime.loop, whose superstep is one ``lax.scan`` body).

A superstep is ``steps_per_observe`` control ticks — truth step, noisy
controls, the estimator's predict, dead-reckoning odometry — then one
observation and the estimator update. The heading each predict gets is
the noisy IMU heading for an EKF (``IS_EKF``), the true heading for a
particle filter. A particle filter with ``predict_multi``
(``FastSlam1Deferred``, and ``FastSlam2`` with the heading unknown) at
a particle count that is a multiple of 1024 predicts all the ticks of a
superstep in one call after them, as the JAX runner's
``_superstep_multi`` does; an EKF never does. Everything stays on the
run's device; the per-superstep traces are written into preallocated
device buffers and copied to the host once, at the end.
The only host syncs inside the loop are the particle filters' gates
(``rbpf.host_bool``), counted in ``RunResult.host_syncs``; an EKF has
none.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple

import numpy as np
import torch

from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.device import default_device
from slam_tpu_torch.maps import SlamMap
from slam_tpu_torch.models import make_estimator, rbpf
from slam_tpu_torch.sim.simulator import Simulator
from slam_tpu_torch.sim.vehicle import predict_true_position


class RunResult(NamedTuple):
    """Per-superstep traces (numpy) and the final estimator state."""
    true_pose: np.ndarray      # [T, 3]
    est_pose: np.ndarray       # [T, 3]
    active: np.ndarray         # [T] bool, vehicle not yet done
    obs_count: np.ndarray      # [T] int32 visible landmarks
    obs_range_sum: np.ndarray  # [T] float32 sum of observed ranges
    obs_z: np.ndarray          # [T, max_obs, 2] noisy observations
    obs_mask: np.ndarray       # [T, max_obs]
    obs_ids: np.ndarray        # [T, max_obs]
    odom: np.ndarray           # [T, 3] dead-reckoned relative transform
    final_state: Any
    n_ticks: int
    wall_seconds: float        # the superstep loop, ended by a sync
    compile_seconds: float     # kernel build before the loop (0 on CPU)
    host_syncs: int            # device-to-host reads inside the loop


MULTI_ALIGN = 1024   # predict_multi when P is a multiple of this


class Runner:
    """Runs one config, map and method on one device: the card, unless
    ``device`` names another (``default_device``).

    ``estimator``: a prebuilt estimator with the same interface (e.g.
    ``FastSlam1Deferred``) in place of the method's default; the run
    then takes place on its device unless ``device`` says otherwise."""

    def __init__(self, config: SlamConfig, slam_map: SlamMap,
                 method: str = "EKF1", n_particles: int | None = None,
                 device=None, estimator=None):
        self.config = config
        self.map = slam_map
        self.method = method.upper()
        if device is None and estimator is not None:
            device = estimator.device
        self.device = default_device(device)
        if estimator is None:
            estimator = make_estimator(self.method, config,
                                       slam_map.n_landmarks,
                                       device=self.device)
        elif ((estimator.device.type, estimator.device.index or 0)
              != (self.device.type, self.device.index or 0)):
            raise ValueError(f"the estimator is on {estimator.device}, "
                             f"the run on {self.device}")
        self.sim = Simulator(config, slam_map, device=self.device)
        self.est = estimator
        self.n_particles = n_particles

    def estimate_run_ticks(self, cap: int | None = None) -> int:
        """Sim-only rollout, on the CPU, to the tick at which the
        waypoint loops complete; rounded up to whole supersteps."""
        cfg = self.config
        if cap is None:
            wp = self.map.waypoints
            seg = np.linalg.norm(np.diff(np.vstack([wp, wp[:1]]), axis=0),
                                 axis=1).sum()
            cap = int(1.6 * cfg.NUMBER_LOOPS * seg / (cfg.V *
                                                      cfg.DT_CONTROLS)) + 64
        sim = Simulator(cfg.replace(SWITCH_CONTROL_NOISE=0), self.map,
                        device="cpu")
        _, _, dones = sim.rollout_controls(sim.init(), cap)
        dones = dones.numpy()
        idx = int(np.argmax(dones)) if dones.any() else cap
        period = cfg.steps_per_observe
        return max(period, ((idx + period - 1) // period) * period)

    def _control_tick(self, sim_state, dr):
        """One truth step with its noisy controls, and the dead-reckoning
        odometry over the superstep so far."""
        cfg = self.config
        sim_state, controls = self.sim.control_step(sim_state)
        dr = predict_true_position(dr, controls.v_noisy, controls.g_noisy,
                                   cfg.WHEELBASE, cfg.DT_CONTROLS)
        return sim_state, controls, dr

    def _superstep(self, sim_state, est_state, gen):
        """The control ticks of a superstep, each with its predict:
        (sim state, estimator state, odometry)."""
        ekf = getattr(self.est, "IS_EKF", False)
        dr = torch.zeros(3, dtype=torch.float32, device=self.device)
        for _ in range(self.config.steps_per_observe):
            sim_state, controls, dr = self._control_tick(sim_state, dr)
            # An EKF observes the noisy IMU heading, FastSLAM the true
            # one.
            if ekf:
                sim_state, phi = self.sim.heading_measurement(sim_state)
            else:
                phi = sim_state.vehicle.pose[2]
            est_state = self.est.predict(est_state, gen, controls.v_noisy,
                                         controls.g_noisy, phi)
        return sim_state, est_state, dr

    def _superstep_multi(self, sim_state, est_state, gen):
        """The control ticks run the simulator only and collect the noisy
        controls as a [T, 2] device tensor; then one ``predict_multi``
        call advances the particles through every tick."""
        dr = torch.zeros(3, dtype=torch.float32, device=self.device)
        vs, gs = [], []
        for _ in range(self.config.steps_per_observe):
            sim_state, controls, dr = self._control_tick(sim_state, dr)
            vs.append(controls.v_noisy)
            gs.append(controls.g_noisy)
        ctl = torch.stack([torch.stack(vs), torch.stack(gs)], dim=1)
        return sim_state, self.est.predict_multi(est_state, gen, ctl), dr

    def run(self, seed: int = 0, n_ticks: int | None = None) -> RunResult:
        cfg = self.config
        period = cfg.steps_per_observe
        if n_ticks is None:
            n_ticks = self.estimate_run_ticks()
        T = n_ticks // period
        dev = self.device

        t0 = time.perf_counter()
        if dev.type == "cuda":
            from slam_tpu_torch.ops.kernels import build
            build.load_library()
        t1 = time.perf_counter()

        sim_state = self.sim.init(seed=seed or cfg.SWITCH_SEED_RANDOM)
        est_state = self.est.init(self.n_particles)
        P = getattr(getattr(est_state, "ps", est_state), "n_particles", 0)
        superstep = (self._superstep_multi
                     if hasattr(self.est, "predict_multi")
                     and not getattr(self.est, "IS_EKF", False)
                     and P % MULTI_ALIGN == 0 else self._superstep)
        gen = self.sim.make_generator(seed + 1)
        K = self.sim.max_obs
        f32 = dict(dtype=torch.float32, device=dev)
        true_pose = torch.empty((T, 3), **f32)
        est_pose = torch.empty((T, 3), **f32)
        active = torch.empty(T, dtype=torch.bool, device=dev)
        obs_count = torch.empty(T, dtype=torch.int32, device=dev)
        range_sum = torch.empty(T, **f32)
        obs_z = torch.empty((T, K, 2), **f32)
        obs_mask = torch.empty((T, K), dtype=torch.bool, device=dev)
        obs_ids = torch.empty((T, K), dtype=torch.int32, device=dev)
        odom = torch.empty((T, 3), **f32)

        syncs0 = rbpf.host_bool.count
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        for i in range(T):
            sim_state, est_state, dr = superstep(sim_state, est_state, gen)
            sim_state, obs = self.sim.observe_step(sim_state)
            est_state = self.est.update(est_state, gen, obs.z, obs.ids,
                                        obs.mask)
            true_pose[i] = sim_state.vehicle.pose
            est_pose[i] = self.est.pose(est_state)
            active[i] = ~sim_state.vehicle.done
            obs_count[i] = obs.count
            range_sum[i] = torch.sum(torch.where(obs.mask, obs.z[:, 0],
                                                 0.0))
            obs_z[i] = obs.z
            obs_mask[i] = obs.mask
            obs_ids[i] = obs.ids
            odom[i] = dr
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        syncs = rbpf.host_bool.count - syncs0

        def host(t):
            return t.cpu().numpy()

        return RunResult(
            true_pose=host(true_pose), est_pose=host(est_pose),
            active=host(active), obs_count=host(obs_count),
            obs_range_sum=host(range_sum), obs_z=host(obs_z),
            obs_mask=host(obs_mask), obs_ids=host(obs_ids),
            odom=host(odom), final_state=est_state, n_ticks=T * period,
            wall_seconds=t3 - t2, compile_seconds=t1 - t0,
            host_syncs=syncs)
