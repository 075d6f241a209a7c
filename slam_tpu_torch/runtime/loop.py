"""The run loop: a host loop of supersteps (counterpart:
slam_tpu.runtime.loop, whose superstep is one ``lax.scan`` body).

A superstep is ``steps_per_observe`` control ticks — truth step, noisy
controls, particle predict, dead-reckoning odometry — then one
observation and the estimator update. Everything stays on the run's
device; the per-superstep traces are written into preallocated device
buffers and copied to the host once, at the end. The only host syncs
inside the loop are the estimator's gates (``rbpf.host_bool``), counted
in ``RunResult.host_syncs``.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple

import numpy as np
import torch

from slam_tpu_torch.config import SlamConfig
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


class Runner:
    """Config + map + method bound run driver on one device."""

    def __init__(self, config: SlamConfig, slam_map: SlamMap,
                 method: str = "FASTSLAM1", n_particles: int | None = None,
                 device=None):
        self.config = config
        self.map = slam_map
        self.method = method.upper()
        self.device = torch.device(device or "cpu")
        self.sim = Simulator(config, slam_map, device=self.device)
        self.est = make_estimator(self.method, config, slam_map.n_landmarks,
                                  device=self.device)
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
        sim = Simulator(cfg.replace(SWITCH_CONTROL_NOISE=0), self.map)
        _, _, dones = sim.rollout_controls(sim.init(), cap)
        dones = dones.numpy()
        idx = int(np.argmax(dones)) if dones.any() else cap
        period = cfg.steps_per_observe
        return max(period, ((idx + period - 1) // period) * period)

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
            dr = torch.zeros(3, **f32)
            for _ in range(period):
                sim_state, controls = self.sim.control_step(sim_state)
                # FastSLAM observes the TRUE heading per tick.
                phi = sim_state.vehicle.pose[2]
                est_state = self.est.predict(est_state, gen,
                                             controls.v_noisy,
                                             controls.g_noisy, phi)
                dr = predict_true_position(dr, controls.v_noisy,
                                           controls.g_noisy,
                                           cfg.WHEELBASE, cfg.DT_CONTROLS)
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
