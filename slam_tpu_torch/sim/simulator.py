"""The simulation driver: truth propagation, noisy controls and noisy
observations (counterpart: slam_tpu.sim.simulator).

Noise comes from a ``torch.Generator`` carried in the state; every
step also takes its standard normals as an argument, so tests can feed
the JAX package's draws and compare the two step for step.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.device import default_device
from slam_tpu_torch.maps import SlamMap
from slam_tpu_torch.ops.kernels.vehicle import control_multi
from slam_tpu_torch.sim.sensors import Observation, observe
from slam_tpu_torch.sim.vehicle import (
    VehicleState,
    init_vehicle,
    noisy_controls,
    steer_and_move,
)


class SimState(NamedTuple):
    vehicle: VehicleState
    generator: torch.Generator   # noise stream, advanced in place
    tick: int


class Controls(NamedTuple):
    """Truth controls and the noisy copies fed to the estimator."""
    v_true: float
    g_true: torch.Tensor
    v_noisy: torch.Tensor
    g_noisy: torch.Tensor


class ControlTicks(NamedTuple):
    """The control ticks of one ``Simulator.control_ticks`` call."""
    controls: torch.Tensor      # [T, 2] noisy (v, g), the estimator's
    poses: torch.Tensor         # [T, 3] truth pose after each tick
    odometry: torch.Tensor      # [3] dead reckoning over the T ticks
    imu_draws: torch.Tensor | None  # [T] heading_measurement's uniforms
    imu_headings: torch.Tensor | None  # [T] heading_measurement's values


def _f32_sqrt(v: float) -> float:
    """sqrt in float32, as the JAX package takes it of its f32 Q/R."""
    return float(np.sqrt(np.float32(v)))


class Simulator:
    """Simulation for one (config, map) pair on one device: the card,
    unless ``device`` names another (``default_device``)."""

    def __init__(self, config: SlamConfig, slam_map: SlamMap, device=None):
        self.config = config
        self.device = default_device(device)
        self.landmarks = torch.as_tensor(slam_map.landmarks,
                                         dtype=torch.float32,
                                         device=self.device)
        self.waypoints = torch.as_tensor(slam_map.waypoints,
                                         dtype=torch.float32,
                                         device=self.device)
        self.max_obs = config.max_observations or _default_max_obs(
            slam_map, config.MAX_RANGE)
        self._sigma_q = [_f32_sqrt(q) for q in config.Q]
        self._sigma_r = [_f32_sqrt(r) for r in config.R]

    def make_generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def init(self, seed: int | None = None) -> SimState:
        seed = self.config.SWITCH_SEED_RANDOM if seed is None else seed
        return SimState(
            vehicle=init_vehicle(self.config.NUMBER_LOOPS, self.device),
            generator=self.make_generator(seed), tick=0)

    def control_step(self, state: SimState, noise=None
                     ) -> tuple[SimState, Controls]:
        """Advance the truth one control tick and draw noisy controls.
        ``noise``: two standard normals, or None to draw them."""
        cfg = self.config
        vehicle = steer_and_move(
            state.vehicle, self.waypoints,
            V=cfg.V, wheelbase=cfg.WHEELBASE, dt=cfg.DT_CONTROLS,
            at_waypoint=cfg.AT_WAYPOINT, rateg=cfg.RATEG, maxg=cfg.MAXG)
        if not cfg.SWITCH_CONTROL_NOISE:
            noise = torch.zeros(2, device=self.device)
        elif noise is None:
            noise = torch.randn(2, generator=state.generator,
                                device=self.device)
        v_noisy, g_noisy = noisy_controls(vehicle.steer, noise, cfg.V,
                                          *self._sigma_q)
        controls = Controls(v_true=cfg.V, g_true=vehicle.steer,
                            v_noisy=v_noisy, g_noisy=g_noisy)
        return state._replace(vehicle=vehicle,
                              tick=state.tick + 1), controls

    def tick_constants(self) -> dict:
        """The configuration's numbers a control tick takes, as
        ``control_multi``'s keywords."""
        cfg = self.config
        return dict(V=cfg.V, wheelbase=cfg.WHEELBASE, dt=cfg.DT_CONTROLS,
                    at_waypoint=cfg.AT_WAYPOINT, rateg=cfg.RATEG,
                    maxg=cfg.MAXG, sigma_v=self._sigma_q[0],
                    sigma_g=self._sigma_q[1])

    def control_ticks(self, state: SimState, n_ticks: int,
                      imu: bool = False) -> tuple[SimState, ControlTicks]:
        """``n_ticks`` calls of ``control_step`` in one launch of S1
        (``ops.kernels.vehicle.control_multi``; its twin on the CPU),
        with the dead-reckoning odometry over them. The noise is drawn
        tick by tick from the state's generator before the launch, as
        ``control_step`` draws it; with ``imu`` each tick's uniform for
        ``heading_measurement`` follows its normals, and the T noisy
        headings are computed from them in one product and one sum. A run
        so draws the stream that ``control_step`` and
        ``heading_measurement``, called tick by tick, would draw."""
        cfg = self.config
        f32 = dict(dtype=torch.float32, device=self.device)
        noisy = bool(cfg.SWITCH_CONTROL_NOISE)
        noise = (torch.empty if noisy else torch.zeros)((n_ticks, 2), **f32)
        draws = torch.empty(n_ticks, **f32) if imu else None
        for t in range(n_ticks):
            if noisy:
                torch.randn(2, generator=state.generator, out=noise[t])
            if imu:
                torch.rand((), generator=state.generator, out=draws[t])
        vehicle, ctl, poses, odometry = control_multi(
            state.vehicle, self.waypoints, noise, **self.tick_constants())
        headings = poses[:, 2] + cfg.sigmaT * draws if imu else None
        return (state._replace(vehicle=vehicle, tick=state.tick + n_ticks),
                ControlTicks(ctl, poses, odometry, draws, headings))

    def observe_step(self, state: SimState, noise=None
                     ) -> tuple[SimState, Observation]:
        """A fixed-capacity observation batch at the current truth pose.
        ``noise``: standard normals [max_obs, 2], or None to draw."""
        cfg = self.config
        if not cfg.SWITCH_SENSOR_NOISE:
            noise = None
        elif noise is None:
            noise = torch.randn((self.max_obs, 2),
                                generator=state.generator,
                                device=self.device)
        obs = observe(self.landmarks, state.vehicle.pose, cfg.MAX_RANGE,
                      self.max_obs, noise=noise,
                      sigma_r=self._sigma_r[0], sigma_b=self._sigma_r[1])
        return state, obs

    def heading_measurement(self, state: SimState, u=None
                            ) -> tuple[SimState, torch.Tensor]:
        """Noisy IMU heading: truth + sigmaT * U[0, 1), the reference's
        distribution. ``u``: the uniform draw, or None to draw it."""
        if u is None:
            u = torch.rand((), generator=state.generator,
                           device=self.device)
        return state, state.vehicle.pose[2] + self.config.sigmaT * u

    def rollout_controls(self, state: SimState, n_steps: int):
        """``n_steps`` control ticks: (final state, poses [n_steps, 3],
        dones [n_steps])."""
        poses, dones = [], []
        for _ in range(n_steps):
            state, _controls = self.control_step(state)
            poses.append(state.vehicle.pose)
            dones.append(state.vehicle.done)
        return state, torch.stack(poses), torch.stack(dones)


def _default_max_obs(slam_map: SlamMap, max_range: float) -> int:
    """Capacity heuristic: the most landmarks within range of any
    waypoint, with headroom (host-side, deterministic)."""
    lm = slam_map.landmarks
    best = 0
    for wp in slam_map.waypoints:
        d = lm - wp[None, :]
        inside = int(np.sum(np.sum(d * d, axis=-1) < max_range * max_range))
        best = max(best, inside)
    return min(lm.shape[0], max(8, int(best * 1.25) + 2))
