"""The run loop: a host loop of supersteps (counterpart:
slam_tpu.runtime.loop, whose superstep is one ``lax.scan`` body).

A superstep is ``steps_per_observe`` control ticks — truth step, noisy
controls, dead-reckoning odometry, all in one simulator call
(``Simulator.control_ticks``: one kernel launch on the card) — then the
estimator's predict of each tick, one observation and the estimator
update. The heading each predict gets is the noisy IMU heading for an
EKF (``IS_EKF``), the true heading for a particle filter. A particle
filter with ``predict_multi``
(``FastSlam1Deferred``, and ``FastSlam2`` with the heading unknown) at
a particle count that is a multiple of 1024 predicts all the ticks of a
superstep in one call after them, as the JAX runner's
``_superstep_multi`` does; an EKF never does. Everything stays on the
run's device; the per-superstep traces are written into preallocated
device buffers and copied to the host once, at the end of the run
(``run``) or of each chunk (``run_checkpointed``, which saves a
checkpoint there). The only host syncs inside the loop are the particle
filters' gates (``rbpf.host_bool``), counted in
``RunResult.host_syncs``; an EKF has none. ``run_streaming``
(``runtime.stream``) adds one telemetry read per superstep.
"""

from __future__ import annotations

import os
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.device import default_device
from slam_tpu_torch.maps import SlamMap
from slam_tpu_torch.models import make_estimator, rbpf
from slam_tpu_torch.sim.simulator import Simulator
from slam_tpu_torch.spans import span


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


# predict_multi when P is a multiple of this, the JAX runner's rule. It stays
# here: ``_superstep_for``, which the benchmark calls, reads it, while the
# benchmark's ``Recorder`` offers ``predict_multi`` by the estimator alone.
MULTI_ALIGN = 1024


class Runner:
    """Runs one config, map and method on one device: the card, unless
    ``device`` names another (``default_device``).

    ``estimator``: a prebuilt estimator with the same interface (e.g.
    ``FastSlam1Deferred``) in place of the method's default; the run
    then takes place on its device unless ``device`` says otherwise."""

    def __init__(self, config: SlamConfig, slam_map: SlamMap,
                 method: str = "EKF1", n_particles: int | None = None,
                 estimator=None, device=None):
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

    def _superstep(self, sim_state, est_state, gen):
        """The control ticks of a superstep, then each tick's predict:
        (sim state, estimator state, odometry)."""
        ekf = getattr(self.est, "IS_EKF", False)
        with span("sim.control"):
            sim_state, ticks = self.sim.control_ticks(
                sim_state, self.config.steps_per_observe, imu=ekf)
            # An EKF observes the noisy IMU heading, FastSLAM the true
            # one.
            phis = (ticks.imu_headings if ekf
                    else ticks.poses[:, 2]).unbind(0)
        for ctl, phi in zip(ticks.controls, phis):
            with span("filter.predict"):
                est_state = self.est.predict(est_state, gen, ctl[0], ctl[1],
                                             phi)
        return sim_state, est_state, ticks.odometry

    def _superstep_multi(self, sim_state, est_state, gen):
        """The control ticks of a superstep, then one ``predict_multi``
        call that advances the particles through every tick on their
        [T, 2] noisy controls."""
        with span("sim.control"):
            sim_state, ticks = self.sim.control_ticks(
                sim_state, self.config.steps_per_observe)
        with span("filter.predict"):
            est_state = self.est.predict_multi(est_state, gen,
                                               ticks.controls)
        return sim_state, est_state, ticks.odometry

    def _init(self, seed: int):
        """Build the kernels (on the card), then the run's start: (sim
        state, estimator state, run generator, build seconds)."""
        with span("run.init"):
            t0 = time.perf_counter()
            if self.device.type == "cuda":
                from slam_tpu_torch.ops.kernels import build
                build.load_library()
            build_s = time.perf_counter() - t0
            sim_state = self.sim.init(
                seed=seed or self.config.SWITCH_SEED_RANDOM)
            est_state = self.est.init(self.n_particles)
            return (sim_state, est_state, self.sim.make_generator(seed + 1),
                    build_s)

    def _superstep_for(self, est_state):
        """The superstep the estimator takes: ``_superstep_multi`` for a
        particle filter with ``predict_multi`` at a P that is a multiple
        of MULTI_ALIGN, else ``_superstep``."""
        P = getattr(getattr(est_state, "ps", est_state), "n_particles", 0)
        if (hasattr(self.est, "predict_multi")
                and not getattr(self.est, "IS_EKF", False)
                and P % MULTI_ALIGN == 0):
            return self._superstep_multi
        return self._superstep

    def _step(self, superstep, sim_state, est_state, gen, traces=None,
              i: int = 0):
        """One superstep, observation and update: (sim state, estimator
        state, the superstep's trace row as a tuple of device tensors in
        RunResult's order). With ``traces``, the row is also written at
        ``i`` of those nine buffers."""
        with span("superstep"):
            sim_state, est_state, dr = superstep(sim_state, est_state, gen)
            with span("sim.observe"):
                sim_state, obs = self.sim.observe_step(sim_state)
            with span("filter.update"):
                est_state = self.est.update(est_state, gen, obs.z, obs.ids,
                                            obs.mask)
            with span("run.record"):
                out = (sim_state.vehicle.pose, self.est.pose(est_state),
                       ~sim_state.vehicle.done, obs.count,
                       torch.sum(torch.where(obs.mask, obs.z[:, 0], 0.0)),
                       obs.z, obs.mask, obs.ids, dr)
                if traces is not None:
                    for buf, value in zip(traces, out):
                        buf[i] = value
        return sim_state, est_state, out

    def _chunk(self, superstep, sim_state, est_state, gen, n: int):
        """``n`` supersteps, their traces written into preallocated device
        buffers: (sim state, estimator state, the nine trace buffers)."""
        K, dev = self.sim.max_obs, self.device
        f32 = dict(dtype=torch.float32, device=dev)
        traces = (torch.empty((n, 3), **f32), torch.empty((n, 3), **f32),
                  torch.empty(n, dtype=torch.bool, device=dev),
                  torch.empty(n, dtype=torch.int32, device=dev),
                  torch.empty(n, **f32), torch.empty((n, K, 2), **f32),
                  torch.empty((n, K), dtype=torch.bool, device=dev),
                  torch.empty((n, K), dtype=torch.int32, device=dev),
                  torch.empty((n, 3), **f32))
        for i in range(n):
            sim_state, est_state, _ = self._step(superstep, sim_state,
                                                 est_state, gen, traces, i)
        return sim_state, est_state, traces

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, seed: int = 0, n_ticks: int | None = None) -> RunResult:
        period = self.config.steps_per_observe
        if n_ticks is None:
            n_ticks = self.estimate_run_ticks()
        T = n_ticks // period
        sim_state, est_state, gen, build_s = self._init(seed)
        superstep = self._superstep_for(est_state)
        syncs0 = rbpf.host_bool.count
        self._sync()
        t0 = time.perf_counter()
        sim_state, est_state, traces = self._chunk(superstep, sim_state,
                                                   est_state, gen, T)
        self._sync()
        wall = time.perf_counter() - t0
        return run_result(to_host(traces), est_state, T * period, wall,
                          build_s, rbpf.host_bool.count - syncs0)

    def run_checkpointed(self, seed: int = 0, n_ticks: int | None = None,
                         every: int = 50, ckpt_path: str = "ckpt/run",
                         resume: bool = False) -> RunResult:
        """The run in chunks of ``every`` supersteps, with a checkpoint
        (``runtime.checkpoint``) after each; with ``resume``, from the
        checkpoint at ``ckpt_path`` if there is one. A resumed run equals
        the unbroken run bit for bit. A sharded estimator (one with a
        ``mesh``; every rank of it runs this) writes one checkpoint for
        all ranks and resumes each from it (``runtime.checkpoint``).

        The JAX package's semantics: only whole chunks run, so when
        ``every`` does not divide the supersteps the last chunk runs past
        them, and the final state and the saved ``superstep`` are after
        that overshoot, while the traces stop at the run's supersteps; a
        resumed run returns the traces from its start on. Resuming from a
        checkpoint that has already finished raises ``ValueError`` (the
        JAX package raises one too, from an empty ``np.concatenate``).

        ``wall_seconds`` covers every chunk with its trace copy and
        save; ``host_syncs`` counts the gates, as in ``run`` (a run of one
        chunk reads the same as ``run``)."""
        from slam_tpu_torch.runtime import checkpoint as ckpt

        period = self.config.steps_per_observe
        if n_ticks is None:
            n_ticks = self.estimate_run_ticks()
        n_supersteps = n_ticks // period
        sim_state, est_state, gen, build_s = self._init(seed)
        sharded = getattr(self.est, "mesh", None) is not None
        meta = {"method": self.method, "seed": seed}
        start = 0
        if resume and os.path.exists(ckpt_path + ".json"):
            if sharded:
                sim_state, est_state, gen, start = (
                    ckpt.load_sharded_checkpoint(ckpt_path, sim_state,
                                                 self.est, est_state))
            else:
                sim_state, est_state, gen, start = ckpt.load_checkpoint(
                    ckpt_path, sim_state, est_state, self.device)
            if start >= n_supersteps:
                raise ValueError(
                    f"checkpoint {ckpt_path} has already finished: it is "
                    f"at superstep {start} of {n_supersteps}")
        superstep = self._superstep_for(est_state)
        syncs0 = rbpf.host_bool.count
        self._sync()
        t0 = time.perf_counter()
        chunks, done = [], start
        while done < n_supersteps:
            sim_state, est_state, traces = self._chunk(
                superstep, sim_state, est_state, gen, every)
            chunks.append(to_host(traces))
            done += every
            with span("ckpt.save"):
                if sharded:
                    ckpt.save_sharded_checkpoint(ckpt_path, sim_state,
                                                 self.est, est_state, gen,
                                                 done, meta)
                else:
                    ckpt.save_checkpoint(ckpt_path, sim_state, est_state,
                                         gen, done, meta)
        wall = time.perf_counter() - t0
        n_keep = n_supersteps - start
        traces = [np.concatenate([c[i] for c in chunks])[:n_keep]
                  for i in range(len(chunks[0]))]
        return run_result(traces, est_state, n_keep * period, wall, build_s,
                          rbpf.host_bool.count - syncs0)

    def run_streaming(self, seed: int = 0, n_ticks: int | None = None,
                      plot=None, sim_name: str = "simulation"
                      ) -> RunResult:
        """One superstep at a time with live telemetry to a slam-gui
        (``runtime.stream``); ``plot``: a ``telemetry.NetworkPlot`` or
        ``native.NativeNetworkPlot``, or None for none."""
        from slam_tpu_torch.runtime.stream import stream_run
        return stream_run(self, seed=seed, n_ticks=n_ticks, plot=plot,
                          sim_name=sim_name)


def to_host(tensors) -> list:
    with span("run.to_host"):
        return [t.cpu().numpy() for t in tensors]


def run_result(traces, final_state, n_ticks: int, wall: float,
               build_s: float, host_syncs: int) -> RunResult:
    """A RunResult from the nine traces (numpy, RunResult's order)."""
    (true_pose, est_pose, active, obs_count, range_sum, obs_z, obs_mask,
     obs_ids, odom) = traces
    return RunResult(
        true_pose=true_pose, est_pose=est_pose, active=active,
        obs_count=obs_count, obs_range_sum=range_sum, obs_z=obs_z,
        obs_mask=obs_mask, obs_ids=obs_ids, odom=odom,
        final_state=final_state, n_ticks=n_ticks, wall_seconds=wall,
        compile_seconds=build_s, host_syncs=host_syncs)
