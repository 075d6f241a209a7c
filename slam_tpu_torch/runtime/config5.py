"""BASELINE config #5 composed end to end on one card (counterpart:
slam_tpu.runtime.config5):

  sim ticks -> FastSLAM 1 (FastSlam1Deferred at 2^20 particles)
            -> problem_from_run (keyframes = observe supersteps)
            -> solve_ba_sharded (landmark-sharded Schur BA, one shard)

``config5_setup`` builds the scaling workload's world and config: 10k
landmarks around a loop corridor, a 30 m sensor range, so about 70
landmarks are visible per observation and the per-particle map stays
bounded. ``run_config5`` runs the pipeline and returns the filter's and
the refined trajectory's errors:

    r = run_config5(n_particles=2 ** 20, capacity=192, n_supersteps=32)

The filter's landmark state is 5 float32 planes per (particle, slot):
4 GB at 2^20 particles and capacity 192, 6.6 GB at 32,768 particles and
the full capacity of 10k, twice that while the deferred resample
gathers into fresh buffers.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.device import default_device
from slam_tpu_torch.maps import SlamMap, synthetic_map
from slam_tpu_torch.models.fastslam1 import (
    DEFERRED_ALIGN,
    FastSlam1,
    FastSlam1Deferred,
)
from slam_tpu_torch.posegraph import problem_from_run, solve_ba_sharded
from slam_tpu_torch.runtime.loop import Runner
from slam_tpu_torch.runtime.metrics import compute_metrics


class Config5Result(NamedTuple):
    steps_per_second: float       # filter control ticks / s
    particle_steps_per_second: float
    ate_filter: float             # keyframe ATE RMSE, filter estimate
    ate_refined: float            # keyframe ATE RMSE after BA
    n_keyframes: int
    n_landmarks_map: int          # landmarks in the world map
    n_landmarks_observed: int     # landmarks instantiated by the run
    ba_seconds: float
    ba_iters: int
    filter_compile_seconds: float


def config5_setup(n_landmarks: int = 10_000, capacity: int = 256,
                  max_obs: int = 96, seed: int = 5):
    """(config, map) of the scaling workload, as the JAX package builds
    them: the synthetic loop shifted so that waypoint 0, where the
    vehicle starts, is the origin and landmarks are in range from tick
    0."""
    slam_map = synthetic_map(n_landmarks, n_waypoints=17, radius=200.0,
                             seed=seed)
    shift = slam_map.waypoints[0].copy()
    slam_map = SlamMap(landmarks=slam_map.landmarks - shift,
                       waypoints=slam_map.waypoints - shift)
    cfg = SlamConfig(V=3.0, WHEELBASE=4.0, MAX_RANGE=30.0,
                     SWITCH_HEADING_KNOWN=1,
                     max_landmarks=capacity,
                     max_observations=max_obs)
    return cfg, slam_map


def run_config5(n_particles: int = 1_000_000,
                mesh_shape: tuple[int, int] = (1, 1),
                n_landmarks: int = 10_000,
                capacity: int = 192,
                n_supersteps: int = 32,
                ba_iters: int = 12,
                seed: int = 3,
                rng_impl: str | None = None,
                device=None) -> Config5Result:
    """Run the composed pipeline on ``device`` (none named: the card).

    The filter is ``FastSlam1Deferred`` when the particle count is a
    multiple of 512 (the JAX package's one-chip choice), else
    ``FastSlam1``, the one-card form of its landmark-sharded filter on a
    (1, 1) mesh. The BA stage always goes through ``solve_ba_sharded``,
    as in JAX; ``ba_seconds`` ends with a device sync. ``mesh_shape``
    other than (1, 1) and ``rng_impl`` (the TPU's hardware generator)
    are not ported and raise."""
    if tuple(mesh_shape) != (1, 1):
        raise NotImplementedError(
            f"mesh_shape={tuple(mesh_shape)}: the port runs config #5 on "
            "one card; the multi-device layer is ROADMAP.md Queue 1, item "
            "5")
    if rng_impl is not None:
        raise NotImplementedError(
            f"rng_impl={rng_impl!r}: the TPU's generator is left out of the "
            "port (ROADMAP.md, North star); the filter draws from torch's "
            "generators")
    device = default_device(device)
    cfg, slam_map = config5_setup(n_landmarks, capacity=capacity)
    filt = (FastSlam1Deferred if n_particles % DEFERRED_ALIGN == 0
            else FastSlam1)
    est = filt(cfg, slam_map.n_landmarks, device=device)
    runner = Runner(cfg, slam_map, "FASTSLAM1", estimator=est,
                    n_particles=n_particles)
    result = runner.run(seed=seed,
                        n_ticks=n_supersteps * cfg.steps_per_observe)
    m = compute_metrics(result)

    prob = problem_from_run(result, cfg, slam_map, device=device)
    t0 = time.perf_counter()
    poses_ref, _, info = solve_ba_sharded(prob, iters=ba_iters,
                                          return_info=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ba_seconds = time.perf_counter() - t0

    act = result.active
    d_ref = poses_ref[:, :2].cpu().numpy() - result.true_pose[act, :2]
    n_seen = len(np.unique(result.obs_ids[result.obs_mask]))
    return Config5Result(
        steps_per_second=m.steps_per_second,
        particle_steps_per_second=m.steps_per_second * n_particles,
        ate_filter=m.ate_rmse,
        ate_refined=float(np.sqrt(np.mean(np.sum(d_ref ** 2, axis=1)))),
        n_keyframes=int(act.sum()),
        n_landmarks_map=slam_map.n_landmarks,
        n_landmarks_observed=n_seen,
        ba_seconds=ba_seconds,
        ba_iters=int(info["n_iters"]),
        filter_compile_seconds=result.compile_seconds,
    )
