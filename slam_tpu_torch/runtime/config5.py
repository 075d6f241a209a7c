"""BASELINE config #5 composed end to end (counterpart:
slam_tpu.runtime.config5):

  sim ticks -> FastSLAM 1 (LandmarkShardedFastSlam1 on a (p, l) mesh;
               FastSlam1Deferred on one device at 2^20 particles)
            -> problem_from_run (keyframes = observe supersteps)
            -> solve_ba_sharded (landmark-sharded Schur BA over the same
               ranks, seen as a 1-D landmark mesh)

``config5_setup`` builds the scaling workload's world and config: 10k
landmarks around a loop corridor, a 30 m sensor range, so about 70
landmarks are visible per observation and the per-particle map stays
bounded. ``run_config5`` runs the pipeline and returns the filter's and
the refined trajectory's errors:

    r = run_config5(n_particles=2 ** 20, capacity=192, n_supersteps=32)

on one card, or, inside a process group (``parallel.distributed.
init_distributed``, one rank per device), on every rank with a
``mesh_shape``.

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
import torch.distributed as dist

from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.device import default_device
from slam_tpu_torch.maps import SlamMap, synthetic_map
from slam_tpu_torch.models.fastslam1 import FastSlam1, FastSlam1Deferred
from slam_tpu_torch.parallel.landmarks import (
    LandmarkShardedFastSlam1,
    make_mesh_2d,
)
from slam_tpu_torch.parallel.mesh import mesh_device, mesh_over
from slam_tpu_torch.posegraph import problem_from_run, solve_ba_sharded
from slam_tpu_torch.posegraph.distributed import LM_AXIS
from slam_tpu_torch.runtime.loop import Runner
from slam_tpu_torch.runtime.metrics import compute_metrics
from slam_tpu_torch.spans import span


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
                ranks=None,
                device=None) -> Config5Result | None:
    """Run the composed pipeline.

    Inside a process group every rank calls this. ``mesh_shape`` =
    (n_p, n_l) takes the first n_p n_l of ``ranks`` (of the group's ranks
    by default); the filter is the JAX package's choice,
    ``FastSlam1Deferred`` on a (1, 1) mesh at a particle count it
    ``fits``, else ``LandmarkShardedFastSlam1`` on
    ``make_mesh_2d(n_p, n_l)``, and BA runs on the same ranks as a 1-D
    landmark mesh. The run takes place on the mesh's device (``device``,
    if named, must be that one); each rank of the mesh returns the same
    result (the walls are the slowest rank's), a rank outside it None.

    Outside a process group the run is on one device, ``device`` (none
    named: the card): ``FastSlam1Deferred`` at a particle count it
    ``fits``, else ``FastSlam1`` (the one-device form of the sharded
    filter), and ``solve_ba_sharded`` on one shard; a ``mesh_shape``
    other than (1, 1) raises ``ValueError``. ``ba_seconds`` ends with a
    device sync. ``rng_impl`` (the TPU's hardware generator) is not
    ported and raises."""
    if rng_impl is not None:
        raise NotImplementedError(
            f"rng_impl={rng_impl!r}: the TPU's generator is left out of the "
            "port (ROADMAP.md, North star); the filter draws from torch's "
            "generators")
    n_p, n_l = mesh_shape
    deferred = (n_p, n_l) == (1, 1) and FastSlam1Deferred.fits(n_particles)
    cfg, slam_map = config5_setup(n_landmarks, capacity=capacity)
    if dist.is_initialized():
        ranks = list(range(dist.get_world_size()) if ranks is None
                     else ranks)[:n_p * n_l]
        mesh2d = make_mesh_2d(n_p, n_l, ranks)
        ba_mesh = mesh_over(ranks, (n_p * n_l,), (LM_AXIS,))
        if mesh2d.get_coordinate() is None:
            return None
        here = mesh_device(mesh2d)
        named = None if device is None else torch.device(device)
        if named is not None and (named.type != here.type or named.index
                                  not in (None, here.index)):
            raise ValueError(f"device={device}: inside a process group the "
                             f"run is on the mesh's {here}")
        if deferred:
            est = FastSlam1Deferred(cfg, slam_map.n_landmarks, device=here)
        else:
            est = LandmarkShardedFastSlam1(cfg, slam_map.n_landmarks,
                                           mesh2d, n_particles)
    elif (n_p, n_l) != (1, 1):
        raise ValueError(
            f"mesh_shape={tuple(mesh_shape)} needs a process group of "
            f"{n_p * n_l} ranks: call parallel.distributed.init_distributed "
            "on every rank first")
    else:
        ba_mesh = None
        filt = FastSlam1Deferred if deferred else FastSlam1
        est = filt(cfg, slam_map.n_landmarks, device=default_device(device))
    device = est.device
    runner = Runner(cfg, slam_map, "FASTSLAM1", estimator=est,
                    n_particles=n_particles)
    result = runner.run(seed=seed,
                        n_ticks=n_supersteps * cfg.steps_per_observe)

    with span("config5.problem"):
        prob = problem_from_run(result, cfg, slam_map, device=device)
    t0 = time.perf_counter()
    with span("config5.ba"):
        poses_ref, _, info = solve_ba_sharded(prob, ba_mesh, iters=ba_iters,
                                              return_info=True)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    ba_seconds = time.perf_counter() - t0
    walls = (result.wall_seconds, ba_seconds, result.compile_seconds)
    if ba_mesh is not None:
        walls = _slowest(walls, ba_mesh, device)
    result = result._replace(wall_seconds=walls[0],
                             compile_seconds=walls[2])
    m = compute_metrics(result)

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
        ba_seconds=walls[1],
        ba_iters=int(info["n_iters"]),
        filter_compile_seconds=walls[2],
    )


def _slowest(walls, mesh, device) -> list:
    """Each of ``walls`` (host seconds) as its largest over the ranks of
    the 1-D ``mesh``, so that every rank reports the same."""
    t = torch.tensor(walls, dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(0))
    return t.tolist()
