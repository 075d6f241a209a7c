"""Worlds of gloo ranks for the port's multi-rank tests.

``run_world(job, n_ranks, **inputs)`` spawns ``n_ranks`` processes that
join one gloo process group on the CPU (``init_distributed(...,
device="cpu")``, rendezvous through a file store) and call
``job(rank, **inputs)``; it returns each rank's result. Spawned
processes import the module that defines their function, so the jobs
live here, in a module that imports neither JAX nor the JAX package:
the test files import both.

Inputs and results are numpy arrays, numbers and dicts of them. Each
rank runs torch on one thread.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                    "data")


def run_world(job, n_ranks: int, timeout: float = 300.0, **inputs) -> list:
    """``job(rank, **inputs)`` on ``n_ranks`` gloo ranks; the list of
    their results, by rank. A rank that raises fails the call; a world
    still running after ``timeout`` seconds is killed and raises."""
    tmp = tempfile.mkdtemp(prefix="gloo_world_")
    try:
        ctx = mp.start_processes(_entry, args=(job, n_ranks, tmp, inputs),
                                 nprocs=n_ranks, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{job.__name__} on {n_ranks} ranks "
                                       f"ran past {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(5)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n_ranks)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _entry(rank: int, job, n_ranks: int, tmp: str, inputs: dict) -> None:
    from slam_tpu_torch.parallel.distributed import init_distributed

    torch.set_num_threads(1)
    init_distributed(f"file://{tmp}/store", n_ranks, rank, device="cpu")
    try:
        out = job(rank, **inputs)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def port_world(world: dict):
    """The port's (config, map) for a world spec: ``ini`` / ``mat`` file
    names under data/, or ``synthetic`` arguments of synthetic_map, and
    ``config`` overrides."""
    from slam_tpu_torch.config import SlamConfig
    from slam_tpu_torch.maps import read_map_file, synthetic_map

    if "ini" in world:
        cfg = SlamConfig.from_ini(os.path.join(DATA, world["ini"]))
        cfg = cfg.replace(**world.get("config", {}))
    else:
        cfg = SlamConfig(**world.get("config", {}))
    if "mat" in world:
        slam_map = read_map_file(os.path.join(DATA, world["mat"]))
    else:
        n, n_wp, radius, seed = world["synthetic"]
        slam_map = synthetic_map(n, n_wp, radius=radius, seed=seed)
    return cfg, slam_map


def _state(arrays: dict):
    from slam_tpu_torch.models.particles import state_from_numpy
    return state_from_numpy(arrays, device="cpu")


def _numpy(state) -> dict:
    return {f: getattr(state, f).numpy().copy() for f in state._fields}


def _shard(arrays, mesh, specs):
    from slam_tpu_torch.parallel.mesh import shard_state
    return shard_state(_state(arrays), mesh, specs)


def _gather(state, mesh, specs) -> dict:
    from slam_tpu_torch.parallel.mesh import gather_state
    return _numpy(gather_state(state, mesh, specs))


def _run(est, world, n_particles: int, seed: int, n_ticks: int) -> dict:
    """A Runner run of ``est``: the pose traces, the ATE, the host
    syncs per superstep and the rank's final state."""
    from slam_tpu_torch.runtime import Runner, compute_metrics

    cfg, slam_map = port_world(world)
    result = Runner(cfg, slam_map, "FASTSLAM1", n_particles=n_particles,
                    estimator=est).run(seed=seed, n_ticks=n_ticks)
    m = compute_metrics(result)
    return dict(est_pose=result.est_pose, true_pose=result.true_pose,
                ate=m.ate_rmse, syncs=m.host_syncs_per_superstep,
                state=result.final_state)


# ---------------------------------------------------------------------------
# Jobs
# ---------------------------------------------------------------------------

def particle_world(rank: int, *, toy, rings, locals_, update, drive) -> dict:
    """The 1-D particle mesh over every rank: the collectives on ``toy``
    (global log weights and poses), ``ring_resample`` on each of
    ``rings`` (global state, weights, every rank's dither, n_min), the
    one-rank arm on ``locals_`` (each rank on a mesh of its own), one
    ``ShardedFastSlam1.update`` and one ``ShardedFastSlam2.update`` on
    the given proposal draw (``update``), and a run (``drive``)."""
    from slam_tpu_torch.parallel.filter import (
        ShardedFastSlam1,
        ShardedFastSlam2,
    )
    from slam_tpu_torch.parallel.mesh import (
        make_mesh,
        mesh_over,
        particle_state_specs,
    )
    from slam_tpu_torch.parallel.resampling import (
        global_neff,
        ring_resample,
        sharded_estimate_position,
    )

    mesh = make_mesh()
    S = dist.get_world_size()
    singles = [mesh_over([r], (1,), ("p",)) for r in range(S)]
    specs = particle_state_specs()
    group = mesh.get_group("p")
    out = {}

    logw = torch.from_numpy(np.array_split(toy["logw"], S)[rank].copy())
    xv = torch.from_numpy(np.array_split(toy["xv"], S, axis=1)[rank].copy())
    out["neff"] = float(global_neff(logw, group))
    out["pose"] = sharded_estimate_position(logw, xv, group).numpy()

    def resample(case, mesh_):
        state = _shard(case["state"], mesh_, specs)
        new, new_logw, need = ring_resample(
            state, state.logw, None, case["n_min"], True,
            mesh_.get_group("p"),
            dither=torch.from_numpy(case["dither"][
                mesh_.get_local_rank("p")].copy()))
        return dict(_gather(new._replace(logw=new_logw), mesh_, specs),
                    need=need)

    out["rings"] = [resample(case, mesh) for case in rings]
    out["locals"] = resample(locals_[rank], singles[rank])

    cfg, slam_map = port_world(update["world"])
    est = ShardedFastSlam1(cfg, slam_map.n_landmarks, mesh,
                           update["state"]["logw"].shape[0])
    state = _shard(update["state"], mesh, specs)
    z, ids, zmask = (torch.from_numpy(a) for a in update["obs"])
    state = est.update(state, torch.Generator().manual_seed(0), z, ids,
                       zmask)
    out["update"] = _gather(state, mesh, specs)

    # ShardedFastSlam2 on JAX's proposal draw, which JAX makes from one
    # key on every shard.
    from slam_tpu_torch.parallel import filter as filter_module
    filter_module.proposal_noise = (
        lambda n, gen: torch.from_numpy(update["eps"].copy()))
    est = ShardedFastSlam2(cfg, slam_map.n_landmarks, mesh,
                           update["fs2_state"]["logw"].shape[0])
    state = est.update(_shard(update["fs2_state"], mesh, specs),
                       torch.Generator().manual_seed(0), z, ids, zmask)
    out["update_fs2"] = _gather(state, mesh, specs)

    cfg, slam_map = port_world(drive["world"])
    est = ShardedFastSlam1(cfg, slam_map.n_landmarks, mesh, drive["P"])
    run = _run(est, drive["world"], drive["P"], drive["seed"],
               drive["ticks"])
    out["drive"] = {k: v for k, v in run.items() if k != "state"}
    return out


def landmark_update_world(rank: int, *, world, state, obs, P) -> dict:
    """One update of LandmarkShardedFastSlam1 on the 2x2 mesh from a
    global state, by K4's cross-shard arm (its twin here) and by the
    unfused arm; every rank returns the gathered states."""
    from slam_tpu_torch.parallel.landmarks import (
        LandmarkShardedFastSlam1,
        make_mesh_2d,
        state_specs_2d,
    )

    mesh = make_mesh_2d(2, 2)
    specs = state_specs_2d()
    cfg, slam_map = port_world(world)
    z, ids, zmask = (torch.from_numpy(a) for a in obs)
    out = {}
    for fused in (True, False):
        est = LandmarkShardedFastSlam1(cfg, slam_map.n_landmarks, mesh, P,
                                       fused=fused)
        new = est.update(_shard(state, mesh, specs),
                         torch.Generator().manual_seed(0), z, ids, zmask)
        out["fused" if fused else "unfused"] = _gather(new, mesh, specs)
    return out


def landmark_invariance_world(rank: int, *, world, P1, P2, seed,
                              ticks) -> dict:
    """On 8 ranks, as tests/test_landmark_sharding.py: FS1 on (p=4, l=2)
    and on the 1-D p=4 mesh (ranks 0-3), at P1 particles; FS1 and FS2 on
    (2, 1) (ranks 0-1) and (2, 4), at P1 and P2. Rank 0 returns the pose
    traces, the counts and the gathered landmark means."""
    from slam_tpu_torch.parallel.filter import ShardedFastSlam1
    from slam_tpu_torch.parallel.landmarks import (
        LandmarkShardedFastSlam1,
        LandmarkShardedFastSlam2,
        make_mesh_2d,
        state_specs_2d,
    )
    from slam_tpu_torch.parallel.mesh import make_mesh

    cfg, slam_map = port_world(world)
    meshes = {"p4": make_mesh(4), "p4l2": make_mesh_2d(4, 2),
              "p2l1": make_mesh_2d(2, 1), "p2l4": make_mesh_2d(2, 4)}
    runs = (("fs1 p4", ShardedFastSlam1, "p4", P1),
            ("fs1 p4l2", LandmarkShardedFastSlam1, "p4l2", P1),
            ("fs1 p2l1", LandmarkShardedFastSlam1, "p2l1", P1),
            ("fs1 p2l4", LandmarkShardedFastSlam1, "p2l4", P1),
            ("fs2 p2l1", LandmarkShardedFastSlam2, "p2l1", P2),
            ("fs2 p2l4", LandmarkShardedFastSlam2, "p2l4", P2))
    out = {}
    for name, cls, mesh_name, P in runs:
        mesh = meshes[mesh_name]
        if mesh.get_coordinate() is None:
            continue
        est = cls(cfg, slam_map.n_landmarks, mesh, P)
        run = _run(est, world, P, seed, ticks)
        specs = state_specs_2d() if mesh.ndim == 2 else None
        lm = (_gather(run["state"], mesh, specs)["lm"] if specs is not None
              else None)
        out[name] = dict(est_pose=run["est_pose"], ate=run["ate"],
                         syncs=run["syncs"], n=int(run["state"].n), lm=lm,
                         capacity=est.capacity)
    return out
