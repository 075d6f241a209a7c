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

RING40 = dict(ini="ring40.ini", mat="ring40.mat")


def _singles(axis: str) -> list:
    """A mesh of each rank alone, made on every rank in the same order
    (each mesh's groups are made by all ranks); this rank's is at its
    index."""
    from slam_tpu_torch.parallel.mesh import mesh_over
    return [mesh_over([r], (1,), (axis,))
            for r in range(dist.get_world_size())]


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


def _drive_ekf(est, stream, n_defer: int, extra_predicts: int) -> tuple:
    """Feed one input stream (test_torch_ekf.input_stream's) to an EKF
    whose state has ``n_defer`` deferred columns; then
    ``extra_predicts`` predicts more, so that heading terms are pending.
    (state after the stream, state after the predicts, [pose] per
    superstep)."""
    from slam_tpu_torch.parallel.ekf import sharded_ekf_init

    def t(a):
        return torch.as_tensor(a)

    st = sharded_ekf_init(est.capacity, est.n_map, n_defer=n_defer,
                          device="cpu", rows=est.shard.rows)
    poses = []
    for ticks, z, ids, mask in stream:
        for v, g, phi in ticks:
            st = est.predict(st, None, t(v), t(g), t(phi))
        st = est.update(st, None, t(z), t(ids), t(mask))
        poses.append(est.pose(st).numpy())
    end = st._replace(x=st.x.clone(), P00=st.P00.clone(),
                      P0m=st.P0m.clone(), Pmm=st.Pmm.clone(),
                      hk=st.hk.clone())
    for v, g, phi in stream[-1][0][:extra_predicts]:
        st = est.predict(st, None, t(v), t(g), t(phi))
    return end, st, np.stack(poses)


def _ekf_numpy(state, mesh) -> dict:
    """The joint covariance (rows gathered, deferred terms folded), x,
    n, the table and hk_n."""
    from slam_tpu_torch.parallel.ekf import dense_covariance
    return dict(P=dense_covariance(state, mesh).numpy(), x=state.x.numpy(),
                n=int(state.n), da_table=state.da_table.numpy(),
                hk_n=state.hk_n)


def ekf_world(rank: int, *, drives, padding, single) -> dict:
    """ShardedEkfSlam on ``make_mesh(S, axis="l")`` over every rank: each
    of ``drives`` (config overrides of ring40, its input stream,
    n_defer, the predicts after it) fed to the estimator; ``padding``
    (a synthetic world whose capacity is no multiple of S) through
    Runner; and ``single``, a drive on a mesh of this rank alone and on
    no mesh, whose states must be equal bit for bit."""
    from slam_tpu_torch.parallel.ekf import (
        ShardedEkfSlam,
        sharded_state_to_numpy,
    )
    from slam_tpu_torch.parallel.mesh import make_mesh
    from slam_tpu_torch.runtime import Runner

    mesh = make_mesh(axis="l")
    out = {"drives": []}
    for case in drives:
        cfg, slam_map = port_world(dict(RING40, config=case["config"]))
        est = ShardedEkfSlam(cfg, slam_map.n_landmarks, mesh)
        end, pending, poses = _drive_ekf(est, case["stream"],
                                         case["n_defer"], case["extra"])
        out["drives"].append(dict(end=_ekf_numpy(end, mesh),
                                  pending=_ekf_numpy(pending, mesh),
                                  poses=poses, capacity=est.capacity,
                                  rows=est.shard.rows))

    cfg, slam_map = port_world(padding["world"])
    est = ShardedEkfSlam(cfg, slam_map.n_landmarks, mesh)
    result = Runner(cfg, slam_map, "EKF1", estimator=est).run(
        seed=padding["seed"], n_ticks=padding["ticks"])
    out["padding"] = dict(capacity=est.capacity, est_pose=result.est_pose,
                          host_syncs=result.host_syncs,
                          **_ekf_numpy(result.final_state, mesh))

    cfg, slam_map = port_world(dict(RING40, config=single["config"]))
    states = []
    for m in (_singles("l")[rank], None):
        est = ShardedEkfSlam(cfg, slam_map.n_landmarks, m, device="cpu")
        _, st, poses = _drive_ekf(est, single["stream"], single["n_defer"],
                                  single["extra"])
        states.append(dict(sharded_state_to_numpy(st), poses=poses))
    out["single"] = states
    return out


def ba_world(rank: int, *, cases) -> dict:
    """``solve_ba_sharded`` of each case's problem (arrays, iters,
    damping) on ``make_mesh(S, axis="l")`` over every rank, and on a
    mesh of this rank alone and on no mesh, whose results must be equal
    bit for bit."""
    from slam_tpu_torch.parallel.mesh import make_mesh
    from slam_tpu_torch.posegraph.ba import BAProblem
    from slam_tpu_torch.posegraph.distributed import solve_ba_sharded

    mesh = make_mesh(axis="l")
    single = _singles("l")[rank]
    out = []
    for case in cases:
        prob = BAProblem.from_numpy("cpu", **case["arrays"])
        runs = {}
        for name, m in (("mesh", mesh), ("single", single), ("none", None)):
            p, l, info = solve_ba_sharded(prob, m, iters=case["iters"],
                                          damping=case["damping"],
                                          return_info=True)
            runs[name] = dict(poses=p.numpy(), landmarks=l.numpy(), **info)
        out.append(runs)
    return out


def config5_world(rank: int, *, run, choices, ba) -> dict:
    """``run_config5`` on the (2, 2) mesh of the four ranks (``run``: its
    keyword arguments); the filter it builds at (1, 1) inside the group
    at each of ``choices``' particle counts (rank 0's mesh; the other
    ranks get None); and the composed problem of a
    LandmarkShardedFastSlam1 run on (2, 2) solved by ``solve_ba_sharded``
    over the four ranks and by ``solve_ba`` on each."""
    from slam_tpu_torch.parallel.landmarks import (
        LandmarkShardedFastSlam1,
        make_mesh_2d,
    )
    from slam_tpu_torch.parallel.mesh import make_mesh
    from slam_tpu_torch.posegraph import problem_from_run
    from slam_tpu_torch.posegraph.ba import solve_ba
    from slam_tpu_torch.posegraph.distributed import solve_ba_sharded
    from slam_tpu_torch.runtime import Runner
    from slam_tpu_torch.runtime import config5

    out = {"run": config5.run_config5(mesh_shape=(2, 2), **run)._asdict()}

    built = []
    for name in ("FastSlam1Deferred", "LandmarkShardedFastSlam1"):
        cls = getattr(config5, name)

        class Spy(cls):
            def __init__(self, *args, _name=name, **kw):
                built.append(_name)
                super().__init__(*args, **kw)
        setattr(config5, name, Spy)
    out["choices"] = []
    for P in choices:
        built.clear()
        r = config5.run_config5(n_particles=P, mesh_shape=(1, 1),
                                n_supersteps=2, ba_iters=1)
        out["choices"].append(dict(built=list(built),
                                   result=None if r is None else
                                   r._asdict()))

    cfg, slam_map = config5.config5_setup(10_000, capacity=ba["capacity"])
    est = LandmarkShardedFastSlam1(cfg, slam_map.n_landmarks,
                                   make_mesh_2d(2, 2), ba["P"])
    result = Runner(cfg, slam_map, "FASTSLAM1", estimator=est,
                    n_particles=ba["P"]).run(
        seed=3, n_ticks=ba["supersteps"] * cfg.steps_per_observe)
    prob = problem_from_run(result, cfg, slam_map, device="cpu")
    p_sh, l_sh = solve_ba_sharded(prob, make_mesh(axis="l"),
                                  iters=ba["iters"], damping=ba["damping"])
    p_1, l_1 = solve_ba(prob, iters=ba["iters"], damping=ba["damping"])
    out["ba"] = dict(L=prob.L, landmarks0_shape=tuple(prob.landmarks0.shape),
                     poses=p_sh.numpy(), landmarks=l_sh.numpy(),
                     poses_1=p_1.numpy(), landmarks_1=l_1.numpy())
    return out


def checkpoint_world(rank: int, *, tmp, fs1, ekf) -> dict:
    """On a 1-D mesh of every rank, ShardedFastSlam1 (``fs1``: world, P,
    seed, supersteps, chunk, cut) and ShardedEkfSlam (``ekf``): the run
    unbroken through ``run_checkpointed``, then cut at ``cut`` and
    resumed; the gathered final states, the traces, and the files each
    checkpoint directory holds. Then a resume of the cut FS1 checkpoint
    on a mesh of this rank alone, and on no mesh: their errors."""
    from slam_tpu_torch.models import FastSlam1
    from slam_tpu_torch.parallel.ekf import ShardedEkfSlam
    from slam_tpu_torch.parallel.filter import ShardedFastSlam1
    from slam_tpu_torch.parallel.mesh import make_mesh
    from slam_tpu_torch.runtime import Runner

    def make(case, mesh):
        cfg, slam_map = port_world(case["world"])
        if case is fs1:
            est = ShardedFastSlam1(cfg, slam_map.n_landmarks, mesh,
                                   case["P"])
            return Runner(cfg, slam_map, "FASTSLAM1", n_particles=case["P"],
                          estimator=est)
        est = ShardedEkfSlam(cfg, slam_map.n_landmarks, mesh)
        return Runner(cfg, slam_map, "EKF1", estimator=est)

    def traces(result):
        return {k: getattr(result, k) for k in (
            "true_pose", "est_pose", "active", "obs_z", "obs_ids")}

    out = {}
    for name, case in (("fs1", fs1), ("ekf", ekf)):
        mesh = make_mesh(axis="p" if case is fs1 else "l")
        period = port_world(case["world"])[0].steps_per_observe
        runs = {}
        for label, cut in (("unbroken", None), ("resumed", case["cut"])):
            path = os.path.join(tmp, name, label, "run")
            kw = dict(seed=case["seed"], every=case["chunk"],
                      ckpt_path=path)
            if cut is not None:
                make(case, mesh).run_checkpointed(n_ticks=cut * period, **kw)
            runner = make(case, mesh)
            result = runner.run_checkpointed(
                n_ticks=case["supersteps"] * period, resume=True, **kw)
            runs[label] = dict(
                traces=traces(result),
                state=_gather(result.final_state, mesh,
                              runner.est.state_specs())
                if case is fs1 else _ekf_numpy(result.final_state, mesh),
                files=sorted(os.listdir(os.path.dirname(path))))
        out[name] = runs

    errors = {}
    path = os.path.join(tmp, "fs1", "resumed", "run")
    cfg, slam_map = port_world(fs1["world"])
    for label, est in (
            ("single", ShardedFastSlam1(cfg, slam_map.n_landmarks,
                                        _singles("p")[rank], fs1["P"])),
            ("none", FastSlam1(cfg, slam_map.n_landmarks, device="cpu"))):
        try:
            Runner(cfg, slam_map, "FASTSLAM1", n_particles=fs1["P"],
                   estimator=est).run_checkpointed(
                seed=fs1["seed"], n_ticks=(fs1["supersteps"] + 20)
                * cfg.steps_per_observe, every=fs1["chunk"],
                ckpt_path=path, resume=True)
            errors[label] = None
        except ValueError as e:
            errors[label] = str(e)
    out["errors"] = errors
    return out
