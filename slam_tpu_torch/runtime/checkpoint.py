"""Checkpoint and resume of a run (counterpart:
slam_tpu.runtime.checkpoint).

A checkpoint is the JAX package's layout: ``<path>.npz``
(``np.savez_compressed``) holding ``key``, ``sim_i`` and ``est_i``, and
``<path>.json`` holding ``superstep``, ``n_sim_leaves``, ``n_est_leaves``
and ``meta``. The leaves follow the JAX package's order:

- ``sim_0`` .. ``sim_6``: the vehicle's ``pose``, ``steer``,
  ``waypoint``, ``loops`` and ``done``, then the simulator's noise
  stream, then ``tick``;
- ``est_i``: the estimator state's tensors, its fields depth first
  (``ParticleState``: logw, xv, Pv, lm, lm_P, n, da_table; ``EKFState``:
  x, P, n, da_table; ``DeferredState``: ps, then S);
- ``key``: the run's random stream.

``load_jax_checkpoint`` reads a checkpoint that the JAX package wrote,
and ``save_jax_checkpoint`` writes one that it resumes.

A stream is a ``torch.Generator``, saved as ``get_state()``. Host values
in the estimator state (``DeferredState.pending``,
``ShardedEKFState.hk_n``) go into the manifest as ``est_host``, and the
device type that wrote the checkpoint as ``device_type``: a CUDA
generator's state (Philox seed and offset, 16 bytes) means nothing to a
CPU generator (5,056 bytes of Mersenne twister) and the other way round,
so a checkpoint loads only on the device type that wrote it.

Restoring a checkpoint reproduces the unbroken run bit for bit: every
random draw comes from the two saved streams, and the kernels are
deterministic.

A sharded run (an estimator with a ``mesh``) writes one checkpoint for
all its ranks (``save_sharded_checkpoint``): the global state in the
one-device layout, which every rank gathers and the mesh's first rank
writes, with each rank's own stream (``parallel.filter.RankStream``)
as ``streams`` [*mesh shape, state bytes] and the mesh's shape in the
manifest as ``mesh_shape``. On a resume every rank reads the file and
cuts its block (``load_sharded_checkpoint``). A checkpoint loads only
on a mesh of the shape that wrote it (no mesh: none).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from slam_tpu_torch.device import default_device
from slam_tpu_torch.models.ekf import EKFState, ekf_state_from_numpy
from slam_tpu_torch.models.particles import (
    DeferredState,
    ParticleState,
    deferred_state_from_numpy,
    state_from_numpy,
)
from slam_tpu_torch.parallel.mesh import (
    gather_state,
    global_shapes,
    mesh_all_gather,
    shard_state,
)
from slam_tpu_torch.sim.simulator import SimState
from slam_tpu_torch.sim.vehicle import VehicleState

N_SIM_LEAVES = len(VehicleState._fields) + 2


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _sim_leaves(sim_state: SimState) -> list:
    return [*(_host(t) for t in sim_state.vehicle),
            _host(sim_state.generator.get_state()),
            np.asarray(sim_state.tick, np.int32)]


def _est_leaves(tree, tensors: list, host: list) -> None:
    """The tensors of a state, its fields depth first, into ``tensors``;
    its host values (bools and ints) into ``host``."""
    for v in tree:
        if isinstance(v, tuple):
            _est_leaves(v, tensors, host)
        elif isinstance(v, torch.Tensor):
            tensors.append(v)
        else:
            host.append(v)


def _est_rebuild(template, arrays, host, device):
    """``template`` with its tensors and host values replaced, in the
    order ``_est_leaves`` takes them, from the iterators given."""
    out = []
    for v in template:
        if isinstance(v, tuple):
            out.append(_est_rebuild(v, arrays, host, device))
        elif isinstance(v, torch.Tensor):
            a = next(arrays)
            if a.shape != tuple(v.shape):
                raise ValueError(f"checkpoint leaf of shape {a.shape} where "
                                 f"the run has {tuple(v.shape)}")
            out.append(torch.from_numpy(a).to(device))
        else:
            out.append(type(v)(next(host)))
    return type(template)(*out)


def _generator(state: np.ndarray, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.set_state(torch.from_numpy(np.ascontiguousarray(state)))
    return gen


def _shape_name(shape) -> str:
    return "no mesh" if shape is None else f"a {tuple(shape)} mesh"


def save_checkpoint(path: str, sim_state: SimState, est_state, gen,
                    superstep: int, meta: dict | None = None,
                    streams: np.ndarray | None = None,
                    mesh_shape: tuple | None = None) -> str:
    """Write ``<path>.npz`` and ``<path>.json``: the simulator state,
    the estimator state, the run generator ``gen`` and the superstep
    reached; a sharded run's rank ``streams`` and ``mesh_shape`` (see
    ``save_sharded_checkpoint``). Returns the npz path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    est, host = [], []
    _est_leaves(est_state, est, host)
    sim = _sim_leaves(sim_state)
    arrays = {"key": _host(gen.get_state())}
    arrays.update({f"sim_{i}": a for i, a in enumerate(sim)})
    arrays.update({f"est_{i}": _host(t) for i, t in enumerate(est)})
    if streams is not None:
        arrays["streams"] = streams
    np.savez_compressed(path + ".npz", **arrays)
    manifest = {
        "superstep": int(superstep),
        "n_sim_leaves": len(sim),
        "n_est_leaves": len(est),
        "meta": meta or {},
        "est_host": host,
        "device_type": gen.device.type,
    }
    if mesh_shape is not None:
        manifest["mesh_shape"] = list(mesh_shape)
    with open(path + ".json", "w") as fh:
        json.dump(manifest, fh)
    return path + ".npz"


def load_checkpoint(path: str, sim_template: SimState, est_template,
                    device=None, mesh_shape: tuple | None = None):
    """(sim_state, est_state, gen, superstep) from ``path`` (without
    extensions), every tensor on ``device`` (none named: the card,
    ``default_device``). ``est_template`` (a fresh ``init()`` output)
    gives the estimator state's structure; the simulator state's is
    fixed, and ``sim_template`` is taken for the JAX signature. Raises
    ``ValueError`` when the structure differs, the checkpoint was
    written on another device type, or on a mesh of another shape than
    ``mesh_shape`` (None: a run with no mesh)."""
    device = default_device(device)
    with open(path + ".json") as fh:
        manifest = json.load(fh)
    saved = manifest.get("mesh_shape")
    want = None if mesh_shape is None else list(mesh_shape)
    if saved != want:
        raise ValueError(f"checkpoint {path} was written on "
                         f"{_shape_name(saved)} and cannot resume a run on "
                         f"{_shape_name(want)}")
    wrote = manifest.get("device_type")
    if wrote != device.type:
        raise ValueError(
            f"checkpoint {path} was written on a {wrote} device and cannot "
            f"load on {device}: its random streams are {wrote} generator "
            "states")
    est_n, host_n = [], []
    _est_leaves(est_template, est_n, host_n)
    if (manifest["n_sim_leaves"] != N_SIM_LEAVES
            or manifest["n_est_leaves"] != len(est_n)
            or len(manifest["est_host"]) != len(host_n)):
        raise ValueError(f"checkpoint {path}: structure mismatch")
    with np.load(path + ".npz") as data:
        sim = [data[f"sim_{i}"] for i in range(N_SIM_LEAVES)]
        est = [data[f"est_{i}"] for i in range(len(est_n))]
        key = data["key"]
    vehicle = VehicleState(*(torch.from_numpy(a).to(device)
                             for a in sim[:len(VehicleState._fields)]))
    sim_state = SimState(vehicle=vehicle,
                         generator=_generator(sim[-2], device),
                         tick=int(sim[-1]))
    est_state = _est_rebuild(est_template, iter(est),
                             iter(manifest["est_host"]), device)
    return (sim_state, est_state, _generator(key, device),
            manifest["superstep"])


def save_sharded_checkpoint(path: str, sim_state: SimState, est, est_state,
                            gen, superstep: int,
                            meta: dict | None = None) -> str:
    """The checkpoint of a sharded run, one for all ranks: every rank of
    ``est.mesh`` calls this with its block ``est_state``. The blocks are
    gathered into the global state (``est.state_specs()``), each rank's
    stream state (``est.stream``, where the estimator draws) gathered
    by mesh coordinate, and the mesh's first rank writes them with
    ``save_checkpoint``; every rank returns once the files are
    written. Returns the npz path."""
    mesh = est.mesh
    state = gather_state(est_state, mesh, est.state_specs())
    stream = getattr(est, "stream", None)
    streams = None
    if stream is not None:
        mine = stream(gen).get_state().to(est.device)
        streams = _host(mesh_all_gather(mine, mesh))
    if dist.get_rank() == int(mesh.mesh.flatten()[0]):
        save_checkpoint(path, sim_state, state, gen, superstep, meta,
                        streams=streams, mesh_shape=tuple(mesh.mesh.shape))
    # A barrier along each mesh axis in turn: on a grid, the second
    # ends only after every first-axis barrier, the writer's among them.
    for dim in range(mesh.ndim):
        dist.barrier(group=mesh.get_group(dim))
    return path + ".npz"


def load_sharded_checkpoint(path: str, sim_template: SimState, est,
                            est_template):
    """(sim_state, est_state, gen, superstep) of this rank from a
    checkpoint that ``save_sharded_checkpoint`` wrote: the global state
    read and this rank's block cut out (``est_template``, a fresh
    ``init()``, gives the block's structure), on ``est.device``; the
    rank's stream continues from its saved state, bound to the returned
    run generator. Raises ``ValueError`` on a mesh of another shape."""
    mesh, specs = est.mesh, est.state_specs()
    sim_state, state, gen, superstep = load_checkpoint(
        path, sim_template, global_shapes(est_template, mesh, specs),
        est.device, mesh_shape=tuple(mesh.mesh.shape))
    est_state = shard_state(state, mesh, specs, est.device)
    stream = getattr(est, "stream", None)
    if stream is not None:
        with np.load(path + ".npz") as data:
            mine = data["streams"][tuple(mesh.get_coordinate())]
        stream.restore(gen, torch.from_numpy(mine.copy()))
    return sim_state, est_state, gen, superstep


def load_jax_checkpoint(path: str, sim_template: SimState, est_template,
                        seed: int, device=None):
    """(sim_state, est_state, gen, superstep) from a checkpoint that the
    JAX package's ``save_checkpoint`` wrote, on ``device`` (none named:
    the card).

    The vehicle leaves, ``tick``, ``superstep`` and the estimator's
    leaves carry over, through ``state_from_numpy``,
    ``deferred_state_from_numpy`` or ``ekf_state_from_numpy`` by the
    template's type; a deferred carry's TPU window metadata (``lo``,
    ``nch``, ``ident``) is dropped. The random streams do not carry
    over: a threefry key cannot become a Philox stream, so the
    simulator's generator and the run generator both start from
    ``seed`` (``seed`` and ``seed + 1``, as a fresh run seeds them). A
    continued run is therefore a run from the same state, not the JAX
    run's own continuation, unless it draws no random numbers."""
    device = default_device(device)
    with open(path + ".json") as fh:
        manifest = json.load(fh)
    with np.load(path + ".npz") as data:
        sim = [data[f"sim_{i}"] for i in range(manifest["n_sim_leaves"])]
        est = [data[f"est_{i}"] for i in range(manifest["n_est_leaves"])]
    n_vehicle = len(VehicleState._fields)
    if len(sim) != n_vehicle + 2:
        raise ValueError(f"checkpoint {path}: {len(sim)} simulator leaves, "
                         f"want {n_vehicle + 2}")
    vehicle = VehicleState(*(torch.from_numpy(np.array(a, copy=True))
                             .to(device) for a in sim[:n_vehicle]))
    sim_state = SimState(
        vehicle=vehicle,
        generator=torch.Generator(device=device).manual_seed(seed),
        tick=int(sim[-1]))
    ps_fields = ParticleState._fields
    if isinstance(est_template, DeferredState):
        est_state = deferred_state_from_numpy(
            {"ps": dict(zip(ps_fields, est)), "S": est[len(ps_fields)]},
            device)
    elif isinstance(est_template, ParticleState):
        est_state = state_from_numpy(dict(zip(ps_fields, est)), device)
    elif isinstance(est_template, EKFState):
        est_state = ekf_state_from_numpy(dict(zip(EKFState._fields, est)),
                                         device)
    else:
        raise ValueError(f"no JAX checkpoint layout for "
                         f"{type(est_template).__name__}")
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return sim_state, est_state, gen, manifest["superstep"]


def _threefry_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` of the default threefry
    implementation, without JAX: the seed's high and low 32 bits as
    uint32 [2]."""
    seed &= 2 ** 64 - 1
    return np.array([seed >> 32, seed & 0xFFFFFFFF], dtype=np.uint32)


def save_jax_checkpoint(path: str, sim_state: SimState, est_state,
                        superstep: int, seed: int,
                        meta: dict | None = None) -> str:
    """Write ``<path>.npz`` and ``<path>.json`` in the layout that the
    JAX package's ``load_checkpoint`` reads and ``run_checkpointed``
    resumes: the converse of ``load_jax_checkpoint``. The vehicle,
    ``tick``, ``superstep`` and the estimator's leaves carry over; a
    torch generator cannot become a threefry key, so the simulator's key
    and the run key are ``PRNGKey(seed)`` and ``PRNGKey(seed + 1)``, as a
    fresh JAX run seeds them, and no generator state is written. Takes a
    ``ParticleState`` or an ``EKFState``; a ``DeferredState`` raises
    ``ValueError``, as JAX's carry holds the TPU kernel's window
    metadata, which the port does not keep. Returns the npz path."""
    if not isinstance(est_state, (ParticleState, EKFState)):
        raise ValueError(f"no JAX checkpoint layout for "
                         f"{type(est_state).__name__}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sim = [*(_host(t) for t in sim_state.vehicle), _threefry_key(seed),
           np.asarray(sim_state.tick, np.int32)]
    est = [_host(t) for t in est_state]
    arrays = {"key": _threefry_key(seed + 1)}
    arrays.update({f"sim_{i}": a for i, a in enumerate(sim)})
    arrays.update({f"est_{i}": a for i, a in enumerate(est)})
    np.savez_compressed(path + ".npz", **arrays)
    with open(path + ".json", "w") as fh:
        json.dump({"superstep": int(superstep), "n_sim_leaves": len(sim),
                   "n_est_leaves": len(est), "meta": meta or {}}, fh)
    return path + ".npz"
