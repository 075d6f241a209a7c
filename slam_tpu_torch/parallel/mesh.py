"""Meshes and shardings of the particle axis (counterpart:
slam_tpu.parallel.mesh).

JAX's ``Mesh`` becomes a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks of the process group that ``parallel.distributed``
starts, one rank per device; its axis names are JAX's. A sharding spec
is JAX's ``PartitionSpec`` as a tuple: per dimension of a field, the
mesh axis that splits it, or None where it is replicated. Where JAX
places a global array with ``device_put`` and reads it back with
``device_get``, ``shard_state`` cuts this rank's block out of a global
state and ``gather_state`` assembles the global state from the blocks.

Every rank of the process group must call ``make_mesh``, as each call
creates the mesh's process groups; a rank outside the mesh gets one
whose ``get_coordinate()`` is None.

A field that is no tensor (the EKF state's host count ``hk_n``) is the
same on every rank: ``shard_state`` and ``gather_state`` pass it on.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from slam_tpu_torch.models.particles import ParticleState

PARTICLE_AXIS = "p"

# The device type of a mesh, by the backend of the process group.
DEVICE_TYPES = {"nccl": "cuda", "gloo": "cpu"}


def mesh_over(ranks, shape: tuple[int, ...], names: tuple[str, ...]
              ) -> DeviceMesh:
    """A mesh of ``shape`` over ``ranks`` of the process group, row-major
    (the last axis fastest), on the group's device type."""
    backend = dist.get_backend()
    if backend not in DEVICE_TYPES:
        raise ValueError(f"no mesh device type for the {backend} backend")
    ranks = torch.as_tensor(list(ranks), dtype=torch.int64)
    return DeviceMesh(DEVICE_TYPES[backend], ranks.reshape(shape),
                      mesh_dim_names=names)


def make_mesh(n_devices: int | None = None, axis: str = PARTICLE_AXIS
              ) -> DeviceMesh:
    """1-D mesh over the particle axis: the first ``n_devices`` ranks of
    the process group, all of them by default."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return mesh_over(range(n), (n,), (axis,))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's blocks live on: its card under NCCL (the
    current CUDA device), the CPU under gloo."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along the mesh axis named ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def particle_state_specs(axis: str = PARTICLE_AXIS) -> ParticleState:
    """Specs of the ParticleState fields: the per-particle fields split
    on their last (particle) axis, ``n`` and ``da_table`` replicated."""
    return ParticleState(logw=(axis,), xv=(None, axis), Pv=(None, axis),
                         lm=(None, None, axis), lm_P=(None, None, axis),
                         n=(), da_table=())


def shard_state(state, mesh: DeviceMesh, specs, device=None):
    """This rank's block of a global state (a NamedTuple of tensors):
    each field cut along every dimension that ``specs`` names a mesh
    axis for, at this rank's coordinate on that axis; on ``device``
    (the mesh's by default). The counterpart of ``device_put`` with
    ``particle_sharding``."""
    device = mesh_device(mesh) if device is None else device
    out = {}
    for name, spec in zip(state._fields, specs):
        t = getattr(state, name)
        if not isinstance(t, torch.Tensor):
            out[name] = t
            continue
        for dim, axis in enumerate(spec):
            if axis is not None:
                t = t.chunk(axis_size(mesh, axis), dim)[
                    mesh.get_local_rank(axis)]
        out[name] = t.contiguous().to(device)
    return type(state)(**out)


def gather_state(state, mesh: DeviceMesh, specs):
    """The global state from every rank's block (every rank gets it):
    each split dimension all-gathered over its mesh axis. The
    counterpart of ``device_get`` of a sharded state; for tests and
    checkpoints, not the run loop."""
    out = {}
    for name, spec in zip(state._fields, specs):
        t = getattr(state, name)
        if not isinstance(t, torch.Tensor):
            out[name] = t
            continue
        for dim, axis in enumerate(spec):
            if axis is not None:
                parts = [torch.empty_like(t)
                         for _ in range(axis_size(mesh, axis))]
                dist.all_gather(parts, t.contiguous(),
                                group=mesh.get_group(axis))
                t = torch.cat(parts, dim)
        out[name] = t
    return type(state)(**out)


def global_shapes(state, mesh: DeviceMesh, specs):
    """The global state's structure without its values: each tensor
    field an empty tensor on the ``meta`` device, of the shape that
    ``gather_state`` would return; other fields as they are. A template
    for reading a global state, made with no collective."""
    out = {}
    for name, spec in zip(state._fields, specs):
        t = getattr(state, name)
        if isinstance(t, torch.Tensor):
            shape = list(t.shape)
            for dim, axis in enumerate(spec):
                if axis is not None:
                    shape[dim] *= axis_size(mesh, axis)
            t = torch.empty(shape, dtype=t.dtype, device="meta")
        out[name] = t
    return type(state)(**out)


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, in place (JAX's
    ``psum``); ``t`` itself where ``group`` is None (one device, no
    process group)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` (the same shape on each) along
    dim 0, in rank order (JAX's tiled ``all_gather``); ``t`` itself
    where ``group`` is None."""
    if group is None:
        return t
    out = t.new_empty((dist.get_world_size(group) * t.shape[0],
                       *t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def mesh_all_gather(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each), stacked by mesh
    coordinate: [*mesh.shape, *t.shape], on every rank. One all-gather
    along each mesh axis, the last first."""
    for dim in reversed(range(mesh.ndim)):
        t = all_gather_rows(t[None], mesh.get_group(dim))
    return t


def particle_sharding(mesh: DeviceMesh, axis: str = PARTICLE_AXIS):
    """(shard, gather) for ParticleState on a 1-D particle mesh: the
    counterpart of JAX's NamedShardings for ``device_put``, as two
    functions of a state."""
    specs = particle_state_specs(axis)
    return (lambda state: shard_state(state, mesh, specs),
            lambda state: gather_state(state, mesh, specs))
