"""FastSLAM with both the particle axis and the landmark axis sharded
(counterpart: slam_tpu.parallel.landmarks).

The landmark planes [*, L, P] split over a 2-D mesh ``("p", "l")``:
particles over ``p``, landmark slots over ``l``; each ``l`` shard owns
L / S_l consecutive slots. Known association routes every observation
to the one shard that owns its slot, so little crosses the mesh:

- FastSLAM 1: each shard's update sees only the slots it owns
  (``kernels.landmark_update`` with the cross-shard arm), and the
  per-particle weight term is summed over ``l``: one [Pl] all-reduce;
- FastSLAM 2: the K gathered landmark planes, masked to their owners,
  are summed over ``l`` (one [5, K, Pl] all-reduce), so the proposal's
  refinement (in order over k) runs on the full set on every shard; the
  feature updates stay shard-local;
- new features: every shard assigns the same global slots and writes
  the ones it owns; the slot table and the live count advance on every
  shard by the same arithmetic, with no collective;
- the resample: ``ring_resample`` over ``p``; the ``l`` shards of a
  particle block hold the same weights and draw the same stream, so
  they make the same decisions and each moves its own landmark slab.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from slam_tpu_torch.models import rbpf
from slam_tpu_torch.models.fastslam1 import fs1_predict
from slam_tpu_torch.models.fastslam2 import (
    _log_likelihood_at,
    fs2_predict,
    fs2_propose,
    proposal_noise,
)
from slam_tpu_torch.models.particles import ParticleState
from slam_tpu_torch.ops import planes as pk
from slam_tpu_torch.ops.kernels.kernels import landmark_update
from slam_tpu_torch.parallel.filter import _ShardedFastSlamBase
from slam_tpu_torch.parallel.mesh import axis_size, mesh_over

P_AXIS = "p"
L_AXIS = "l"


def make_mesh_2d(n_p: int, n_l: int, ranks=None) -> DeviceMesh:
    """The (p, l) mesh over ``ranks`` (the first n_p n_l of the process
    group by default), particle axis major: the ``l`` shards of one
    particle block are neighbouring ranks."""
    ranks = list(range(n_p * n_l) if ranks is None else ranks)
    return mesh_over(ranks[:n_p * n_l], (n_p, n_l), (P_AXIS, L_AXIS))


def state_specs_2d() -> ParticleState:
    """Specs of the fields on the (p, l) mesh: the landmark planes split
    on L over ``l`` and on P over ``p``."""
    return ParticleState(logw=(P_AXIS,), xv=(None, P_AXIS),
                         Pv=(None, P_AXIS), lm=(None, L_AXIS, P_AXIS),
                         lm_P=(None, L_AXIS, P_AXIS), n=(), da_table=())


def _local_slots(slot, matched, lo: int, L_local: int):
    """Global slots onto this shard's slab: (local slot [K] int32, 0
    where not owned; owned [K])."""
    own = matched & (slot >= lo) & (slot < lo + L_local)
    return torch.where(own, slot - lo, 0).to(torch.int32), own


def _new_slots_local(state: ParticleState, is_new, lo: int, S_l: int):
    """The new observations' global slots, from n in observation order,
    kept below the global capacity: (slot_new, ok, ok_here, local slot)
    where ``ok_here`` are the ones this shard owns."""
    L_local = state.capacity
    new = is_new.to(torch.int32)
    slot_new = state.n + torch.cumsum(new, dim=0, dtype=torch.int32) - new
    ok = is_new & (slot_new < L_local * S_l)
    ok_here = ok & (slot_new >= lo) & (slot_new < lo + L_local)
    return (slot_new, ok, ok_here,
            torch.where(ok_here, slot_new - lo, 0).to(torch.int32))


def _add_new_local(state: ParticleState, z, ok_here, slot_l, R) -> None:
    """New features at the owned slots, every particle from its own pose,
    in place; a no-op where nothing is owned."""
    nx, ny, p00, p01, p11 = pk.feature_init_planes(
        state.xv[0:1], state.xv[1:2], state.xv[2:3], z[:, 0:1], z[:, 1:2],
        *pk.sym2_host(R))
    rbpf.scatter_slots(state.lm, slot_l, torch.stack([nx, ny]), ok_here)
    rbpf.scatter_slots(state.lm_P, slot_l, torch.stack([p00, p01, p11]),
                       ok_here)


def _advance_table(state: ParticleState, ids, slot_new, ok) -> ParticleState:
    """The slot table and the live count, the same on every shard."""
    rbpf.set_table(state.da_table, ids, slot_new, ok)
    return state._replace(n=state.n + ok.sum(dtype=torch.int32))


class _LandmarkShardedBase(_ShardedFastSlamBase):
    """FastSLAM over a (p, l) mesh (``make_mesh_2d``); the Runner's
    interface. Capacity rounds up to a multiple of S_l, as in JAX."""

    def __init__(self, config, n_map_landmarks: int, mesh: DeviceMesh,
                 n_particles: int, predict_noise: bool = True):
        if tuple(mesh.mesh_dim_names) != (P_AXIS, L_AXIS):
            raise ValueError(f"a landmark-sharded filter needs a "
                             f"{(P_AXIS, L_AXIS)} mesh, got "
                             f"{mesh.mesh_dim_names}")
        super().__init__(config, n_map_landmarks, mesh, n_particles,
                         predict_noise, axis=P_AXIS)
        self.l_group = mesh.get_group(L_AXIS)
        self.n_l = axis_size(mesh, L_AXIS)
        cap = config.max_landmarks or n_map_landmarks
        self.capacity = -(-cap // self.n_l) * self.n_l
        self.lo = mesh.get_local_rank(L_AXIS) * (self.capacity // self.n_l)

    def state_specs(self) -> ParticleState:
        return state_specs_2d()

    def init(self, n_particles: int | None = None) -> ParticleState:
        return self._init(n_particles or self.n_particles,
                          self.capacity // self.n_l)


class LandmarkShardedFastSlam1(_LandmarkShardedBase):
    """FastSLAM 1.0 on a (p, l) mesh. Its update is the kernel that
    ``kernels.landmark_update`` picks, with the cross-shard weight arm.
    ``fused=False`` takes the JAX package's arm off a TPU
    instead: the owned slots' planes gathered, the likelihood summed
    over ``l``, the feature updates scattered back, the new features
    written apart."""

    _predict_fn = staticmethod(fs1_predict)

    def __init__(self, config, n_map_landmarks, mesh, n_particles,
                 fused: bool = True):
        super().__init__(config, n_map_landmarks, mesh, n_particles,
                         predict_noise=True)
        self.fused = fused

    def _observe(self, state, rank_gen, z, ids, zmask):
        slot, matched, is_new = rbpf.associate_slots(state, ids, zmask)
        slot_l, own = _local_slots(slot, matched, self.lo, state.capacity)
        slot_new, ok, ok_here, slot_new_l = _new_slots_local(
            state, is_new, self.lo, self.n_l)
        if self.fused:
            landmark_update(state.xv, state.logw, state.lm, state.lm_P, z,
                            slot_l, own, slot_new_l, ok_here, self.R,
                            group=self.l_group)
        else:
            gathered = rbpf.gather_landmarks(state, slot_l)
            J, v0, v1 = rbpf.observe_planes(state, z, slot_l, self.R,
                                            gathered)
            logl = torch.where(own[:, None], pk.log_gauss2_planes(
                v0, v1, J.s00, J.s01, J.s11), 0.0).sum(dim=0)
            dist.all_reduce(logl, group=self.l_group)
            state = state._replace(logw=state.logw + logl)
            rbpf.update_matched_features(state, slot_l, own, v0, v1, J,
                                         gathered)
            _add_new_local(state, z, ok_here, slot_new_l, self.R)
        return _advance_table(state, ids, slot_new, ok)


class LandmarkShardedFastSlam2(_LandmarkShardedBase):
    """FastSLAM 2.0 on a (p, l) mesh: the gathered planes summed over
    ``l``, the proposal (K3 on the card) on the full set, then the
    likelihood at the sampled pose on the full set and the feature
    updates and new features on the owned slots."""

    _predict_fn = staticmethod(fs2_predict)

    def __init__(self, config, n_map_landmarks, mesh, n_particles):
        super().__init__(config, n_map_landmarks, mesh, n_particles,
                         predict_noise=bool(config.SWITCH_PREDICT_NOISE))

    def _observe(self, state, rank_gen, z, ids, zmask):
        slot, matched, is_new = rbpf.associate_slots(state, ids, zmask)
        slot_l, own = _local_slots(slot, matched, self.lo, state.capacity)
        local = rbpf.gather_landmarks(state, slot_l)
        gathered = torch.stack(local) * own[:, None].to(state.lm.dtype)
        dist.all_reduce(gathered, group=self.l_group)
        gathered = tuple(gathered.unbind(0))

        eps = proposal_noise(state.n_particles, rank_gen)
        state = fs2_propose(state, z, zmask, matched, gathered, self.R, eps)
        state = state._replace(logw=state.logw + _log_likelihood_at(
            state.xv, z, matched, gathered, self.R))
        J, v0, v1 = rbpf.observe_planes(state, z, slot_l, self.R, local)
        rbpf.update_matched_features(state, slot_l, own, v0, v1, J, local)
        slot_new, ok, ok_here, slot_new_l = _new_slots_local(
            state, is_new, self.lo, self.n_l)
        _add_new_local(state, z, ok_here, slot_new_l, self.R)
        return _advance_table(state, ids, slot_new, ok)
