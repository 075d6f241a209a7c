"""FastSLAM with the particle axis sharded over a mesh of ranks
(counterpart: slam_tpu.parallel.filter).

Each rank holds a block of the particles and runs the single-device
update on it (``fastslam1.fs1_observe``, ``fastslam2.fs2_observe``, with
their kernels on the card: K4 or K2 by the block's size, K3 for the
FastSLAM 2 proposal); the two global steps become collectives:

- the Neff gate and the weight normalization: all-reduced scalars;
- the stratified resample: ``parallel.resampling.ring_resample``.

Every rank runs its own ``Runner`` on the same seed, so the simulated
truth and observations are the same on every rank; the estimator works
on the rank's block, and ``pose`` (``sharded_estimate_position``) is the
same on every rank. The classes have the single-device estimators'
init / predict / update / pose interface.

Random draws come from the rank's own stream (``RankStream``): the run
generator's seed with the particle shard folded in, where JAX folds
``axis_index`` into the key. FastSLAM 2's proposal noise comes from it
too, so each shard draws its own; JAX's ``ShardedFastSlam2`` splits the
same key on every shard and so draws the same [3, Pl] noise on each.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.models import rbpf
from slam_tpu_torch.models.fastslam1 import fs1_observe, fs1_predict
from slam_tpu_torch.models.fastslam2 import (
    fs2_observe,
    fs2_predict,
    proposal_noise,
)
from slam_tpu_torch.models.particles import ParticleState, init_particles
from slam_tpu_torch.parallel.mesh import (
    axis_size,
    mesh_device,
    particle_state_specs,
)
from slam_tpu_torch.parallel.resampling import (
    ring_resample,
    sharded_estimate_position,
)

_MASK64 = 2 ** 64 - 1


def fold_in(seed: int, index: int) -> int:
    """A seed for stream ``index`` of a run seeded with ``seed``
    (SplitMix64's mix of the two), below 2^63."""
    x = (seed + (index + 1) * 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


class RankStream:
    """The rank's random stream for the run that ``gen`` (the Runner's
    generator) drives: a generator on ``device`` seeded with
    ``fold_in(gen.initial_seed(), index)``, made anew for each run
    generator, unless ``restore`` gave it one. ``index`` is the particle
    shard, so ranks that hold the same particles (landmark shards) draw
    the same numbers."""

    def __init__(self, index: int, device: torch.device):
        self.index, self.device = index, device
        self._run = self._gen = None

    def __call__(self, gen: torch.Generator) -> torch.Generator:
        if gen is not self._run:
            self._gen = torch.Generator(device=self.device).manual_seed(
                fold_in(gen.initial_seed(), self.index))
            self._run = gen
        return self._gen

    def restore(self, gen: torch.Generator, state: torch.Tensor) -> None:
        """Continue a saved stream: a generator in ``state`` (a
        ``get_state()``), bound to the run generator ``gen`` (a resumed
        run's), so that calls with ``gen`` draw on from it."""
        self._gen = torch.Generator(device=self.device)
        self._gen.set_state(state)
        self._run = gen


class _ShardedFastSlamBase:
    """The scaffolding of the sharded filters: the particle axis ``axis``
    of ``mesh`` splits the N particles into blocks of N / S."""

    # The fields the per-tick predict writes (JAX's run-loop hint).
    PREDICT_TOUCHED = ("xv", "Pv")

    _predict_fn = None   # staticmethod in subclasses

    def __init__(self, config: SlamConfig, n_map_landmarks: int,
                 mesh: DeviceMesh, n_particles: int,
                 predict_noise: bool = True, axis: str | None = None):
        self.config = config
        self.n_map = n_map_landmarks
        # Capacity rounds up to a multiple of 8, as in JAX.
        cap = config.max_landmarks or n_map_landmarks
        self.capacity = -(-cap // 8) * 8
        self.mesh = mesh
        self.axis = axis or mesh.mesh_dim_names[0]
        self.group = mesh.get_group(self.axis)
        self.n_shards = axis_size(mesh, self.axis)
        if n_particles % self.n_shards:
            raise ValueError(f"n_particles={n_particles} must divide over "
                             f"{self.n_shards} particle shards")
        self.n_particles = n_particles
        self.predict_noise = predict_noise
        self.device = mesh_device(mesh)
        self.stream = RankStream(mesh.get_local_rank(self.axis), self.device)
        self.Q = np.diag(np.asarray(config.Qe, np.float32))
        self.R = np.diag(np.asarray(config.Re, np.float32))

    def state_specs(self) -> ParticleState:
        """How the state splits over the mesh (``parallel.mesh``)."""
        return particle_state_specs(self.axis)

    @property
    def n_min(self) -> float:
        """The global Neff threshold, NEFFECTIVE scaled to N."""
        cfg = self.config
        return float(cfg.NEFFECTIVE * self.n_particles / cfg.NPARTICLES
                     if cfg.NPARTICLES else cfg.NEFFECTIVE)

    def _init(self, n: int, capacity: int) -> ParticleState:
        """This rank's block of the global initial state of ``n``
        particles: uniform weights -log(n), made in place."""
        if n % self.n_shards:
            raise ValueError(f"n_particles={n} must divide over "
                             f"{self.n_shards} particle shards")
        state = init_particles(n // self.n_shards, capacity, self.n_map,
                               device=self.device)
        return state._replace(logw=torch.full_like(state.logw,
                                                   -math.log(float(n))))

    def init(self, n_particles: int | None = None) -> ParticleState:
        return self._init(n_particles or self.n_particles, self.capacity)

    def predict(self, state, gen, vn, gn, phi) -> ParticleState:
        cfg = self.config
        state = type(self)._predict_fn(
            state, self.stream(gen), vn, gn, self.Q,
            wheelbase=cfg.WHEELBASE, dt=cfg.DT_CONTROLS,
            add_noise=self.predict_noise)
        if cfg.SWITCH_HEADING_KNOWN:
            state = rbpf.observe_heading_particles(state, phi, cfg.sigmaT)
        return state

    def _observe(self, state, rank_gen, z, ids, zmask) -> ParticleState:
        raise NotImplementedError

    def update(self, state, gen, z, ids, zmask) -> ParticleState:
        """The shard's update up to the resample, then the collective
        resample over the particle axis."""
        rank_gen = self.stream(gen)
        state = self._observe(state, rank_gen, z, ids, zmask)
        state, logw, _ = ring_resample(
            state, state.logw, rank_gen, self.n_min,
            bool(self.config.SWITCH_RESAMPLE), self.group)
        return state._replace(logw=logw)

    def pose(self, state) -> torch.Tensor:
        return sharded_estimate_position(state.logw, state.xv, self.group)


class ShardedFastSlam1(_ShardedFastSlamBase):
    """FastSLAM 1.0 over a 1-D particle mesh (``mesh.make_mesh``)."""

    _predict_fn = staticmethod(fs1_predict)

    def __init__(self, config, n_map_landmarks, mesh, n_particles):
        # FS1 forces the predict noise on, as the single-device filter.
        super().__init__(config, n_map_landmarks, mesh, n_particles,
                         predict_noise=True)

    def _observe(self, state, rank_gen, z, ids, zmask):
        slot, matched, is_new = rbpf.associate_slots(state, ids, zmask)
        return fs1_observe(state, z, ids, slot, matched, is_new, self.R)


class ShardedFastSlam2(_ShardedFastSlamBase):
    """FastSLAM 2.0 over a 1-D particle mesh."""

    _predict_fn = staticmethod(fs2_predict)

    def __init__(self, config, n_map_landmarks, mesh, n_particles):
        super().__init__(config, n_map_landmarks, mesh, n_particles,
                         predict_noise=bool(config.SWITCH_PREDICT_NOISE))

    def _observe(self, state, rank_gen, z, ids, zmask):
        eps = proposal_noise(state.n_particles, rank_gen)
        return fs2_observe(state, z, ids, zmask, self.R, eps)
