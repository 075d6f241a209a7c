"""The multi-device layer (counterpart: slam_tpu.parallel): the
particle-sharded and landmark-sharded FastSLAM filters on
``torch.distributed`` (one rank per device: NCCL between cards, gloo
between CPU processes), their collective resample, and the one-card arm
of the landmark-block EKF (``parallel.ekf``; its collectives across
cards are not ported yet)."""

from slam_tpu_torch.parallel.mesh import make_mesh, particle_sharding
from slam_tpu_torch.parallel.resampling import ring_resample
from slam_tpu_torch.parallel.filter import ShardedFastSlam1, ShardedFastSlam2
from slam_tpu_torch.parallel.ekf import ShardedEkfSlam

__all__ = [
    "make_mesh",
    "particle_sharding",
    "ring_resample",
    "ShardedFastSlam1",
    "ShardedFastSlam2",
    "ShardedEkfSlam",
]
