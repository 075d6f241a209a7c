"""The multi-device layer (counterpart: slam_tpu.parallel) on
``torch.distributed``, one rank per device (NCCL between cards, gloo
between CPU processes): the particle-sharded and landmark-sharded
FastSLAM filters with their collective resample, and the
landmark-sharded EKF (``parallel.ekf``, Pmm's rows split over a 1-D
``l`` mesh). The sharded bundle adjustment is
``posegraph.distributed``."""

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
