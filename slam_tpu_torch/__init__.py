"""slam_tpu_torch — the PyTorch / CUDA port of slam_tpu.

The JAX package ``slam_tpu`` is the reference; this package mirrors its
module names so each port can be found beside its counterpart:

- ``slam_tpu_torch.config`` / ``maps`` — the port's own copies of the
  JAX package's config and map reader, equal to them field for field.
- ``slam_tpu_torch.geometry`` and ``ops.planes`` — the plane algebra.
- ``slam_tpu_torch.ops.resampling`` — log-space weights, Neff, the
  closed-form stratified offspring bounds.
- ``slam_tpu_torch.ops.kernels`` — the hand-written CUDA kernels
  (``csrc/``) with their plain PyTorch twins.
- ``slam_tpu_torch.sim`` — vehicle, sensor and simulator.
- ``slam_tpu_torch.models`` — FastSLAM 1.0 on the struct-of-planes
  particle state.
- ``slam_tpu_torch.runtime`` — the superstep run loop and the
  DataGatherer-format metrics.
- ``slam_tpu_torch.device`` — ``default_device``: the entry points run
  on the card unless the caller names a device, and raise without one.

Only ``torch`` and ``numpy`` are imported; never ``jax``, and nothing of
the ``slam_tpu`` package.
"""

__version__ = "0.1.0"

from slam_tpu_torch.config import SlamConfig
from slam_tpu_torch.device import default_device
from slam_tpu_torch.maps import SlamMap, read_map_file, synthetic_map

__all__ = [
    "SlamConfig",
    "SlamMap",
    "default_device",
    "read_map_file",
    "synthetic_map",
    "__version__",
]
