"""The hand-written CUDA kernels of the FastSLAM 1 slices, with their
plain PyTorch twins (counterpart: slam_tpu.ops.pallas).

=====  ===========================  ===================================
id     wrapper                      replaces
=====  ===========================  ===================================
K2     kernels.observe              kernels.py:_observe_call
K4     kernels.fused_update         kernels.py:fs1_update_tpu
K5     kernels.resample_update      kernels.py:fs1_resample_update_tpu
K6     predict.fs1_predict_multi    kernels.py:fs1_predict_multi_tpu
G1     gather.sorted_gather_multi   gather.py:sorted_gather_multi
G2     gather.bounds_gather_multi   gather.py:bounds_gather_multi
=====  ===========================  ===================================
"""

from slam_tpu_torch.ops.kernels.gather import (
    bounds_gather_multi,
    sorted_gather_multi,
)
from slam_tpu_torch.ops.kernels.kernels import (
    fused_update,
    observe,
    resample_update,
)
from slam_tpu_torch.ops.kernels.predict import fs1_predict_multi

WRAPPERS = {
    "K2": observe,
    "K4": fused_update,
    "K5": resample_update,
    "K6": fs1_predict_multi,
    "G1": sorted_gather_multi,
    "G2": bounds_gather_multi,
}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {k: w.launches for k, w in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


__all__ = ["WRAPPERS", "bounds_gather_multi", "fs1_predict_multi",
           "fused_update", "launch_counts", "observe",
           "reset_launch_counts", "resample_update", "sorted_gather_multi"]
