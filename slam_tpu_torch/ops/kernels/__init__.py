"""The hand-written CUDA kernels of the port, with their plain PyTorch
twins (counterpart: slam_tpu.ops.pallas). Every TPU kernel of the JAX
package has one:

=====  ===========================  ===================================
id     wrapper                      replaces
=====  ===========================  ===================================
K1     kernels.jacobians            kernels.py:jacobians_tpu
K2     kernels.observe              kernels.py:fs1_observe_tpu
K3     kernels.fs2_refine           kernels.py:fs2_refine_tpu
K4     kernels.fused_update         kernels.py:fs1_update_tpu
K5     kernels.resample_update      kernels.py:fs1_resample_update_tpu
K6     predict.fs1_predict_multi    kernels.py:fs1_predict_multi_tpu
K6b    predict.fs2_predict_multi    kernels.py:fs2_predict_multi_tpu
G1     gather.sorted_gather_multi   gather.py:sorted_gather_multi
G2     gather.bounds_gather_multi   gather.py:bounds_gather_multi
=====  ===========================  ===================================
"""

from slam_tpu_torch.ops.kernels.gather import (
    bounds_gather_multi,
    sorted_gather_multi,
)
from slam_tpu_torch.ops.kernels.kernels import (
    fs2_refine,
    fused_update,
    jacobians,
    observe,
    resample_update,
)
from slam_tpu_torch.ops.kernels.predict import (
    fs1_predict_multi,
    fs2_predict_multi,
)

WRAPPERS = {
    "K1": jacobians,
    "K2": observe,
    "K3": fs2_refine,
    "K4": fused_update,
    "K5": resample_update,
    "K6": fs1_predict_multi,
    "K6b": fs2_predict_multi,
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
           "fs2_predict_multi", "fs2_refine", "fused_update", "jacobians",
           "launch_counts", "observe", "reset_launch_counts",
           "resample_update", "sorted_gather_multi"]
