"""The hand-written CUDA kernels of the port, with their plain PyTorch
twins (counterpart: slam_tpu.ops.pallas). Every TPU kernel of the JAX
package has one; the simulator (S1), the block EKF (E1), FastSLAM 2's
predict tick (F2) and the resample's offspring bounds (R1) have their
own:

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
S1     vehicle.control_multi        (no kernel: the simulator's ticks)
E1     ekf.ekf_predict_tick         (no kernel: the block EKF's predict)
F2     predict.fs2_predict_tick     (no kernel: FastSLAM 2's predict tick
                                    with the heading known)
R1     bounds.offspring_bounds      (no kernel: a fired resample's
                                    offspring bounds)
=====  ===========================  ===================================
"""

from slam_tpu_torch.ops.kernels.bounds import offspring_bounds
from slam_tpu_torch.ops.kernels.ekf import ekf_predict_tick
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
    fs2_predict_tick,
)
from slam_tpu_torch.ops.kernels.vehicle import control_multi

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
    "S1": control_multi,
    "E1": ekf_predict_tick,
    "F2": fs2_predict_tick,
    "R1": offspring_bounds,
}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {k: w.launches for k, w in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


__all__ = ["WRAPPERS", "bounds_gather_multi", "control_multi",
           "ekf_predict_tick", "fs1_predict_multi", "fs2_predict_multi",
           "fs2_predict_tick", "fs2_refine",
           "fused_update", "jacobians", "launch_counts", "observe",
           "offspring_bounds", "reset_launch_counts", "resample_update",
           "sorted_gather_multi"]
