"""k6_roofline (device trace), %: K6's (csrc/predict.cu, the multi-tick
FastSLAM 1 predict) least time at the card's memory bandwidth over its
profiled device time per call. Layer: kernels.

Bytes, from the shapes the cell sets (P particles, T ticks): the poses
read and written once (3 P float32 each way), the controls and the key.
Only the bytes bound is taken, so the share is a lower bound where the
kernel's operations bound it."""

from benchmark.peaks import hbm_bytes_per_s
from benchmark.tracing import kernel

NAME = "fs1_predict_multi_kernel"


def k6_bytes(P: int, T: int) -> int:
    return 2 * 3 * P * 4 + T * 2 * 4 + 2 * 4


def read(ctx):
    hit = kernel(ctx["trace"], NAME) if ctx["trace"] else None
    bw = hbm_bytes_per_s(ctx["device_kind"])
    if not hit or not bw:
        return None
    s = ctx["shapes"]
    seconds, calls = hit
    return 100.0 * k6_bytes(s["P"], s["T"]) / bw / (seconds / calls)
