"""k5_roofline (device trace), %: K5's (csrc/resample_update.cu) least
time at the card's memory bandwidth over its profiled device time per
call. Layer: kernels.

Bytes, from the shapes the cell sets (P particles, L slots, K
observations): the new landmark planes written once (5 L P float32) and
the weights updated in place; read once, the poses, weights and bounds
and the observations with their slots. Which old landmark columns K5
reads depends on the draws (the distinct ancestors), so they are not
counted: the share is a lower bound."""

from benchmark.peaks import hbm_bytes_per_s
from benchmark.tracing import kernel

NAME = "fs1_resample_update_kernel"


def k5_bytes(P: int, L: int, K: int) -> int:
    writes = 5 * L * P * 4 + P * 4
    reads = 3 * P * 4 + P * 4 + P * 4 + K * 2 * 4 + K * (4 + 1 + 4 + 1)
    return writes + reads


def read(ctx):
    hit = kernel(ctx["trace"], NAME) if ctx["trace"] else None
    bw = hbm_bytes_per_s(ctx["device_kind"])
    if not hit or not bw:
        return None
    s = ctx["shapes"]
    seconds, calls = hit
    return 100.0 * k5_bytes(s["P"], s["L"], s["K"]) / bw / (seconds / calls)
