"""r1_roofline (device trace), %: R1's (csrc/offspring_bounds.cu, a fired
resample's offspring bounds in one launch) least time at the card's
memory bandwidth over its profiled device time per call. Layer: kernels.

Bytes, from the particle count P the cell sets: the prefix sum read
(P float32), the dither read at each entry's stratum k (P float32) and
the bounds written (P int32), 12 P bytes: 12.6 MB at P = 2^20, 3.76 us
at 3.35 TB/s. None where the sub-window holds no call of R1 (a program
without it, or a window in which no resample fired)."""

from benchmark.peaks import hbm_bytes_per_s
from benchmark.tracing import kernel

NAME = "offspring_bounds_kernel"


def r1_bytes(P: int) -> int:
    return 3 * P * 4


def read(ctx):
    hit = kernel(ctx["trace"], NAME) if ctx["trace"] else None
    bw = hbm_bytes_per_s(ctx["device_kind"])
    if not hit or not bw:
        return None
    seconds, calls = hit
    return 100.0 * r1_bytes(ctx["shapes"]["P"]) / bw / (seconds / calls)
