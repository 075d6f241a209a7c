"""ekf_pmm_roofline (device trace), %: the EKF's pass over Pmm
(``slam_tpu_torch/parallel/ekf.py``, ``Pmm.addmm_(W, W.T, alpha=-1)``
with W = [W1_m | hk], one SGEMM a superstep) at its least time over its
profiled device time per call. Layer: kernels.

From the shapes the cell sets (L slots, K observations, T heading terms
deferred a superstep): Pmm is [2L, 2L] float32 and W [2L, 2K + T], so
the pass makes 2 (2L)^2 (2K + T) floating-point operations and reads and
writes Pmm once, 2 (2L)^2 4 bytes; the least time is the larger of the
operations at the card's float32 rate (TF32 off, as the program runs)
and the bytes at its memory bandwidth. The kernel is found by the name
the card's trace gives that SGEMM on the H100 (cuBLAS's 128x128 tile of
a transposed-by-normal product; the update's smaller products take its
32x32 tile), and read only where its calls in the sub-window equal the
passes the program counted there (``pmm_passes``): another product of
that name would dilute it."""

from benchmark.fp32_peaks import fp32_flops
from benchmark.peaks import hbm_bytes_per_s
from benchmark.tracing import kernel

NAME = "gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8"


def pmm_flops(L: int, K: int, T: int) -> int:
    return 2 * (2 * L) ** 2 * (2 * K + T)


def pmm_bytes(L: int) -> int:
    return 2 * (2 * L) ** 2 * 4


def pmm_bound_s(L: int, K: int, T: int, kind: str):
    """The pass's least time on the card ``kind`` (None if unknown)."""
    flops, bw = fp32_flops(kind), hbm_bytes_per_s(kind)
    if not flops or not bw:
        return None
    return max(pmm_flops(L, K, T) / flops, pmm_bytes(L) / bw)


def read(ctx):
    hit = kernel(ctx["trace"], NAME) if ctx["trace"] else None
    passes = [u["window_pmm_passes"] for u in ctx["units"]
              if "window_pmm_passes" in u]
    s = ctx["shapes"]
    bound = pmm_bound_s(s["L"], s["K"], s["T"], ctx["device_kind"])
    if not hit or not passes or bound is None or hit[1] != passes[0]:
        return None
    seconds, calls = hit
    return 100.0 * bound / (seconds / calls)
