"""k3_roofline (device trace), %: K3's (csrc/refine.cu, FastSLAM 2's
sequential proposal refinement) least time on the card over its
profiled device time, summed over the sub-window's calls. Layer:
kernels.

K3 runs one thread a particle, through the K observation slots in order,
and touches a slot's gathered landmark planes only where the slot is
matched (an unmatched slot is skipped, its planes never read). A call
with M matched observations, at P particles, reads the pose and the
packed pose covariance (9 floats a particle), the five gathered planes
of each matched slot (5 M floats a particle) and the observations with
their flags (9 K bytes), and writes the refined pose and covariance (9
floats a particle): 4 P (18 + 5 M) + 9 K bytes. It makes
``FLOPS_PER_MATCH`` operations a matched slot a particle, counted from
refine.cu's loop body as written (the library is built with
--fmad=false; each addition, subtraction, multiplication, division and
square root one, the Jacobians with atan2's polynomial and two angle
wraps 56, the innovation with its wrap 6, the refinement step 100, the
pose step with its wrap 7). The least time of the calls is the larger of
their bytes at the card's memory bandwidth and their operations at its
float32 rate. The shapes give P and K; ``drivers/fs2_loop.py`` counts,
from the traced run's traces, the sub-window's supersteps
(``window_supersteps``: K3 runs once an update) and the matched
observations in them (``window_matched``). Read only where K3's calls in
the sub-window equal its supersteps."""

from benchmark.fp32_peaks import fp32_flops
from benchmark.peaks import hbm_bytes_per_s
from benchmark.tracing import kernel

NAME = "fs2_refine_kernel"
FLOPS_PER_MATCH = 56 + 6 + 100 + 7


def k3_bytes(P: int, K: int, calls: int, matched: int) -> int:
    """Bytes of ``calls`` calls that refine ``matched`` observations in
    all."""
    return calls * (4 * P * 18 + 9 * K) + 4 * P * 5 * matched


def k3_flops(P: int, matched: int) -> int:
    return FLOPS_PER_MATCH * P * matched


def k3_bound_s(P: int, K: int, calls: int, matched: int, kind: str):
    """The calls' least time on the card ``kind`` (None if unknown)."""
    bw, flops = hbm_bytes_per_s(kind), fp32_flops(kind)
    if not bw or not flops:
        return None
    return max(k3_bytes(P, K, calls, matched) / bw,
               k3_flops(P, matched) / flops)


def read(ctx):
    hit = kernel(ctx["trace"], NAME) if ctx["trace"] else None
    window = [u for u in ctx["units"] if "window_matched" in u]
    if not hit or not window:
        return None
    seconds, calls = hit
    w = window[0]
    s = ctx["shapes"]
    bound = k3_bound_s(s["P"], s["K"], calls, w["window_matched"],
                       ctx["device_kind"])
    if bound is None or calls != w["window_supersteps"]:
        return None
    return 100.0 * bound / seconds
