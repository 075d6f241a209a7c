"""k5_live_roofline (device trace), %: K5's (csrc/resample_update.cu)
least time at the card's memory bandwidth over its profiled device time
per call, counting only the live slot rows it writes. Layer: kernels.

Bytes: ``k5_roofline.k5_bytes`` with the live slots n of the traced
run's start (``live_rows`` in its record, from ``drivers/fs1_mapped.py``)
in place of the L slots: the live landmark rows written once (5 n P
float32), the weights updated in place, and the poses, weights, bounds
and observations read once. A run's live count only grows, so n is a
lower bound for every call in it; the ancestors' rows K5 reads are not
counted. So the share is a lower bound on the work any correct K5 must
do, whether it copies the rows past n or skips them, and cannot pass
100 %. (``k5_roofline`` counts all L rows as written: on a cell with
most rows dead it would pass 100 % once a change skipped them.)"""

from pathlib import Path

from benchmark.peaks import hbm_bytes_per_s
from benchmark.run import load_module
from benchmark.tracing import kernel

K5 = load_module(Path(__file__).with_name("k5_roofline.py"))
NAME = K5.NAME


def read(ctx):
    hit = kernel(ctx["trace"], NAME) if ctx["trace"] else None
    bw = hbm_bytes_per_s(ctx["device_kind"])
    live = [u["live_rows"] for u in ctx["units"] if "live_rows" in u]
    if not hit or not bw or not live:
        return None
    s = ctx["shapes"]
    seconds, calls = hit
    return (100.0 * K5.k5_bytes(s["P"], live[0], s["K"]) / bw
            / (seconds / calls))
