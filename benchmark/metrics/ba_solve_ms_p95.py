"""ba_solve_ms_p95 (host clock): the 95th percentile of the latencies of
the BA solves in the window, each from its call to the device sync that
ends it; the solves inside the profiled sub-window are left out. Layer:
BA (posegraph/)."""

import statistics


def read(ctx):
    lat = [u["wall_s"] * 1e3 for u in ctx["units"] if not u["traced"]]
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
