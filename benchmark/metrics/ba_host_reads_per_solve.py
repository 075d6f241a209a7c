"""ba_host_reads_per_solve (program counter): device-to-host reads per
BA solve in the window, ``info["host_reads"]`` of ``solve_ba_sharded``
(the plan's, the first cost's, one per trial). Layer: BA (posegraph/)."""


def read(ctx):
    units = ctx["units"]
    return sum(u["host_reads"] for u in units) / len(units)
