"""ba_wall_share (program span): ``Config5Result.ba_seconds``, BA's wall
ended by a device sync, summed over the window's runs, as a share (%)
of those runs' walls. Layer: entry (runtime/config5.py)."""


def read(ctx):
    units = ctx["units"]
    return 100.0 * sum(u["ba_s"] for u in units) / sum(
        u["wall_s"] for u in units)
