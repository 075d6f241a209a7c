"""Idle share (device trace), %: 100 (1 - device busy time / the wall of
the traced sub-window), busy time the union of the device operations'
intervals. Layer: device."""


def read(ctx):
    trace = ctx["trace"]
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
