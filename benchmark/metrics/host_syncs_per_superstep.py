"""host_syncs_per_superstep (program counter): the particle filter's
device-to-host reads (``rbpf.host_bool.count``, the resample gate and
the new-feature gate) over the window, per superstep.
Layer: entry (runtime/loop.py, the gate in models/rbpf.py)."""


def read(ctx):
    steps = sum(u["supersteps"] for u in ctx["units"])
    return ctx["counters"]["host_bool"] / steps
