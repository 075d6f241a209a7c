"""device_ops_per_superstep (device trace): kernels, copies and sets the
profiler saw on the device over the traced sub-window, per superstep.
Layer: simulator and estimator (sim/, models/)."""


def read(ctx):
    trace = ctx["trace"]
    return trace["n_device_ops"] / trace["n"] if trace else None
