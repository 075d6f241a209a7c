"""ba_trials_per_solve (program counter): Levenberg-Marquardt trials
(linear solves) per BA solve in the window, ``info["n_steps"]`` of
``solve_ba_sharded``. Layer: BA (posegraph/)."""


def read(ctx):
    units = ctx["units"]
    return sum(u["n_steps"] for u in units) / len(units)
