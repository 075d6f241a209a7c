"""ticks_per_s (host clock): control ticks of the runs that completed in
the window over the window's wall, each run ended by a device sync; for
config #5 composed a run includes its problem and BA solve."""


def read(ctx):
    return sum(u["ticks"] for u in ctx["units"]) / ctx["wall_s"]
