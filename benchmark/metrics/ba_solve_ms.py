"""ba_solve_ms (host clock): the window's wall over the BA solves that
completed in it, each ended by a device sync."""


def read(ctx):
    return ctx["wall_s"] / sum(u["solves"] for u in ctx["units"]) * 1e3
