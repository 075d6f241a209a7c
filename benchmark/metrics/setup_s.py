"""setup_s (host clock): seconds from the harness's start to the end of
its warm-up: imports, the kernel library, the inputs from the seed, and
one pass over every path the window takes. Every cell."""


def read(ctx):
    return ctx["setup_s"]
