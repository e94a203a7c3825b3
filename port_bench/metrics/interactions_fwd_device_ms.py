"""Device milliseconds a step of the kernels that ran inside the forward
of the config's ``interactions`` blocks (between the device markers the
benchmark's hooks launch around each block).  Fails, rather than reading
0, when the trace holds no range."""


def read(ctx):
    if not ctx.trace.kernels:
        return None
    kernels = ctx.trace.in_ranges()
    return sum(k.dur for k in kernels) / 1e3 / ctx.steps
