"""Device kernels in the traced window, over its steps (the profiler's
kernel events)."""


def read(ctx):
    if not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.steps
