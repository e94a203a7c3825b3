"""The share of the traced window in which no kernel, copy or fill ran on
the device, in percent."""


def read(ctx):
    if not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
