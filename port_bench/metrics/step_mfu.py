"""The whole step's share of the card's float32 peak: the algorithmic
flops of a step (``counts/<config>.py``: every contraction, forward and
backward, no recompute) times the traced steps, over the traced window
and 67 TFLOP/s, in percent.  The program computes exact float32."""


def read(ctx):
    if ctx.peaks is None:
        return None
    flops = ctx.counts.flops(ctx.config["args"], ctx.shapes) * ctx.steps
    return 100.0 * flops / ctx.trace.window_s / ctx.peaks["f32_flops"]
