"""Live atoms of every step completed in the window, over the window's
seconds (host clock, from the first timed dispatch to the synchronise
after the last step)."""


def read(ctx):
    return ctx.shapes["nodes"] * ctx.steps / ctx.window_s
