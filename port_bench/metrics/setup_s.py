"""Seconds from the process's start (the entry module's first line) to
the first timed step: imports, CUDA and the kernels' load or build, the
frame, the data layer, the model, the drawn weights, the checked and warm
steps."""


def read(ctx):
    return ctx.setup_s
