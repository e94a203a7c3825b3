"""Host seconds of the program's data layer on the frame: its radius
graph, its triplets where the config asks, the padded batch and the copy
to the device (harness host clock around the program's calls)."""


def read(ctx):
    return ctx.frames_build_s
