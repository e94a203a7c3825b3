"""``torch.cuda.max_memory_allocated()`` over set-up, the checked and warm
steps and the window, in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30
