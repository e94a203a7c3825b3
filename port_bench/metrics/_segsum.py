"""What the two roofline readers of the segment-sum kernels share.

K3 and K4 launch the same device functions (``segsum_*``), so the name
alone cannot tell them apart: where the config's counts say
``K3_IN_INTERACTIONS``, the family's kernels that ran inside the
``interactions`` forward ranges are K3 (the triplet fold) and the rest
K4; elsewhere all are K4.  A roofline share is the least time of the
calls the counts list (their bytes at the card's HBM rate: data, ids and
mask read once, the accumulator read once, the sums written once) over
the kernels' device time, in percent; None without a kernel, a call or
a peak."""

FAMILY = "segsum_"


def call_bytes(rows, width, segments, mask, acc) -> float:
    return (rows * width * 4 + rows * 4 + (rows if mask else 0)
            + segments * width * 4 * (2 if acc else 1))


def kernels(ctx, which: str) -> list:
    family = [k for k in ctx.trace.kernels if FAMILY in k.name]
    if not family or not getattr(ctx.counts, "K3_IN_INTERACTIONS", False):
        return family if which == "k4" else []
    inside = {id(k) for k in ctx.trace.in_ranges()}
    return [k for k in family if (id(k) in inside) == (which == "k3")]


def roofline(ctx, which: str):
    calls = getattr(ctx.counts, f"{which}_calls")(ctx.config["args"],
                                                  ctx.shapes)
    ks = kernels(ctx, which)
    if not calls or not ks or ctx.peaks is None:
        return None
    least = (sum(call_bytes(*c) for c in calls) * ctx.steps
             / ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * least / (sum(k.dur for k in ks) * 1e-6)
