"""K3, the triplet fold (``sorted_fold`` over ``ascending_plan``): its
calls' least time at the HBM rate over its kernels' device time, in
percent (``_segsum.py``)."""

from port_bench.metrics._segsum import roofline


def read(ctx):
    return roofline(ctx, "k3")
