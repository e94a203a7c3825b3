"""K4 (``csrc/sorted_segsum.cu`` behind ``ops/scatter.segment_sum``):
its calls' least time at the HBM rate over its kernels' device time, in
percent (``_segsum.py``).  The CSR route's device sort is not K4's."""

from port_bench.metrics._segsum import roofline


def read(ctx):
    return roofline(ctx, "k4")
