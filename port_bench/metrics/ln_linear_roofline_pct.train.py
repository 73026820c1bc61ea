"""ln_linear_roofline_pct.train: the least time of the reference's LayerNorm
+ Linear pairs (family kernels/ln_linear.json) in the traced window,
max(FLOPs / 989 T, bytes / 3.35 TB/s) per op, over the device time of the
family's kernels there."""
from port_bench.lib.readers import roofline


def read(rec, ctx):
    return roofline(rec, ctx, "ln_linear")
