"""mfu.train: the reference's floating-point operations of the work
completed in the traced window (its stored count per unit) over the
window's wall time x 989 TFLOP/s (bf16)."""
from port_bench.lib.readers import mfu


def read(rec, ctx):
    return mfu(rec, ctx)
