"""flash_attn_bwd_roofline_pct.train: the least time of the backward of the
reference's attentions that K6 computes (family kernels/flash_attn_bwd.json)
over the device time of its kernels (delta, dq, dkdv)."""
from port_bench.lib.readers import roofline


def read(rec, ctx):
    return roofline(rec, ctx, "flash_attn_bwd")
