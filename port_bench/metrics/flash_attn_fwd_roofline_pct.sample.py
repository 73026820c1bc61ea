"""flash_attn_fwd_roofline_pct.sample: the least time of the reference's
epi and spatial self-attentions that K1 / K2 compute (family
kernels/flash_attn_fwd.json) over the device time of that kernel."""
from port_bench.lib.readers import roofline


def read(rec, ctx):
    return roofline(rec, ctx, "flash_attn_fwd")
