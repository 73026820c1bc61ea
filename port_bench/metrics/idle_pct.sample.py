"""idle_pct.sample: the traced window's share of wall time in which no
kernel, copy or memset ran on the device: 100 x (1 - union of their
intervals / wall)."""
from port_bench.lib.readers import idle_pct


def read(rec, ctx):
    return idle_pct(rec)
