"""decode_ms: the device time of the program's span ``sample.decode``
(``decode_latents``: the whole-video VAE decode), per traced request."""
from port_bench.lib.program_spans import per_unit_ms


def read(rec, ctx):
    return per_unit_ms(rec, "sample.decode", device=True)
