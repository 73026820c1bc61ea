"""unet_epi_ms: the device time of the program's span ``unet.epi`` (the epi
modules) in a UNet call, per traced request: the request's last UNet call,
timed by marks that the captured graph keeps
(``utils/tracing.SublayerTimer``)."""
from port_bench.lib.program_spans import per_unit_ms


def read(rec, ctx):
    return per_unit_ms(rec, "unet.epi", device=True)
