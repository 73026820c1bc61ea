"""train_forward_ms: the device time of the train step's phase
``train.forward`` (timing events inside the captured graph: the UNet forward
and the loss), per traced step."""
from port_bench.lib.program_spans import per_unit_ms


def read(rec, ctx):
    return per_unit_ms(rec, "train.forward", device=True)
