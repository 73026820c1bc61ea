"""train_backward_ms: the device time of the train step's phase
``train.backward`` (timing events inside the captured graph:
``loss.backward()``), per traced step."""
from port_bench.lib.program_spans import per_unit_ms


def read(rec, ctx):
    return per_unit_ms(rec, "train.backward", device=True)
