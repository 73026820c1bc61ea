"""train_optimizer_ms: the device time of the train step's phase
``train.optimizer`` (timing events inside the captured graph: clipping,
AdamW, the results), per traced step."""
from port_bench.lib.program_spans import per_unit_ms


def read(rec, ctx):
    return per_unit_ms(rec, "train.optimizer", device=True)
