"""train_stamp_ms: the program's host spans ``train.stamp``
(``TrainProgram._graph_step``: the stamp walk over the frozen and written
tensors, the version bumps after the replay), per traced step."""
from port_bench.lib.program_spans import per_unit_ms


def read(rec, ctx):
    return per_unit_ms(rec, "train.stamp")
