"""train_fill_ms: the program's host span ``train.fill``
(``TrainProgram._fill``: the batch pinned and its copy to the graph's
buffers enqueued), per traced step."""
from port_bench.lib.program_spans import per_unit_ms


def read(rec, ctx):
    return per_unit_ms(rec, "train.fill")
