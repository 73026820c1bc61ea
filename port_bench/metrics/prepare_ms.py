"""prepare_ms: the device time of the program's span ``sample.prepare`` (the
sampler's ``_prepare``: CLIP, the pose encoder, the initial latents), per
traced request."""
from port_bench.lib.program_spans import per_unit_ms


def read(rec, ctx):
    return per_unit_ms(rec, "sample.prepare", device=True)
