"""pose_cond_ms: the program's host span ``data.pose_conditioning``
(``ValRealEstate10KPoseFolded.__getitem__``: the pose files to Plucker rays
and F matrices, NumPy), per traced request."""
from port_bench.lib.program_spans import per_unit_ms


def read(rec, ctx):
    return per_unit_ms(rec, "data.pose_conditioning")
