"""train_encode_ms: the device time of the train step's phase ``train.encode``
(timing events inside the captured graph: the gradients' zeroing, the VAE
encode, noise, add_noise, CLIP, the pose encoder), per traced step."""
from port_bench.lib.program_spans import per_unit_ms


def read(rec, ctx):
    return per_unit_ms(rec, "train.encode", device=True)
