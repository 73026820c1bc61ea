"""unet_call_ms: the mean time of a UNet call in the window, from the
sampler's own span timer (CUDA events around each replay, per call)."""


def read(rec, ctx):
    return rec.readings.get("unet_call_ms")
