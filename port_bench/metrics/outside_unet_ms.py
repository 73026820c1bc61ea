"""outside_unet_ms: per request, the harness's synced host clock around the
whole request (pose files to uint8 videos on the host) less the sum of its
UNet calls' spans; the mean over the window's requests. The request path
around the replays: pose conditioning, text and pose encoders, buffer
copies, VAE decode, copy to the host."""


def read(rec, ctx):
    return rec.readings.get("outside_unet_ms")
