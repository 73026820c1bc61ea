"""capture_s: the program's own count of the seconds its warm-ups and CUDA
graph captures took during set-up (``stats["capture_s"]``)."""


def read(rec, ctx):
    return rec.readings.get("capture_s")
