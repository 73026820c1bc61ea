"""data_wait_ms: the harness's host clock around each draw from the
program's data loader, averaged over the window's steps."""


def read(rec, ctx):
    return rec.readings.get("data_wait_ms")
