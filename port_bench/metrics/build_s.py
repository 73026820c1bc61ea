"""build_s: the harness's synced host clock around building the program's
modules and loading the run's seeded weights into them."""


def read(rec, ctx):
    return rec.readings.get("build_s")
