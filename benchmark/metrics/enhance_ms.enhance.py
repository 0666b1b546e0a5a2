"""Program spans: device ms a traced restore in the enhancer stage, the
self time of `restore.enhance` and of every span inside it
(`enhance.spec`, `enhance.bands`, `enhance.time`, `enhance.band`), over
the `restore` spans."""
from benchmark.harness.spans import per_unit, records

SPANS = ("restore.enhance", "enhance.spec", "enhance.bands", "enhance.time",
         "enhance.band")


def read(rec):
    return per_unit(records(), "restore", SPANS, "device")
