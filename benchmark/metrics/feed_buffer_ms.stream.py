"""Program span: host ms a traced feed in `stream.buffer` (the numpy work
on the host: the feed's concatenate, each window's slice and pad, the
history trim, the outputs' concatenate), over the `stream.feed` spans."""
from benchmark.harness.spans import per_unit, records


def read(rec):
    return per_unit(records(), "stream.feed", ("stream.buffer",), "host")
