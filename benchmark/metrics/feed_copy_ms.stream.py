"""Program span: device ms a traced feed in `stream.upload` and
`stream.download` (the window's copy to the card and the output's copy
back, each between its own entry and exit events, so the pageable
staging and the cost of those two events are in), over the `stream.feed`
spans."""
from benchmark.harness.spans import per_unit, records


def read(rec):
    return per_unit(records(), "stream.feed",
                    ("stream.upload", "stream.download"), "device")
