"""Host ms a step spent waiting in the data loader's `__next__` over the
untraced window (timed around the port's iterator)."""


def read(rec):
    if rec["trace"] is None:
        return None
    steps = sum(u["steps"] for u in rec["units"])
    return 1e3 * sum(u["loader_wait_s"] for u in rec["units"]) / steps
