"""Arithmetic of the metric readers that read the program's spans: the
records `ml_audio_restoration_torch.utils.profiling.spans()` returns (name,
id, parent, host start and end in ns, counts, device start and end in ms,
None without a card and on the spans the program reads on the host's
clock). The program records spans only while a torch
profiler records, so after a `--trace 1` run they are the traced
stretch's. A program that keeps no spans, or a record without the spans a
reader needs, gives None: the metric is then left out.
"""
from __future__ import annotations

from collections import defaultdict


def records() -> list | None:
    """The program's span records, or None where it keeps none."""
    from ml_audio_restoration_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    return None if spans is None else spans()


def _interval(span: dict, clock: str):
    """(start, end) in ms on `clock` ("host" or "device"), or None."""
    if clock == "host":
        if span.get("end_ns") is None:
            return None
        return span["start_ns"] / 1e6, span["end_ns"] / 1e6
    if span.get("device_end_ms") is None:
        return None
    return span["device_start_ms"], span["device_end_ms"]


def self_ms(span: dict, children, clock: str) -> float | None:
    """The span's own ms on `clock`: its duration less the union of its
    children's intervals inside it (so nested spans are never counted
    twice). None where the span has no reading on that clock."""
    own = _interval(span, clock)
    if own is None:
        return None
    lo, hi = own
    parts = sorted((max(a, lo), min(b, hi)) for a, b in
                   filter(None, (_interval(c, clock) for c in children))
                   if min(b, hi) > max(a, lo))
    covered, end = 0.0, lo
    for a, b in parts:
        a = max(a, end)
        if b > a:
            covered += b - a
            end = b
    return (hi - lo) - covered


def per_unit(recs, unit: str, names, clock: str) -> float | None:
    """The self ms on `clock` of every span named in `names`, summed, over
    the number of `unit` spans (the cell's unit: a restore, a feed, a
    training step). None without a unit span, or where a named span has no
    reading on the clock (device ms on the CPU)."""
    if not recs:
        return None
    units = sum(1 for r in recs if r["name"] == unit)
    if not units:
        return None
    children = defaultdict(list)
    for r in recs:
        if r["parent"] is not None:
            children[r["parent"]].append(r)
    total = 0.0
    for r in recs:
        if r["name"] in names:
            ms = self_ms(r, children[r["id"]], clock)
            if ms is None:
                return None
            total += ms
    return total / units


def count_share(recs, unit: str, part: str, whole: str) -> float | None:
    """Sum of the `unit` spans' count `part` over their count `whole`, in %.
    None without a unit span that holds both counts."""
    found = [r["counts"] for r in recs or ()
             if r["name"] == unit and part in r["counts"]
             and whole in r["counts"]]
    den = sum(c[whole] for c in found)
    return 100.0 * sum(c[part] for c in found) / den if den else None
