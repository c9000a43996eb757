"""Reduce a ``torch.profiler`` trace of the traced window to numbers.

A device operation is a kernel, copy or set that the profiler saw run on a
card (its CUPTI activity), with the card's index and its start and end in
microseconds on the trace's clock; a host span is a ``record_function``
range of the benchmark's own loop (``portbench.<what>``) on the same clock.
The busy share of a card is the union of its operations' intervals over the
window (as ``probes/mesh_turns.py`` reckons it); an idle gap is a stretch
of the window in which no operation ran on the card, named by the host
span the loop was in when it began.
"""
from __future__ import annotations

import collections
import dataclasses

SPAN_PREFIX = "portbench."


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    device: int
    start: float  # microseconds
    end: float


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start: float
    end: float


def from_profiler(prof) -> tuple[list[Op], list[Span]]:
    """The device operations and the benchmark's host spans of a finished
    ``torch.profiler.profile``."""
    ops, spans = [], []
    for e in prof.events():
        kind = e.device_type.name
        if e.name.startswith(SPAN_PREFIX) and kind != "CPU":
            continue  # the profiler's device-side copy of a host span: no work
        if kind == "CUDA":
            ops.append(Op(e.name, int(e.device_index), float(e.time_range.start),
                          float(e.time_range.end)))
        elif kind == "CPU" and e.name.startswith(SPAN_PREFIX):
            spans.append(Span(e.name[len(SPAN_PREFIX):], float(e.time_range.start),
                              float(e.time_range.end)))
    return ops, spans


def merged(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def busy_us(ops: list[Op], device: int, lo: float, hi: float) -> float:
    """Microseconds of [lo, hi] in which some operation ran on `device`."""
    return sum(b - a for a, b in clip(merged((o.start, o.end) for o in ops
                                             if o.device == device), lo, hi))


def window(spans: list[Span], ops=(), name: str = "window") -> tuple[float, float]:
    """The traced window: the host span the loop wraps around its frames
    and the final wait for the device, from the first device operation in
    it (the profiler starts with the queue empty: the gap while the host
    submits the first frame is the trace's, not the loop's)."""
    found = [s for s in spans if s.name == name]
    if len(found) != 1:
        raise ValueError(f"expected one {name!r} span, found {len(found)}")
    lo, hi = found[0].start, found[0].end
    first = [o.start for o in ops if lo <= o.start < hi]
    return (min(first) if first else lo), hi


def steady(spans: list[Span], ops, window_us, after: int) -> tuple[float, float]:
    """The part of the traced window in which the queue is full: from the
    first device operation that starts once the host has ended its
    `after`-th submit in the window (with the profiler on, a submit takes
    longer than with it off, so the first frames can leave the card idle
    while the host queues them)."""
    lo, hi = window_us
    ends = sorted(s.end for s in spans if s.name == "submit" and lo <= s.end <= hi)
    if after < 1 or len(ends) < after:
        return lo, hi
    later = [o.start for o in ops if ends[after - 1] <= o.start < hi]
    return (min(later) if later else lo), hi


def gaps(ops: list[Op], device: int, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] in which nothing ran on `device`."""
    out, reach = [], lo
    for a, b in clip(merged((o.start, o.end) for o in ops if o.device == device), lo, hi):
        if a > reach:
            out.append((reach, a))
        reach = max(reach, b)
    if hi > reach:
        out.append((reach, hi))
    return out


def label(spans: list[Span], t: float) -> str:
    """The innermost benchmark span that holds time t, else "host"."""
    inner = [s for s in spans if s.start <= t < s.end and s.name != "window"]
    if not inner:
        return "host"
    return min(inner, key=lambda s: s.end - s.start).name


def idle_gaps(ops, spans, devices, lo, hi, n: int = 10) -> list[list]:
    """The n longest idle gaps over `devices`, each [what the host was
    doing, on which card, seconds]."""
    found = []
    for d in devices:
        for a, b in gaps(ops, d, lo, hi):
            found.append((b - a, f"{label(spans, a)} (cuda:{d})"))
    found.sort(key=lambda g: -g[0])
    return [[name, us / 1e6] for us, name in found[:n]]


def top_ops(ops: list[Op], n: int = 10) -> list[list]:
    """The n device operations that took most time, by name, summed over
    the cards: [name, seconds]."""
    total: collections.Counter = collections.Counter()
    for o in ops:
        total[o.name] += o.end - o.start
    return [[name[:200], us / 1e6] for name, us in total.most_common(n)]
