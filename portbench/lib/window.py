"""The measured window's arithmetic, from the device's clock.

Every frame of the window records a CUDA event on the frame's stream after
its ``render_frame`` (over a mesh, on the primary after the join), and the
window starts with an event recorded before the first frame is submitted.
A frame's interval is the time from the previous frame's end event (the
window's start event for the first) to its own.  So the intervals add up to
the whole window, from the first submission to the last frame's end.
"""
from __future__ import annotations

import math


def intervals_ms(start_ms: float, end_ms: list[float]) -> list[float]:
    """Each frame's interval from the end times of the window's frames, in
    order, and the time the window started, all on one clock."""
    out, last = [], start_ms
    for t in end_ms:
        out.append(t - last)
        last = t
    return out


def frame_ms(intervals: list[float]) -> float:
    """All the window's time over all its frames."""
    if not intervals:
        raise ValueError("a window of no frames")
    return sum(intervals) / len(intervals)


def percentile(values: list[float], q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value that at least
    q% of the values do not exceed."""
    if not values:
        raise ValueError("a percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def frame_ms_p95(intervals: list[float]) -> float:
    """The 95th percentile of every frame's interval in the window."""
    return percentile(intervals, 95.0)
