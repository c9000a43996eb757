"""frame_ms_p95: the 95th percentile of every frame's interval between
consecutive frames' end events in the window."""
from portbench.lib import window


def read(ctx):
    intervals = getattr(ctx, "intervals_ms", None)
    return window.frame_ms_p95(intervals) if intervals else None
