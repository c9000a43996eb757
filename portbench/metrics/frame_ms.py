"""frame_ms: all the window's time over all its frames (device clock)."""
from portbench.lib import window


def read(ctx):
    intervals = getattr(ctx, "intervals_ms", None)
    return window.frame_ms(intervals) if intervals else None
