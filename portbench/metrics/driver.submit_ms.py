"""driver.submit_ms: host milliseconds inside each ``render_frame(sync=False)``
call, the mean over as many frames as the traced window has, run just before
it with the profiler off: the benchmark's own clock around the call."""


def read(ctx):
    ms = getattr(ctx, "submit_ms", None)
    return sum(ms) / len(ms) if ms else None
