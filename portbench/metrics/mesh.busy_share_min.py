"""mesh.busy_share_min: the busy share of the least busy card over the
traced window once its queue is full (``lib/trace.steady``): the union of
its kernels' and copies' intervals, as ``lib/trace.busy_us`` reckons it, in
percent; none on one card."""
from portbench.lib import trace


def read(ctx):
    ops = getattr(ctx, "ops", None)
    if not ops or len(ctx.devices) < 2:
        return None
    lo, hi = ctx.steady_us
    return 100.0 * min(trace.busy_us(ops, d, lo, hi) for d in ctx.devices) / (hi - lo)
