"""device.idle_share: the share of the traced window, once its queue is full
(``lib/trace.steady``), in which no kernel or copy ran on a card (the union
of the profiler's device intervals), the mean over the cards, in percent."""
from portbench.lib import trace


def read(ctx):
    ops = getattr(ctx, "ops", None)
    if not ops:
        return None
    lo, hi = ctx.steady_us
    busy = [trace.busy_us(ops, d, lo, hi) / (hi - lo) for d in ctx.devices]
    return 100.0 * (1.0 - sum(busy) / len(busy))
