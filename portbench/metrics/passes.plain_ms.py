"""passes.plain_ms: device milliseconds a frame of every device operation
that is not a hand kernel (K1-K4), summed over the cards, from the trace."""
from portbench.lib import kernels


def read(ctx):
    ops = getattr(ctx, "ops", None)
    if not ops:
        return None
    lo, hi = ctx.window_us
    return kernels.device_ms(ops, lo, hi, lambda n: kernels.kernel_of(n) is None) / ctx.frames
