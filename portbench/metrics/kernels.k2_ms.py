"""kernels.k2_ms: device milliseconds a frame of K2's launches (BVH8
traversal), summed over the cards, from the trace; none where the frame
launches no K2."""
from portbench.lib import kernels


def read(ctx):
    ops = getattr(ctx, "ops", None)
    if not ops:
        return None
    lo, hi = ctx.window_us
    ms = kernels.device_ms(ops, lo, hi, lambda n: kernels.kernel_of(n) == "K2")
    return ms / ctx.frames if ms > 0 else None
