"""The port's hand kernels, by the CUDA names the profiler gives their
launches (``vulkanhybridrenderer_tpu_torch/csrc``).  Every other device
operation of a frame is plain PyTorch: ATen's kernels and copies."""
from __future__ import annotations

HAND = {
    "K1": ("raster_tile_kernel", "raster_tile_msaa_kernel"),
    "K2": ("bvh8_trace_kernel", "bvh8_trace_packed"),
    "K3": ("shadow_grid_trace_kernel",),
    "K4": ("bvh_flat_trace_kernel",),
}


def kernel_of(name: str) -> str | None:
    """Which hand kernel a device operation's name is, if any."""
    for k, names in HAND.items():
        if any(n in name for n in names):
            return k
    return None


def device_ms(ops, lo: float, hi: float, pick) -> float:
    """Device milliseconds of the operations in [lo, hi] (microseconds) that
    `pick(name)` selects, summed over the cards."""
    return sum(min(o.end, hi) - max(o.start, lo) for o in ops
               if o.end > lo and o.start < hi and pick(o.name)) / 1e3
