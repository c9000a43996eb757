"""Half-resolution ray tracing: point downsample and joint-bilateral
upsample (port of ``ops/upsample.py``).

``HybridSettings.rt_scale = s`` traces shadows, AO and reflections on a
1/s-resolution G-buffer (1/s^2 the rays) and upsamples the (denoised)
results, weighted by the full-resolution G-buffer.  rt_scale = 1 is the
reference's behaviour; the knob trades quality for time and never changes
what a pass means.

The upsample blends each full-resolution pixel's 4 nearest low-resolution
taps with weights = bilinear footprint x object-id match x normal
alignment^32 x relative depth closeness, and falls back to plain bilinear
where no tap matches.
"""
from __future__ import annotations

import torch

from vulkanhybridrenderer_tpu_torch.utils.math3d import div

NORMAL_POW = 32
DEPTH_REL_SIGMA = 0.1  # relative reverse-Z tolerance


def downsample_nearest(img, scale: int):
    """(..., H, W) -> (..., ceil(H/s), ceil(W/s)) by top-left point sampling:
    every low-resolution texel is a real surface sample."""
    if scale == 1:
        return img
    return img[..., ::scale, ::scale].contiguous()


def _tap_indices(n_hi: int, n_lo: int, scale: int, device="cpu"):
    """Bilinear footprint of full-resolution row / column i on the low-
    resolution grid: (i0, i1, frac) with i0 and i1 clamped to [0, n_lo-1]."""
    f = div(torch.arange(n_hi, dtype=torch.float32, device=device) + 0.5, scale) - 0.5
    i0 = torch.floor(f)
    frac = f - i0
    i0i = torch.clamp(i0.to(torch.int64), 0, n_lo - 1)
    i1i = torch.clamp(i0i + 1, 0, n_lo - 1)
    return i0i, i1i, frac


def joint_bilateral_upsample(lo, scale: int, depth_hi, normal_oid_hi, depth_lo,
                             normal_oid_lo):
    """lo (C, hs, ws) -> (C, H, W), weighted by the full-resolution depth
    (H, W) and normals + object id (4, H, W), and the low-resolution depth
    and normals the trace used."""
    if scale == 1:
        return lo
    h, w = depth_hi.shape
    hs, ws = depth_lo.shape
    dev = lo.device
    y0, y1, fy = _tap_indices(h, hs, scale, dev)
    x0, x1, fx = _tap_indices(w, ws, scale, dev)
    wy = [(1.0 - fy)[:, None], fy[:, None]]  # (H, 1)
    wx = [(1.0 - fx)[None, :], fx[None, :]]  # (1, W)
    ys, xs = [y0, y1], [x0, x1]
    n_hi = normal_oid_hi[:3]
    oid_hi = normal_oid_hi[3]
    # the depth term's denominator, as the reference computes it
    z_den = DEPTH_REL_SIGMA * torch.clamp(depth_hi, min=1e-4)

    num = torch.zeros((lo.shape[0], h, w), dtype=lo.dtype, device=dev)
    den = torch.zeros((h, w), dtype=torch.float32, device=dev)
    num_b = torch.zeros_like(num)  # plain-bilinear fallback
    for a in range(2):
        for b in range(2):
            def take(img):
                return img[..., ys[a], :][..., xs[b]]

            w_bil = wy[a] * wx[b]  # (H, W)
            no_tap = take(normal_oid_lo)
            w_id = (no_tap[3] == oid_hi).to(torch.float32)
            ndot = torch.clamp(torch.sum(no_tap[:3] * n_hi, dim=0), min=0.0)
            w_n = ndot
            for _ in range(NORMAL_POW.bit_length() - 1):  # x^32 as XLA's squarings
                w_n = w_n * w_n
            w_z = torch.exp(-torch.abs(take(depth_lo) - depth_hi) / z_den)
            wt = w_bil * w_id * w_n * w_z
            v = take(lo)
            num = num + wt[None] * v
            den = den + wt
            num_b = num_b + w_bil[None] * v
    good = den > 1e-6
    return torch.where(good[None], num / torch.clamp(den, min=1e-6)[None], num_b)
