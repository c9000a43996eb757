"""Binned tile rasterizer (port of ``ops/rasterizer_tiled.py``, opaque mode).

1. ``bin_triangles``: per-triangle screen bbox -> covered range of 8x128-pixel
   tiles; one entry per (triangle, tile), enumerated with repeat_interleave,
   stable-sorted by tile (so each tile's entries stay in triangle-id order)
   and cut into per-tile ranges with searchsorted.  Culling matches the
   reference: non-degenerate and some w > eps, then front-facing, then
   on-screen.  Buffers are sized by the true entry count (one host sync per
   frame), so binning can never overflow and the reference's static entry
   cap and NaN-poison guard have no counterpart here.
2. ``raster_tiles`` (K1a): the tile depth test, hand-written CUDA
   (csrc/raster_tile.cu) on the GPU; ``raster_tiles_plain`` is the same
   function in plain PyTorch, used for CPU tensors and as the kernel's
   reference on the card.

The winner per pixel is the lexicographic max of (reverse-Z depth, triangle
id), which is what the reference kernel's chunked merge computes.  The
alpha depth-peel (K1b / K1c) and MSAA samples (K1d) are not ported yet
(ROADMAP items 10 and 14).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Any

import torch

from vulkanhybridrenderer_tpu_torch.ops.rasterizer import (
    TriangleSetup,
    VisibilityBuffer,
    triangle_setup,
)

TILE_H = 8
TILE_W = 128


@dataclasses.dataclass(frozen=True)
class Bins:
    entry_tri: Any  # (E,) int32 triangle id per entry, tile-major
    offsets: Any  # (ntiles + 1,) int32 start of each tile's entries
    ntx: int
    nty: int


def _tile_counts(width: int, height: int):
    return math.ceil(width / TILE_W), math.ceil(height / TILE_H)


def bin_triangles(setup: TriangleSetup, width: int, height: int,
                  cull_backface: bool = True) -> Bins:
    ntx, nty = _tile_counts(width, height)
    ntiles = ntx * nty
    dev = setup.planes.device
    alive = setup.valid & setup.w_any
    if cull_backface:
        alive &= setup.front
    xmin, ymin, xmax, ymax = setup.bbox.unbind(-1)
    alive &= (xmax > 0) & (xmin < width) & (ymax > 0) & (ymin < height)

    def tile_index(v, size, n):
        # clamp in float first: bboxes of camera-crossing triangles reach
        # +-1e30, past int32
        return torch.clamp(torch.floor(v / size), 0, n - 1).to(torch.int64)

    tx0 = tile_index(xmin, TILE_W, ntx)
    tx1 = tile_index(xmax, TILE_W, ntx)
    ty0 = tile_index(ymin, TILE_H, nty)
    ty1 = tile_index(ymax, TILE_H, nty)
    wspan = tx1 - tx0 + 1
    span = torch.where(alive, wspan * (ty1 - ty0 + 1), 0)

    tri_of = torch.repeat_interleave(
        torch.arange(span.shape[0], device=dev), span
    )  # (E,) owning triangle per entry (one host sync for E)
    starts = torch.cumsum(span, 0) - span
    k = torch.arange(tri_of.shape[0], device=dev) - starts[tri_of]
    ws = wspan[tri_of]
    tile = (ty0 * ntx + tx0)[tri_of] + torch.div(k, ws, rounding_mode="floor") * ntx + (k % ws)
    tile_sorted, perm = torch.sort(tile, stable=True)
    offsets = torch.searchsorted(
        tile_sorted, torch.arange(ntiles + 1, device=dev)
    )
    return Bins(
        entry_tri=tri_of[perm].to(torch.int32).contiguous(),
        offsets=offsets.to(torch.int32).contiguous(),
        ntx=ntx, nty=nty,
    )


def raster_tiles_plain(planes, bins: Bins, width: int, height: int,
                       chunk: int = 2048) -> VisibilityBuffer:
    """Plain PyTorch K1a: every entry against every pixel of its tile, in
    chunks of entries; per pixel the lexicographic max of (z, id) wins."""
    dev = planes.device
    npx = TILE_W * TILE_H
    hp, wp = bins.nty * TILE_H, bins.ntx * TILE_W  # tile-padded image
    counts = bins.offsets[1:] - bins.offsets[:-1]
    tile_of = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=dev), counts.long()
    )
    local = torch.arange(npx, device=dev)
    lx = (local % TILE_W).to(torch.float32)
    ly = (local // TILE_W).to(torch.float32)

    best_key = torch.full((hp * wp,), -1, dtype=torch.int64, device=dev)
    best_val = torch.zeros((hp * wp, 4), dtype=torch.float32, device=dev)
    best_val[:, 3] = 1.0
    for s in range(0, bins.entry_tri.shape[0], chunk):
        ids = bins.entry_tri[s:s + chunk].long()
        tl = tile_of[s:s + chunk]
        tx = (tl % bins.ntx) * TILE_W
        ty = torch.div(tl, bins.ntx, rounding_mode="floor") * TILE_H
        px = lx[None, :] + tx.to(torch.float32)[:, None] + 0.5  # (C, npx)
        py = ly[None, :] + ty.to(torch.float32)[:, None] + 0.5
        p = planes[ids]  # (C, 12)

        def plane(k):
            return px * p[:, k, None] + py * p[:, k + 1, None] + p[:, k + 2, None]

        l0, l1, l2, z = plane(0), plane(3), plane(6), plane(9)
        covered = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & (z >= 0) & (z <= 1)
        # (z, id) as one int64 key: z >= 0 here, so its float bits order
        # like the value (+0.0 folds -0.0, which compares equal to it)
        zbits = (z + 0.0).view(torch.int32).to(torch.int64)
        key = torch.where(covered, (zbits << 32) | ids[:, None], -1)
        pix = ((ty[:, None] + (local // TILE_W)[None, :]) * wp
               + tx[:, None] + (local % TILE_W)[None, :])
        chunk_best = torch.full_like(best_key, -1).scatter_reduce(
            0, pix.reshape(-1), key.reshape(-1), reduce="amax"
        )
        win = covered & (key == chunk_best[pix]) & (key > best_key[pix])
        vals = torch.stack([z, l1, l2, l0 + l1 + l2], dim=-1)[win]
        best_val[pix[win]] = vals
        best_key = torch.maximum(best_key, chunk_best)

    best_id = torch.where(best_key >= 0, best_key & 0xFFFFFFFF, -1)
    img = lambda a: a.reshape(hp, wp, *a.shape[1:])[:height, :width]  # noqa: E731
    val = img(best_val)
    return VisibilityBuffer(
        tri_id=img(best_id).to(torch.int32).contiguous(),
        depth=val[..., 0].contiguous(),
        bary=val[..., 1:].contiguous(),
    )


@functools.cache
def load_kernel():
    """Build K1a (on first use) and load it; returns its launch function."""
    from vulkanhybridrenderer_tpu_torch.utils.build import load_cuda_library

    lib = load_cuda_library("raster_tile.cu")
    fn = lib.raster_tile_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4
    )
    return fn


def raster_tiles(planes, bins: Bins, width: int, height: int) -> VisibilityBuffer:
    """K1a.  planes: (T, 12) float32 (triangle_setup); bins from
    bin_triangles.  CPU tensors run raster_tiles_plain; CUDA tensors launch
    csrc/raster_tile.cu or raise."""
    if planes.device.type == "cpu":
        return raster_tiles_plain(planes, bins, width, height)
    if planes.device.type != "cuda":
        raise ValueError(f"raster_tiles: unsupported device {planes.device}")
    for name, t, dt in (("planes", planes, torch.float32),
                        ("entry_tri", bins.entry_tri, torch.int32),
                        ("offsets", bins.offsets, torch.int32)):
        if t.device != planes.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"raster_tiles: {name} must be a contiguous {dt} tensor on "
                f"{planes.device}, got {t.dtype} on {t.device}"
            )
    if planes.dim() != 2 or planes.shape[1] != 12:
        raise ValueError(f"raster_tiles: planes must be (T, 12), got {tuple(planes.shape)}")
    if bins.offsets.shape[0] != bins.ntx * bins.nty + 1:
        raise ValueError("raster_tiles: offsets do not match the tile grid")
    if (bins.ntx, bins.nty) != _tile_counts(width, height):
        raise ValueError("raster_tiles: bins were made for another image size")
    fn = load_kernel()
    dev = planes.device
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    tri = torch.empty((height, width), dtype=torch.int32, device=dev)
    bary = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            planes.data_ptr(), bins.entry_tri.data_ptr(), bins.offsets.data_ptr(),
            TILE_W, TILE_H, bins.ntx, bins.nty, width, height,
            depth.data_ptr(), tri.data_ptr(), bary.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"raster_tile kernel launch failed: CUDA error {err}")
    raster_tiles.launches += 1
    return VisibilityBuffer(tri_id=tri, depth=depth, bary=bary)


raster_tiles.launches = 0


def rasterize_scene(scene, clip, width: int, height: int,
                    cull_backface: bool = True) -> VisibilityBuffer:
    """Full-scene visibility buffer: setup, binning, K1a.  Alpha-masked
    triangles raster solid (alpha_raster="off")."""
    setup = triangle_setup(clip, scene.tri_vertex, width, height)
    bins = bin_triangles(setup, width, height, cull_backface=cull_backface)
    return raster_tiles(setup.planes, bins, width, height)
