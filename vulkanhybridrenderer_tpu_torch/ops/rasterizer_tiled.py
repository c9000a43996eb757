"""Binned tile rasterizer (port of ``ops/rasterizer_tiled.py``).

1. ``bin_triangles``: per-triangle screen bbox -> covered range of 8x128-pixel
   tiles; one entry per (triangle, tile), enumerated into buffers of the
   reference's static size (``default_e_cap``; the alpha stream's
   max(8192, 8 A)): entry e belongs to the triangle whose cumulative span
   first passes e (searchsorted), entries past the true count get the
   sentinel tile and sort last, and a stable sort by tile (each tile's
   entries stay in triangle-id order) is cut into per-tile ranges with
   searchsorted.  The live count is ``offsets[-1]``, on the device: binning
   never waits for the host.  Entries past the cap are dropped, as the
   reference's are, and counted in ``Bins.overflow``; ``rasterize_scene``
   and ``rasterize_scene_msaa`` then NaN-poison the depth on the device and
   ``Renderer.check_binning`` raises on the first frame.  Culling matches
   the reference: non-degenerate and some w > eps, then front-facing, then
   on-screen, then the caller's include mask (the opaque and alpha-masked
   streams).  Entries keep GLOBAL triangle ids in both streams.
2. The tile depth test, hand-written CUDA (csrc/raster_tile.cu) on the GPU, in
   four modes: ``raster_tiles`` (K1a, every tile), ``raster_tiles_peel``
   (K1b, every tile under a per-pixel (z, id) depth-peel bound),
   ``raster_tiles_compact`` (K1c, K1b over a list of tiles) and
   ``raster_tiles_msaa`` (K1d, K1a at the 2, 4 or 8 standard sample positions
   in one pass).  ``raster_tiles_plain`` is the same function in plain
   PyTorch, used for CPU tensors and as the kernels' reference on the card.
   The kernels skip every (entry, 8x4 sub-tile) pair that an exact corner
   test proves empty; ``subtile_masks`` is that test in plain PyTorch (for
   the bound and the tests, not the render path).
3. ``rasterize_alpha_peeled``: the alpha-masked stream by depth peeling, and
   ``rasterize_scene``, which merges it over the opaque stream;
   ``rasterize_scene_msaa`` does both per sample position.

The winner per pixel is the lexicographic max of (reverse-Z depth, triangle
id), which is what the reference kernel's chunked merge computes.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Any

import torch

from vulkanhybridrenderer_tpu_torch.ops import shadetab
from vulkanhybridrenderer_tpu_torch.ops.rasterizer import (
    TriangleSetup,
    VisibilityBuffer,
    triangle_setup,
    weights_from_bary,
)

TILE_H = 8
TILE_W = 128
#: the sub-tile of csrc/raster_tile.cu's culling: 16 x 2 of them make a
#: tile, one bit each of an entry's sub-tile mask (bit 16 * (y // 4) + x // 8
#: of the tile's local pixel (x, y))
SUB_W, SUB_H = 8, 4
N_SUBTILES = (TILE_W // SUB_W) * (TILE_H // SUB_H)
#: the reference's "big" (rasterize_alpha_peeled): the round-1 bound admits
#: every fragment, a -BIG bound admits none
BIG = 3.4e38
_INT32_MAX = 2**31 - 1
#: the standard Vulkan sample positions (VkSpec "Multisampling"), offsets from
#: the pixel centre in 1/16 pixel, of the reference's multisampled attachments
#: (forward_raster_render_path.cpp:59).  One sample is the plain raster.
MSAA_PATTERNS = {
    2: ((4, 4), (-4, -4)),
    4: ((-2, -6), (6, -2), (-6, 2), (2, 6)),
    8: ((1, -3), (-1, 3), (5, 1), (-3, -5), (-5, 5), (-7, -1), (3, 7), (7, -7)),
}


def default_e_cap(t: int, npix: int) -> int:
    """The reference's static entry capacity of a binning of t triangles at
    npix pixels: max(65536, 4 t) up to 2^22 pixels, else max(65536, 10 t)."""
    mult = 4 if npix <= (1 << 22) else 10
    return max(65536, mult * t)


@dataclasses.dataclass(frozen=True)
class Bins:
    entry_tri: Any  # (E,) int32 global triangle id per entry, tile-major; E the cap
    offsets: Any  # (ntiles + 1,) int32 start of each tile's entries; [-1] the live count
    ntx: int
    nty: int
    #: (1,) int32 entries past the cap (dropped); None for bins made by hand
    overflow: Any = None


def _tile_counts(width: int, height: int):
    return math.ceil(width / TILE_W), math.ceil(height / TILE_H)


def _check_tile(fn: str, tile_h: int, tile_w: int) -> None:
    """The reference's tile_h / tile_w keywords: the port's kernels raster
    TILE_H x TILE_W tiles only."""
    if (tile_h, tile_w) != (TILE_H, TILE_W):
        raise ValueError(f"{fn}: the port's tiles are {TILE_H}x{TILE_W}, got "
                         f"tile_h={tile_h}, tile_w={tile_w}")


def bin_triangles(setup: TriangleSetup, width: int, height: int, tile_h: int = TILE_H,
                  tile_w: int = TILE_W, e_cap: int | None = None, cull_backface: bool = True,
                  exclude_mask=None, tri_ids=None, *, include=None) -> Bins:
    """The reference's bin_triangles.  tile_h / tile_w: the port's tile
    only (another raises).  e_cap: the entry buffers' length,
    default_e_cap(T, width * height) by default.  exclude_mask: optional (T,)
    bool; those triangles are not binned (the port's keyword `include`, its
    negation, keeps only the triangles it marks).  tri_ids: optional (T,)
    ids the entries carry in place of 0..T-1 (the reference's global ids of
    a subset's setup; a raster of such bins reads the planes those ids
    index).  Entries past the live count hold -1 and the sentinel tile, so
    no tile's range reaches them; nothing here reads a value back."""
    _check_tile("bin_triangles", tile_h, tile_w)
    ntx, nty = _tile_counts(width, height)
    ntiles = ntx * nty
    dev = setup.planes.device
    t = setup.planes.shape[0]
    if e_cap is None:
        e_cap = default_e_cap(t, width * height)
    alive = setup.valid & setup.w_any
    if cull_backface:
        alive &= setup.front
    if exclude_mask is not None:
        alive &= ~exclude_mask
    if include is not None:
        alive &= include
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
    cum = torch.cumsum(span, 0)  # inclusive: entry e's triangle is the first with cum > e
    total = cum[-1:] if t else torch.zeros(1, dtype=torch.int64, device=dev)
    overflow = torch.clamp(total - e_cap, min=0).to(torch.int32)
    e = torch.arange(e_cap, device=dev)
    tri_of = torch.clamp(torch.searchsorted(cum, e, right=True), max=max(t - 1, 0))
    live = e < total
    if t:
        k = e - (cum[tri_of] - span[tri_of])
        ws = torch.clamp(wspan[tri_of], min=1)  # >= 1 wherever an entry is live
        tile = ((ty0 * ntx + tx0)[tri_of] + torch.div(k, ws, rounding_mode="floor") * ntx
                + k % ws)
    else:
        tile = e
    tile = torch.where(live, tile, ntiles)
    tile_sorted, perm = torch.sort(tile, stable=True)
    offsets = torch.searchsorted(tile_sorted, torch.arange(ntiles + 1, device=dev))
    tri = tri_of[perm] if tri_ids is None else tri_ids.long()[tri_of[perm]]
    return Bins(
        entry_tri=torch.where(tile_sorted < ntiles, tri, -1).to(torch.int32),
        offsets=offsets.to(torch.int32).contiguous(),
        ntx=ntx, nty=nty, overflow=overflow,
    )


def live_entry_tri(bins: Bins):
    """(n,) the live entries of `bins` (offsets[-1] of them; one host sync
    on a GPU): for the plain versions, the bound's pricing and the tests,
    never the render path."""
    return bins.entry_tri[:int(bins.offsets[-1])]


def clear_visibility(width: int, height: int, device) -> VisibilityBuffer:
    """The raster's clear values: depth 0, tri -1, bary (0, 0, 1)."""
    bary = torch.zeros((height, width, 3), dtype=torch.float32, device=device)
    bary[..., 2] = 1.0
    return VisibilityBuffer(
        tri_id=torch.full((height, width), -1, dtype=torch.int32, device=device),
        depth=torch.zeros((height, width), dtype=torch.float32, device=device),
        bary=bary,
    )


def entry_tiles(bins: Bins):
    """(n,) int64: the tile of each live entry (live_entry_tri's)."""
    counts = (bins.offsets[1:] - bins.offsets[:-1]).long()
    return torch.repeat_interleave(torch.arange(counts.shape[0], device=counts.device), counts)


def raster_tiles_plain(planes, bins: Bins, width: int, height: int,
                       zcap=None, captid=None, tile_ids=None, n_live=None,
                       chunk: int = 2048) -> VisibilityBuffer:
    """Plain PyTorch K1a / K1b / K1c: every live entry against every pixel
    of its tile, in chunks of entries; per pixel the lexicographic max of
    (z, id) wins.  zcap / captid: (H, W) float32 / int32 peel bound (K1b);
    tile_ids: (L,) int32 tiles to raster, the others keep the clear values
    (K1c), where a slot holding -1, or at or past the (1,) int32 count
    n_live when one is given, lists nothing."""
    dev = planes.device
    npx = TILE_W * TILE_H
    hp, wp = bins.nty * TILE_H, bins.ntx * TILE_W  # tile-padded image
    tile_of = entry_tiles(bins)
    entry_tri = live_entry_tri(bins)
    if tile_ids is not None:
        ntiles = bins.ntx * bins.nty
        ids = tile_ids.long()
        slot_live = ids >= 0
        if n_live is not None:
            slot_live &= torch.arange(ids.shape[0], device=dev) < n_live.to(dev)
        listed = torch.zeros(ntiles + 1, dtype=torch.bool, device=dev)
        listed[torch.where(slot_live, ids, ntiles)] = True
        keep = listed[:ntiles][tile_of]
        tile_of, entry_tri = tile_of[keep], entry_tri[keep]
    if zcap is not None:
        # pixels of the padding never take a fragment, like the kernel's
        zc_pad = torch.full((hp, wp), -BIG, dtype=torch.float32, device=dev)
        tc_pad = torch.full((hp, wp), -1, dtype=torch.int64, device=dev)
        zc_pad[:height, :width] = zcap
        tc_pad[:height, :width] = captid
        zc_pad, tc_pad = zc_pad.reshape(-1), tc_pad.reshape(-1)
    local = torch.arange(npx, device=dev)
    lx = (local % TILE_W).to(torch.float32)
    ly = (local // TILE_W).to(torch.float32)

    best_key = torch.full((hp * wp,), -1, dtype=torch.int64, device=dev)
    best_val = torch.zeros((hp * wp, 4), dtype=torch.float32, device=dev)
    best_val[:, 3] = 1.0
    for s in range(0, entry_tri.shape[0], chunk):
        ids = entry_tri[s:s + chunk].long()
        tl = tile_of[s:s + chunk]
        tx = (tl % bins.ntx) * TILE_W
        ty = torch.div(tl, bins.ntx, rounding_mode="floor") * TILE_H
        px = lx[None, :] + tx.to(torch.float32)[:, None] + 0.5  # (C, npx)
        py = ly[None, :] + ty.to(torch.float32)[:, None] + 0.5
        p = planes[ids]  # (C, 12)

        def plane(k):
            return px * p[:, k, None] + py * p[:, k + 1, None] + p[:, k + 2, None]

        l0, l1, l2, z = plane(0), plane(3), plane(6), plane(9)
        pix = ((ty[:, None] + (local // TILE_W)[None, :]) * wp
               + tx[:, None] + (local % TILE_W)[None, :])
        covered = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & (z >= 0) & (z <= 1)
        if zcap is not None:
            zc, tc = zc_pad[pix], tc_pad[pix]
            covered &= (z < zc) | ((z == zc) & (ids[:, None] < tc))
        # (z, id) as one int64 key: z >= 0 here, so its float bits order
        # like the value (+0.0 folds -0.0, which compares equal to it)
        zbits = (z + 0.0).view(torch.int32).to(torch.int64)
        key = torch.where(covered, (zbits << 32) | ids[:, None], -1)
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


def subtile_masks(planes, bins: Bins, samples: int | None = None,
                  chunk: int = 65536):
    """The kernels' exact sub-tile culling in plain PyTorch: (n,) int64 over
    the live entries, bit s of entry e set unless the corner test proves that no pixel centre
    of sub-tile s of its tile passes e's coverage test.  A plane's value
    fl(fl(fl(px*A) + fl(py*B)) + C) is monotone in px and py, so over the
    sub-tile its max is at the corner picked by the signs of A and B and its
    min at the opposite one; a pair is culled when some l_k's max < 0, z's
    max < 0 or z's min > 1 (a NaN keeps it).  csrc/raster_tile.cu makes the
    same masks with the same operations while it stages a batch.  With
    samples: (samples, n), the masks of each sample position of
    MSAA_PATTERNS[samples] (on offset_planes, which round the shifted
    constants as K1d does); K1d tests a pair when any sample's bit is set.
    Nothing on the render path calls it: chip_smoke.py prices the kernels'
    bound from its pair counts (``passing_pairs``, ``raster_ops``), and the
    tests hold it conservative."""
    if samples is not None:
        return torch.stack([subtile_masks(offset_planes(planes, sx / 16.0, sy / 16.0), bins,
                                          chunk=chunk)
                            for sx, sy in MSAA_PATTERNS[samples]])
    dev = planes.device
    tile_of = entry_tiles(bins)
    entry_tri = live_entry_tri(bins)
    sub = torch.arange(N_SUBTILES, device=dev)
    sub_x = (sub % (TILE_W // SUB_W)) * SUB_W
    sub_y = (sub // (TILE_W // SUB_W)) * SUB_H
    bit = torch.ones_like(sub) << sub
    out = torch.zeros(tile_of.shape[0], dtype=torch.int64, device=dev)
    for s in range(0, tile_of.shape[0], chunk):
        tl = tile_of[s:s + chunk]
        x0 = ((tl % bins.ntx) * TILE_W)[:, None] + sub_x[None, :]  # (C, 32)
        y0 = ((tl // bins.ntx) * TILE_H)[:, None] + sub_y[None, :]
        xl, xh = x0.to(torch.float32) + 0.5, (x0 + SUB_W - 1).to(torch.float32) + 0.5
        yl, yh = y0.to(torch.float32) + 0.5, (y0 + SUB_H - 1).to(torch.float32) + 0.5
        p = planes[entry_tri[s:s + chunk].long()]

        def corner(k, top):
            """Plane k at its max (top) or min corner of each sub-tile."""
            a, b, c = p[:, k, None], p[:, k + 1, None], p[:, k + 2, None]
            px = torch.where((a > 0) == top, xh, xl)
            py = torch.where((b > 0) == top, yh, yl)
            return px * a + py * b + c

        culled = ((corner(0, True) < 0) | (corner(3, True) < 0) | (corner(6, True) < 0)
                  | (corner(9, True) < 0) | (corner(9, False) > 1))
        out[s:s + chunk] = torch.where(culled, 0, bit).sum(dim=1)
    return out


#: FP32 instructions per tested (entry, pixel) pair, counted from
#: csrc/raster_tile.cu (--fmad=false): 4 planes x (2 FMUL + 2 FADD), 5
#: coverage compares, 2 depth-test compares; the peel bound adds 2 compares
RASTER_OPS, PEEL_OPS = 23, 25
#: K1d per (entry, pixel): px*A + py*B of the 4 planes once (8 FMUL + 4
#: FADD), then per sample 4 FADD of the shifted constants and the 7 compares
MSAA_SHARED_OPS, MSAA_SAMPLE_OPS = 12, 11
#: the corner test.  Per entry, 8 sign compares that pick each plane's
#: corners (they depend on A and B alone; the kernel repeats them on every
#: lane, the function needs them once).  Per (entry, sub-tile), 5 corner
#: values (l0, l1, l2 and z at their max, z at its min) x (2 FMUL + 2 FADD)
#: and 5 compares
CULL_ENTRY_OPS, CULL_PAIR_OPS = 8, 25
#: K1d's: the 8 sign compares per entry; per (entry, sub-tile) the 5 corner
#: products (2 FMUL + 1 FADD each), then per sample 5 FADD of the shifted
#: constants and 5 compares; per (entry, sample) the 4 shifted constants
#: C + (A dx + B dy), 2 FMUL + 2 FADD each
MSAA_CULL_PAIR_OPS, MSAA_CULL_SAMPLE_OPS, MSAA_SHIFT_OPS = 15, 10, 16


def passing_pairs(masks) -> int:
    """Set bits over all masks: the (entry, sub-tile) pairs a kernel tests."""
    bits = torch.arange(N_SUBTILES, device=masks.device)
    return int(((masks.reshape(-1, 1) >> bits) & 1).sum())


def raster_ops(n_entries: int, n_pass: int, mode: str, samples: int = 1):
    """(FP32 instructions after the culling, those of the dense test) of
    one raster call: n_entries live entries (offsets[-1]), of which n_pass (entry, sub-tile)
    pairs pass the corner test (K1d: on some sample).  mode: "K1a", "K1b",
    "K1c" or "K1d"."""
    if mode == "K1d":
        pixel = MSAA_SHARED_OPS + samples * MSAA_SAMPLE_OPS
        test = (CULL_ENTRY_OPS + samples * MSAA_SHIFT_OPS
                + N_SUBTILES * (MSAA_CULL_PAIR_OPS + samples * MSAA_CULL_SAMPLE_OPS))
    else:
        pixel = RASTER_OPS if mode == "K1a" else PEEL_OPS
        test = CULL_ENTRY_OPS + N_SUBTILES * CULL_PAIR_OPS
    return (n_entries * test + n_pass * SUB_W * SUB_H * pixel,
            n_entries * TILE_W * TILE_H * pixel)


@functools.cache
def load_kernel():
    """Build csrc/raster_tile.cu (on first use) and load it; returns the
    launch functions of K1a, K1b, K1c and K1d."""
    from vulkanhybridrenderer_tpu_torch.utils.build import load_cuda_library

    lib = load_cuda_library("raster_tile.cu")
    ptr, num = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "raster_tile_launch": [ptr] * 3 + [num] * 6 + [ptr] * 4,
        "raster_tile_peel_launch": [ptr] * 5 + [num] * 6 + [ptr] * 4,
        "raster_tile_compact_launch": [ptr] * 4 + [num] + [ptr] * 3 + [num] * 5 + [ptr] * 4,
        "raster_tile_msaa_launch": ([ptr] * 3 + [ctypes.POINTER(ctypes.c_float)]
                                    + [num] * 7 + [ptr] * 4),
    }
    fns = []
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        fns.append(fn)
    return tuple(fns)


def _check(name, t, dtype, device, shape=None):
    if (t.device != device or t.dtype != dtype or not t.is_contiguous()
            or (shape is not None and tuple(t.shape) != shape)):
        raise ValueError(
            f"raster_tiles: {name} must be a contiguous {dtype} tensor "
            f"{'' if shape is None else shape} on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}"
        )


def _empty_visibility(width: int, height: int, device, samples=()) -> VisibilityBuffer:
    """Uninitialised outputs of (*samples, H, W) (bary (*samples, H, W, 3))."""
    shape = (*samples, height, width)
    return VisibilityBuffer(
        tri_id=torch.empty(shape, dtype=torch.int32, device=device),
        depth=torch.empty(shape, dtype=torch.float32, device=device),
        bary=torch.empty((*shape, 3), dtype=torch.float32, device=device),
    )


def launch(mode: str, planes, bins: Bins, width: int, height: int,
           out: VisibilityBuffer, zcap=None, captid=None, tile_ids=None,
           samples: int = 1, n_live=None) -> None:
    """Check the inputs and launch one kernel mode ("K1a", "K1b", "K1c",
    "K1d") on the current stream, writing into `out`, which K1c expects
    pre-filled (it writes the listed tiles only) and K1d expects with a
    leading (samples,) dimension.  K1c launches a block a slot of tile_ids
    and reads the (1,) int32 count n_live on the device.  Counts nothing:
    the wrappers below allocate the outputs and count their launches."""
    if planes.device.type != "cuda":
        raise ValueError(f"raster_tiles: unsupported device {planes.device}")
    dev = planes.device
    _check("planes", planes, torch.float32, dev)
    _check("entry_tri", bins.entry_tri, torch.int32, dev)
    _check("offsets", bins.offsets, torch.int32, dev, (bins.ntx * bins.nty + 1,))
    if planes.dim() != 2 or planes.shape[1] != 12:
        raise ValueError(f"raster_tiles: planes must be (T, 12), got {tuple(planes.shape)}")
    if planes.data_ptr() % 16:
        # the kernels copy each 48-byte row as three 16-byte vectors
        raise ValueError("raster_tiles: planes must be 16-byte aligned")
    if (bins.ntx, bins.nty) != _tile_counts(width, height):
        raise ValueError("raster_tiles: bins were made for another image size")
    if zcap is not None:
        _check("zcap", zcap, torch.float32, dev, (height, width))
        _check("captid", captid, torch.int32, dev, (height, width))
    if tile_ids is not None:
        _check("tile_ids", tile_ids, torch.int32, dev)
        _check("n_live", n_live, torch.int32, dev, (1,))
    shape = (samples, height, width) if mode == "K1d" else (height, width)
    _check("out depth", out.depth, torch.float32, dev, shape)
    _check("out tri_id", out.tri_id, torch.int32, dev, shape)
    _check("out bary", out.bary, torch.float32, dev, (*shape, 3))
    k1a, k1b, k1c, k1d = load_kernel()
    outs = (out.depth.data_ptr(), out.tri_id.data_ptr(), out.bary.data_ptr())
    common = (TILE_W, TILE_H, bins.ntx)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if mode == "K1a":
            err = k1a(planes.data_ptr(), bins.entry_tri.data_ptr(),
                      bins.offsets.data_ptr(), *common, bins.nty, width, height,
                      *outs, stream)
        elif mode == "K1b":
            err = k1b(planes.data_ptr(), bins.entry_tri.data_ptr(),
                      bins.offsets.data_ptr(), zcap.data_ptr(), captid.data_ptr(),
                      *common, bins.nty, width, height, *outs, stream)
        elif mode == "K1c":
            err = k1c(planes.data_ptr(), bins.entry_tri.data_ptr(),
                      bins.offsets.data_ptr(), tile_ids.data_ptr(),
                      tile_ids.shape[0], n_live.data_ptr(), zcap.data_ptr(),
                      captid.data_ptr(),
                      *common, width, height, *outs, stream)
        else:
            dxdy = [v / 16.0 for xy in MSAA_PATTERNS[samples] for v in xy]
            err = k1d(planes.data_ptr(), bins.entry_tri.data_ptr(),
                      bins.offsets.data_ptr(), (ctypes.c_float * len(dxdy))(*dxdy),
                      samples, *common, bins.nty, width, height, *outs, stream)
    if err != 0:
        raise RuntimeError(f"raster_tile {mode} kernel launch failed: CUDA error {err}")


def raster_tiles(planes, bins: Bins, width: int, height: int) -> VisibilityBuffer:
    """K1a.  planes: (T, 12) float32 (triangle_setup); bins from
    bin_triangles.  CPU tensors run raster_tiles_plain; CUDA tensors launch
    csrc/raster_tile.cu or raise."""
    if planes.device.type == "cpu":
        return raster_tiles_plain(planes, bins, width, height)
    out = _empty_visibility(width, height, planes.device)
    launch("K1a", planes, bins, width, height, out)
    raster_tiles.launches += 1
    return out


def raster_tiles_peel(planes, bins: Bins, width: int, height: int,
                      zcap, captid) -> VisibilityBuffer:
    """K1b: K1a where a fragment must also lie strictly below the pixel's
    peel bound, z < zcap or (z == zcap and id < captid).  zcap (H, W)
    float32, captid (H, W) int32."""
    if planes.device.type == "cpu":
        return raster_tiles_plain(planes, bins, width, height, zcap, captid)
    out = _empty_visibility(width, height, planes.device)
    launch("K1b", planes, bins, width, height, out, zcap, captid)
    raster_tiles_peel.launches += 1
    return out


def raster_tiles_compact(planes, bins: Bins, width: int, height: int,
                         zcap, captid, tile_ids, n_live) -> VisibilityBuffer:
    """K1c: K1b over the physical tiles listed in the (L,) int32 `tile_ids`
    only; every other pixel keeps the clear values, which is what K1b gives
    where the bound admits nothing.  A slot holding -1, or at or past the
    (1,) int32 device count n_live, lists nothing: the peel hands it
    live_tiles' list of every tile, sized on the device."""
    if planes.device.type == "cpu":
        return raster_tiles_plain(planes, bins, width, height, zcap, captid, tile_ids, n_live)
    out = clear_visibility(width, height, planes.device)
    launch("K1c", planes, bins, width, height, out, zcap, captid, tile_ids, n_live=n_live)
    raster_tiles_compact.launches += 1
    return out


def offset_planes(planes, dx: float, dy: float):
    """The planes evaluated at pixel centre + (dx, dy): every constant C
    (columns 2, 5, 8, 11, the z plane's too) becomes C + ((A * dx) +
    (B * dy)), each operation rounded on its own, as the reference's
    offset_bins / _offset_setup compute it."""
    p = planes.clone()
    p[:, 2::3] = planes[:, 2::3] + (planes[:, 0::3] * dx + planes[:, 1::3] * dy)
    return p


def raster_tiles_msaa_plain(planes, bins: Bins, width: int, height: int,
                            samples: int) -> list[VisibilityBuffer]:
    """Plain PyTorch K1d: raster_tiles_plain on offset_planes, per sample."""
    return [raster_tiles_plain(offset_planes(planes, sx / 16.0, sy / 16.0), bins,
                               width, height)
            for sx, sy in MSAA_PATTERNS[samples]]


def raster_tiles_msaa(planes, bins: Bins, width: int, height: int,
                      samples: int) -> list[VisibilityBuffer]:
    """K1d: K1a at each of the `samples` (2, 4 or 8) positions of
    MSAA_PATTERNS, in one launch over the bins (made at pixel centres; the
    bbox binning is conservative for any in-pixel sample).  Returns one
    VisibilityBuffer per sample; on the card they are views of (samples, H,
    W) outputs.  CPU tensors run raster_tiles_msaa_plain."""
    if samples not in MSAA_PATTERNS:
        raise ValueError(f"K1d takes {sorted(MSAA_PATTERNS)} samples, got {samples}")
    if planes.device.type == "cpu":
        return raster_tiles_msaa_plain(planes, bins, width, height, samples)
    out = _empty_visibility(width, height, planes.device, samples=(samples,))
    launch("K1d", planes, bins, width, height, out, samples=samples)
    raster_tiles_msaa.launches += 1
    return [VisibilityBuffer(tri_id=out.tri_id[s], depth=out.depth[s], bary=out.bary[s])
            for s in range(samples)]


raster_tiles.launches = 0
raster_tiles_peel.launches = 0
raster_tiles_compact.launches = 0
raster_tiles_msaa.launches = 0


def alpha_test(tables, vis: VisibilityBuffer):
    """The fragment alpha kill (gbuf.frag:22-32) of each pixel's winner:
    returns (accept, killed), (H, W) bool.  Every pixel is tested (an
    uncovered one reads triangle 0's row) and the uncovered ones masked
    out, so nothing waits for the host; a covered pixel's test is the same
    arithmetic as on a list of covered pixels.  The gathers read only what
    the test needs: 13 columns of each static row, the alpha of each tap."""
    flat = vis.tri_id.reshape(-1)
    covered = flat >= 0
    pm = shadetab.fetch_alpha_fields(tables, torch.clamp(flat, min=0))
    wts = weights_from_bary(vis.bary.reshape(-1, 3))
    uv = shadetab.interpolate3(pm["uv0"], wts)
    alpha = shadetab.sample_atlas_alpha(
        tables, pm["base_tex"], pm["base_scale"], pm["base_offset"], uv)
    needs = (pm["alpha_mask"] == 1.0) & (pm["base_tex"] >= 0)
    killed = covered & needs & (alpha < pm["alpha_cutoff"])
    shape = vis.tri_id.shape
    return (covered & ~killed).reshape(shape), killed.reshape(shape)


def peel_bound(vis: VisibilityBuffer, killed):
    """The next round's bound: killed pixels keep their winner's (z, id);
    every other pixel gets (-BIG, -1), which admits nothing."""
    zcap = torch.where(killed, vis.depth, -BIG).contiguous()
    captid = torch.where(killed, vis.tri_id, -1).to(torch.int32).contiguous()
    return zcap, captid


def live_tiles(killed, ntx: int, nty: int):
    """The tiles holding a killed pixel, listed on the device: (tile_ids,
    n_live), tile_ids the (ntx * nty,) int32 ids of those tiles in
    ascending order, then -1 in every slot past them, and n_live their
    (1,) int32 count."""
    h, w = killed.shape
    pad = torch.zeros((nty * TILE_H, ntx * TILE_W), dtype=torch.bool, device=killed.device)
    pad[:h, :w] = killed
    per_tile = pad.reshape(nty, TILE_H, ntx, TILE_W).any(dim=3).any(dim=1).reshape(-1)
    n_live = per_tile.sum().to(torch.int32).reshape(1)
    order = torch.sort((~per_tile).to(torch.uint8), stable=True).indices
    slot = torch.arange(per_tile.shape[0], device=killed.device)
    return torch.where(slot < n_live, order, -1).to(torch.int32), n_live


def rasterize_alpha_peeled(scene, setup: TriangleSetup, width: int, height: int,
                           tables, rounds: int = 4, interpret: bool = False,
                           cull_backface: bool = True, tile_h: int = TILE_H,
                           tile_w: int = TILE_W, unroll_rounds: bool = True,
                           compact_tiles: bool = True, live_tile_cap: int | None = None,
                           sub_block_cap: int | None = None, *, trace: list | None = None):
    """Binned raster of the alpha-MASK triangles with the per-fragment alpha
    kill, by depth peeling (the reference's rasterize_alpha_peeled, with its
    signature); returns (VisibilityBuffer, the masked stream's binning
    overflow), as the reference's does.  `interpret`, `unroll_rounds`,
    `compact_tiles`, `live_tile_cap` and `sub_block_cap` only steer the
    reference's TPU schedule (its frames are the same for every value) and
    are ignored; tile_h / tile_w: the port's tile only.

    Round 1 rasters the masked stream over every tile with a bound that
    admits every fragment (K1b) and alpha-tests each pixel's winner.  A
    passing winner is final: nothing deeper can win.  A killed pixel gets
    its winner's (z, id) as the next round's bound, so the next-deepest
    fragment surfaces.  Rounds 2..`rounds` raster only the tiles that hold a
    killed pixel (K1c).  A pixel with more than `rounds` rejected fragments
    stays uncovered, as in the reference.  The masked stream is binned with
    the reference's cap, max(8192, 8 A) entries for A masked triangles.

    Nothing here waits for the host: every round runs, over live_tiles'
    list of every tile with its count on the device, and a round with no
    killed pixel before it rasters no tile and changes nothing.  The
    reference caps its live-tile list and the list's entry blocks (l_cap,
    sb_cap) and falls back to a full-width round through lax.cond when one
    overflows; a list as long as the image's tiles needs neither, and gives
    the same frames.  trace: optional list that receives, once the rounds
    are queued, one dict per round up to the first that had no tile to
    raster (round, tiles rastered, killed pixels): reading it waits for the
    device.
    """
    _check_tile("rasterize_alpha_peeled", tile_h, tile_w)
    dev = setup.planes.device
    # index_fill_, not include[idx] = True: that copies the True from the host
    include = torch.zeros(setup.planes.shape[0], dtype=torch.bool, device=dev).index_fill_(
        0, scene.alpha_tri_idx.long(), True)
    bins = bin_triangles(setup, width, height, cull_backface=cull_backface,
                         include=include, e_cap=max(8192, 8 * scene.alpha_tri_idx.shape[0]))
    final = clear_visibility(width, height, dev)
    zcap = torch.full((height, width), BIG, dtype=torch.float32, device=dev)
    captid = torch.full((height, width), _INT32_MAX, dtype=torch.int32, device=dev)
    killed = None
    rounds_seen = []
    for r in range(rounds):
        if r == 0:
            vis = raster_tiles_peel(setup.planes, bins, width, height, zcap, captid)
            n_tiles = bins.ntx * bins.nty
        else:
            tile_ids, n_tiles = live_tiles(killed, bins.ntx, bins.nty)
            vis = raster_tiles_compact(setup.planes, bins, width, height,
                                       zcap, captid, tile_ids, n_tiles)
        accept, killed = alpha_test(tables, vis)
        final = VisibilityBuffer(
            tri_id=torch.where(accept, vis.tri_id, final.tri_id),
            depth=torch.where(accept, vis.depth, final.depth),
            bary=torch.where(accept[..., None], vis.bary, final.bary),
        )
        zcap, captid = peel_bound(vis, killed)
        if trace is not None:
            rounds_seen.append((r + 1, n_tiles, killed.sum()))
    for r, n_tiles, n_killed in rounds_seen:
        if r > 1 and int(n_tiles) == 0:
            break
        trace.append(dict(round=r, tiles=int(n_tiles), killed=int(n_killed)))
    return final, bins.overflow


def merge_visibility(a: VisibilityBuffer, b: VisibilityBuffer) -> VisibilityBuffer:
    """Depth-merge two visibility buffers (reverse-Z GREATER_OR_EQUAL; b wins
    ties, matching later-draw-wins): the masked stream over the opaque."""
    take_b = (b.tri_id >= 0) & (b.depth >= a.depth)
    return VisibilityBuffer(
        tri_id=torch.where(take_b, b.tri_id, a.tri_id),
        depth=torch.where(take_b, b.depth, a.depth),
        bary=torch.where(take_b[..., None], b.bary, a.bary),
    )


def opaque_include(scene, alpha: bool):
    """The opaque stream's triangles: with alpha (and masked triangles in
    the scene) the (T,) bool of the unmasked ones, else None (every one).
    Returns (include, whether the masked stream is peeled)."""
    if not (alpha and scene.has_alpha_mask):
        return None, False
    return scene.materials.alpha_mask[scene.tri_prim.long()] != 1, True


def _opaque_stream(scene, clip, width: int, height: int, cull_backface: bool,
                   alpha: bool):
    """Triangle setup and the opaque stream's bins: every triangle, or with
    alpha (and masked triangles in the scene) every unmasked one.  Returns
    (setup, bins, whether the masked stream is peeled)."""
    setup = triangle_setup(clip, scene.tri_vertex, width, height)
    include, use_alpha = opaque_include(scene, alpha)
    bins = bin_triangles(setup, width, height, cull_backface=cull_backface,
                         include=include)
    return setup, bins, use_alpha


def poison(vis: VisibilityBuffer, overflow) -> VisibilityBuffer:
    """The reference's every-frame overflow guard: the depth times NaN where
    the (1,) `overflow` is positive (entries were dropped), else times 1
    (the same bits), on the device."""
    return dataclasses.replace(
        vis, depth=vis.depth * torch.where(overflow > 0, torch.nan, 1.0))


def rasterize_scene(scene, clip, width: int, height: int, interpret: bool | None = None,
                    tile_h: int = TILE_H, tile_w: int = TILE_W, alpha: bool = True,
                    cull_backface: bool = True, tables=None,
                    alpha_rounds: int = 4) -> VisibilityBuffer:
    """Full-scene visibility buffer, with the reference's signature
    (`interpret` only steers the TPU kernel and is ignored; tile_h /
    tile_w: the port's tile only): setup, then two binned streams merged
    by depth.  With alpha (and a scene that has alpha-masked triangles) the
    opaque stream excludes the masked triangles (K1a) and the masked stream
    is depth-peeled with the alpha kill (K1b, K1c); without, every triangle
    rasters solid through K1a (alpha_raster="off").  A stream whose binning
    overflowed its cap NaN-poisons the depth, the masked one after the
    merge (a NaN would lose the merge's compare), as the reference's."""
    _check_tile("rasterize_scene", tile_h, tile_w)
    setup, bins, use_alpha = _opaque_stream(scene, clip, width, height, cull_backface,
                                            alpha)
    vis = poison(raster_tiles(setup.planes, bins, width, height), bins.overflow)
    if use_alpha:
        if tables is None:
            tables = shadetab.build_shade_tables(scene)
        vis_m, overflow_m = rasterize_alpha_peeled(scene, setup, width, height, tables,
                                                   rounds=alpha_rounds,
                                                   cull_backface=cull_backface)
        vis = poison(merge_visibility(vis, vis_m), overflow_m)
    return vis


def depth_ties(scene, clip, width: int, height: int, cull_backface: bool = True,
               rel: float = 1e-5):
    """(H, W) bool: the pixels whose two nearest fragments (every triangle,
    masked ones solid) differ in depth, but by no more than `rel` of it.
    There two coplanar surfaces made of different triangles z-fight, and the
    last bits of each triangle's setup decide which one shows: arithmetic
    that rounds otherwise (fused multiply-adds) may show the other.  Equal
    depths (the same triangle twice) are not ties of this kind: the larger
    triangle id wins them on every device.  The second layer is the first
    one's peel (K1b with the first layer's (z, id) as its bound)."""
    setup, bins, _ = _opaque_stream(scene, clip, width, height, cull_backface, alpha=False)
    first = raster_tiles(setup.planes, bins, width, height)
    second = raster_tiles_peel(setup.planes, bins, width, height, first.depth.contiguous(),
                               first.tri_id.contiguous())
    gap = first.depth - second.depth
    both = (first.tri_id >= 0) & (second.tri_id >= 0)
    return both & (gap > 0) & (gap <= rel * first.depth)

def rasterize_scene_msaa(scene, clip, width: int, height: int, samples: int,
                         interpret: bool | None = None, alpha: bool = True,
                         cull_backface: bool = True, tables=None) -> list[VisibilityBuffer]:
    """Multisampled visibility: one VisibilityBuffer per sample position of
    MSAA_PATTERNS[samples], at the base resolution (the reference's
    rasterize_scene_msaa, with its signature; `interpret` only steers the
    TPU kernel and is ignored).  Triangle setup and the opaque binning run once;
    the opaque stream goes through K1d.  With alpha (and masked triangles in
    the scene) each sample then peels the masked stream on its offset setup
    (K1b, K1c) and merges it over its opaque buffer.  Overflow poisons the
    depth as in rasterize_scene.  The reference passes
    no round count to that peel, so it runs the default 4 rounds whatever
    alpha_peel_rounds says; so does this."""
    if samples not in MSAA_PATTERNS:
        raise ValueError(f"msaa_samples must be one of {sorted(MSAA_PATTERNS)}")
    setup, bins, use_alpha = _opaque_stream(scene, clip, width, height, cull_backface,
                                            alpha)
    vises = [poison(v, bins.overflow)
             for v in raster_tiles_msaa(setup.planes, bins, width, height, samples)]
    if not use_alpha:
        return vises
    if tables is None:
        tables = shadetab.build_shade_tables(scene)
    out = []
    for (sx, sy), vis in zip(MSAA_PATTERNS[samples], vises):
        shifted = dataclasses.replace(
            setup, planes=offset_planes(setup.planes, sx / 16.0, sy / 16.0))
        vis_m, overflow_m = rasterize_alpha_peeled(scene, shifted, width, height, tables,
                                                   cull_backface=cull_backface)
        out.append(poison(merge_visibility(vis, vis_m), overflow_m))
    return out
