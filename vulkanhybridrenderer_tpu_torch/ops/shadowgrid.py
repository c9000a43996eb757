"""Light-space shadow grid (port of ``ops/shadowgrid.py``): kernel K3.

The hybrid path's shadow rays all leave within a 0.18-degree cone of one
direction (raygen's cos_theta_max 0.999995), so in a frame aligned to the
light each ray stays inside one (u, v) column of a 2D grid, up to a drift of
depth * tan(theta_max).  ``shadow_accel="grid"`` answers their any-hit
queries from that grid instead of the BVH8:

  1. ``build_shadow_grid``: every triangle's (u, v) box, dilated by the
     largest drift plus 1e-3, is binned into the cells it covers, sorted by
     cell, with the whole world-space triangle inlined in its entry row.
     Triangles covering at most `span_cap` cells are enumerated densely;
     those covering up to 64 and up to 256 cells go through two compacted
     medium tiers (at most max(4096, T / 8) and max(1024, T / 16)
     triangles); larger ones go to a global list of at most BIG_CAP rows
     that every ray tests.  Triangles beyond a tier's capacity are counted
     in `overflow` and dropped, as in the reference.  Every table is sized
     from T alone, as the reference's: a row for every slot, padding
     sorted last, so nothing is read back.  The resolution is sized on the
     host from the triangles (`grid_resolution`); animated scenes rebuild
     at the same resolution every frame, inside the frame's CUDA graph.
  2. ``trace_shadow``: a ray looks up its origin's cell and runs
     Moller-Trumbore (no culling) over the cell's entries, at most
     `max_steps` of them, and over the big rows, stopping at the first hit
     with tmin <= t <= tmax that the alpha filter (``alpha_tables``)
     accepts.  The grid only culls and the dilation keeps the culling
     conservative, so the hit mask equals any-hit traversal of the BVH8.

On CUDA tensors ``trace_shadow`` launches the hand-written kernel
csrc/shadow_grid.cu (the reference runs an XLA while_loop over the entries,
which as eager PyTorch would be a round of launches a step): a block takes
a pixel tile, queues its live rays in shared memory and stages the heads of
their cells' entry lists there (`stage_rows` rows a block); a lane walks a
ray, the big tier (`num_big` rows, read on the device) before the cell's
entries (the reference tests it after them, and both orders test the same
rows), and takes the next queued ray
as soon as its ray ends.  On CPU tensors it runs ``trace_shadow_plain``,
the same tests stepped in lockstep over the live rays in either order,
which can count the entries each ray tests and the test at which each
ends: the counts that price K3's bound.

The reference computes its light-frame projections with a multiply-add
chain; the build repeats that rounding (``_dot3``), so cells and offsets
equal the reference's.  The trace's cell lookup rounds every product, in the
kernel and the plain version alike.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from vulkanhybridrenderer_tpu_torch.ops import shadetab
from vulkanhybridrenderer_tpu_torch.ops.traverse import (
    filter_tables,
    make_alpha_hit_filter,
    moller_trumbore,
)
from vulkanhybridrenderer_tpu_torch.utils.build import current_stream, load_cuda_library
from vulkanhybridrenderer_tpu_torch.utils.consts import device_constant
from vulkanhybridrenderer_tpu_torch.utils.math3d import cross, normalize

BIG_CAP = 128  # global big-tier capacity (huge occluders)
MED1_SPAN = 64  # medium tier 1: spans up to this many cells
MED2_SPAN = 256  # medium tier 2; beyond it -> the global big list
#: tan(acos(0.999995)), the half-angle of raygen's shadow cone
CONE_TAN = 3.163e-3
MAX_STEPS = 4096  # cell entries a ray tests at most
ROW_W = 12  # entry row: [v0.xyz v1.xyz v2.xyz tri_id 0 0]
STAGE_ROWS = 128  # cell rows a K3 block stages in shared memory


@dataclasses.dataclass(frozen=True)
class ShadowGrid:
    entries: Any  # (E, 12) float32 rows of the binned entries, cell-sorted
    offsets: Any  # (grid * grid + 1,) int32: cell c's entries are [offsets[c], offsets[c+1])
    u_axis: Any  # (3,) light-frame u
    v_axis: Any  # (3,) light-frame v
    origin_uv: Any  # (2,) the grid window's (u, v) minimum
    inv_cell: Any  # (2,) 1 / cell size
    big: Any  # (BIG_CAP, 12) rows of the big tier; rows past num_big hold tri -1
    num_big: Any  # () int32: valid rows of `big`
    grid: int = 512
    span_cap: int = 16
    overflow: Any = None  # () int32: triangles beyond a tier's capacity (dropped)
    #: (10,) float32 [u_axis, v_axis, origin_uv, inv_cell] on the grid's
    #: device: what K3 reads of the frame, so a launch needs no host copy
    frame: Any = None

    @property
    def num_entries(self) -> int:
        """The entry table's rows, a static count; offsets[-1] of them are
        live, the rest padding (triangle 0's vertices, id -1)."""
        return self.entries.shape[0]


def _light_frame(direction):
    """(d, u, v): the unit light direction and an orthonormal (u, v)
    spanning the plane perpendicular to it (chosen on the device)."""
    d = normalize(torch.as_tensor(direction, dtype=torch.float32))
    up = torch.where(torch.abs(d[1]) < 0.9, device_constant([0.0, 1.0, 0.0], device=d.device),
                     device_constant([1.0, 0.0, 0.0], device=d.device))
    u = normalize(cross(up, d))
    return d, u, cross(d, u)


def _first_true(mask, cap: int):
    """The reference's nonzero(mask, size=cap, fill_value=0) on the device:
    (cap,) int64, the first `cap` indices where `mask` holds, in order, then
    zeros.  A cumsum numbers the true entries; those past `cap` go to a
    spare slot."""
    pos = torch.cumsum(mask, 0) - 1
    dest = torch.where(mask & (pos < cap), pos, cap)
    idx = torch.zeros(cap + 1, dtype=torch.int64, device=mask.device)
    idx.scatter_(0, dest, torch.arange(mask.shape[0], device=mask.device))
    return idx[:cap]


def _fma(a, b, c):
    """a * b + c rounded once to float32 (exact in float64 but in the rare
    double-rounding case)."""
    return (a.double() * b.double() + c.double()).float()


def _dot3(x, axis):
    """x (..., 3) . axis (3,) as a multiply-add chain, the rounding of the
    reference's einsum on its CPU backend."""
    return _fma(x[..., 2], axis[2], _fma(x[..., 1], axis[1], x[..., 0] * axis[0]))


def grid_resolution(tri_verts, light_direction, cone_tan: float = CONE_TAN) -> int:
    """The grid resolution for (T, 3, 3) triangles: cells about the mean
    dilated triangle footprint, a power of two from 32 to 512 (host numpy,
    the reference's sizing)."""
    tv = np.asarray(tri_verts, np.float32)
    d = np.asarray(light_direction, np.float32)
    d = d / max(np.linalg.norm(d), 1e-9)
    up = np.array([0, 1, 0], np.float32) if abs(d[1]) < 0.9 else np.array([1, 0, 0], np.float32)
    u = np.cross(up, d)
    u /= max(np.linalg.norm(u), 1e-9)
    v = np.cross(d, u)
    pu = tv @ u
    pv = tv @ v
    span = max(pu.max() - pu.min(), pv.max() - pv.min(), 1e-3)
    depth = (tv @ d).max() - (tv @ d).min()
    dilate = depth * cone_tan
    mean_size = float(np.mean(pu.max(1) - pu.min(1)) + np.mean(pv.max(1) - pv.min(1))) * 0.5
    c_target = max(mean_size + 2.0 * dilate, span / 512.0)
    g = 32
    while g * 2 <= span / c_target and g < 512:
        g *= 2
    return g


def build_shadow_grid(tri_verts, light_direction, cone_tan: float = CONE_TAN,
                      grid: int | None = None, span_cap: int = 16) -> ShadowGrid:
    """The grid over (T, 3, 3) world triangles for light travelling along
    `light_direction` (rays go along -light_direction), on the triangles'
    device.  grid=None sizes it on the host (grid_resolution).

    The reference's ``_build_shadow_grid`` array for array, sized from T
    alone: T * span_cap slots of the dense tier, med1_cap * MED1_SPAN and
    med2_cap * MED2_SPAN of the medium lists, cell id grid^2 marking a slot
    past a triangle's span or a list's count.  A stable sort puts those
    last; every slot keeps a row (triangle 0's vertices and id -1 on
    padding), and `offsets` (searchsorted) ends at the live count.
    `num_big` and `overflow` stay on the device, so given `grid` nothing is
    read back and a CUDA graph can hold the rebuild."""
    dev = tri_verts.device
    light = torch.as_tensor(light_direction, dtype=torch.float32, device=dev)
    if grid is None:
        grid = grid_resolution(tri_verts.cpu().numpy(), light.cpu().numpy(), cone_tan)
    t = tri_verts.shape[0]
    d, u, v = _light_frame(light)
    pu, pv, pd = _dot3(tri_verts, u), _dot3(tri_verts, v), _dot3(tri_verts, d)  # (T, 3)

    lo_u, hi_u = pu.min(), pu.max()
    lo_v, hi_v = pv.min(), pv.max()
    dilate = (pd.max() - pd.min()) * cone_tan  # the largest drift of a cone ray
    pad = dilate + 1e-3
    span_uv = torch.stack([torch.clamp(hi_u - lo_u, min=1e-3), torch.clamp(hi_v - lo_v, min=1e-3)])
    cell = span_uv / grid  # a power of two: exact on every device
    inv_cell = torch.ones_like(cell) / cell
    origin_uv = torch.stack([lo_u, lo_v])

    def cells(lo, hi, origin, inv):
        c0 = torch.floor(((lo - pad) - origin) * inv).clamp(0, grid - 1).long()
        c1 = torch.floor(((hi + pad) - origin) * inv).clamp(0, grid - 1).long()
        return c0, c1

    cu0, cu1 = cells(pu.amin(1), pu.amax(1), lo_u, inv_cell[0])
    cv0, cv1 = cells(pv.amin(1), pv.amax(1), lo_v, inv_cell[1])
    wspan = cu1 - cu0 + 1
    span = wspan * (cv1 - cv0 + 1)
    ncells = grid * grid

    def slots(idx, live, scap):
        """(cell ids, triangle ids) of the first scap cells of triangles
        idx (only where `live`); ncells marks a slot past a span."""
        k = torch.arange(scap, device=dev)[None, :]
        ws = wspan[idx][:, None]
        cid = (cv0[idx][:, None] + k // ws) * grid + cu0[idx][:, None] + k % ws
        cid = torch.where(live[:, None] & (k < span[idx][:, None]), cid, ncells)
        return cid.reshape(-1), idx[:, None].expand(-1, scap).reshape(-1)

    # tiers, like the raster binning: dense slots for small spans, lists of
    # the first `cap` medium ones (in triangle order), a global list beyond
    ok = span <= span_cap
    med1 = (span > span_cap) & (span <= MED1_SPAN)
    med2 = (span > MED1_SPAN) & (span <= MED2_SPAN)
    big_mask = span > MED2_SPAN
    med1_cap, med2_cap = max(4096, t // 8), max(1024, t // 16)
    n_big, n_med1, n_med2 = big_mask.sum(), med1.sum(), med2.sum()
    overflow = (torch.clamp(n_big - BIG_CAP, min=0) + torch.clamp(n_med1 - med1_cap, min=0)
                + torch.clamp(n_med2 - med2_cap, min=0)).to(torch.int32)
    parts = [slots(torch.arange(t, device=dev), ok, span_cap)]
    for mask, n, cap, scap in ((med1, n_med1, med1_cap, MED1_SPAN),
                               (med2, n_med2, med2_cap, MED2_SPAN)):
        parts.append(slots(_first_true(mask, cap), torch.arange(cap, device=dev) < n, scap))
    cell_id = torch.cat([p[0] for p in parts]).to(torch.int32)
    tri_id = torch.cat([p[1] for p in parts])
    cell_sorted, order = torch.sort(cell_id, stable=True)
    tri_sorted = tri_id[order]
    offsets = torch.searchsorted(cell_sorted, torch.arange(ncells + 1, dtype=torch.int32,
                                                           device=dev)).to(torch.int32)

    tv9 = tri_verts.reshape(t, 9)

    def rows(ids, valid):
        """Entry rows of triangles ids: where not `valid`, triangle 0's
        vertices and id -1, as the reference's padding rows."""
        return torch.cat([tv9[torch.where(valid, ids, 0)],
                          torch.where(valid, ids, -1).to(torch.float32)[:, None],
                          tv9.new_zeros((ids.shape[0], 2))], dim=1).contiguous()

    num_big = torch.clamp(n_big, max=BIG_CAP).to(torch.int32)
    return ShadowGrid(
        entries=rows(tri_sorted, cell_sorted < ncells), offsets=offsets.contiguous(),
        u_axis=u, v_axis=v, origin_uv=origin_uv, inv_cell=inv_cell,
        big=rows(_first_true(big_mask, BIG_CAP), torch.arange(BIG_CAP, device=dev) < num_big),
        num_big=num_big, grid=grid, span_cap=span_cap, overflow=overflow,
        frame=torch.cat([u, v, origin_uv, inv_cell]).contiguous(),
    )


def origin_cells(sg: ShadowGrid, origin):
    """(R,) int64 cell of each origin: its (u, v) projection with every
    product rounded, clamped to the grid (rays born outside the window test
    the edge cell)."""
    def axis(a, k):
        p = (origin[:, 0] * a[0] + origin[:, 1] * a[1]) + origin[:, 2] * a[2]
        c = torch.floor((p - sg.origin_uv[k]) * sg.inv_cell[k])
        return torch.clamp(c, 0, sg.grid - 1).long()

    return axis(sg.v_axis, 1) * sg.grid + axis(sg.u_axis, 0)


def trace_shadow_plain(sg: ShadowGrid, origin, direction, tmin, tmax,
                       max_steps: int = MAX_STEPS, hit_filter=None, visits: bool = False,
                       big_first: bool = False, stages: bool = False):
    """Plain PyTorch K3: (R,) bool hit mask; with `visits` also (R,) int64
    entries (cell and big rows) each ray tested, and with `stages` too the
    (4,) int64 tests that an early-returning Moller-Trumbore (K3's) ends at
    det, at u, at v and in full (traverse.moller_trumbore's stage).  Rays
    with tmax < tmin test nothing and miss.  hit_filter(tri, u, v) -> accept
    is asked only about geometric hits in [tmin, tmax].  `big_first` walks
    the big tier before the cell's entries (K3's order) instead of after
    them (the reference's): the same rows either way, so the same mask, but
    a ray that hits stops after other counts."""
    dev = origin.device
    r = origin.shape[0]
    hit = torch.zeros(r, dtype=torch.bool, device=dev)
    tested = torch.zeros(r, dtype=torch.int64, device=dev)
    ended = torch.zeros(4, dtype=torch.int64, device=dev)
    ids = torch.nonzero(~(tmax < tmin)).squeeze(1)
    cell = origin_cells(sg, origin[ids])
    first = torch.full((r,), -1, dtype=torch.int64, device=dev)
    count = torch.zeros(r, dtype=torch.int64, device=dev)
    first[ids] = sg.offsets[cell].long()
    count[ids] = torch.clamp(sg.offsets[cell + 1].long() - first[ids], max=max_steps)

    def test(rows, idx):
        """Hits of rays idx against one row each."""
        o, d = origin[idx], direction[idx]
        col = lambda k: rows[:, k]  # noqa: E731
        t, u, v, ok, at = moller_trumbore((col(0), col(1), col(2)), (col(3), col(4), col(5)),
                                          (col(6), col(7), col(8)), (o[:, 0], o[:, 1], o[:, 2]),
                                          (d[:, 0], d[:, 1], d[:, 2]), stage=True)
        if stages:
            ended.add_(torch.bincount(at, minlength=4))
        ok &= (rows[:, 9] >= 0) & (t >= tmin[idx]) & (t <= tmax[idx])
        if hit_filter is not None and bool(ok.any()):
            cand = torch.nonzero(ok).squeeze(1)
            ok[cand] = hit_filter(rows[cand, 9].to(torch.int32), u[cand], v[cand])
        return ok

    def cells(live):
        """Each ray of `live` over its cell's entries, in lockstep."""
        start, n_test = first[live], count[live]
        k = 0
        while live.shape[0]:
            sel = n_test > k
            live, start, n_test = live[sel], start[sel], n_test[sel]
            if not live.shape[0]:
                break
            tested[live] += 1
            ok = test(sg.entries[start + k], live)
            hit[live[ok]] = True
            live, start, n_test = live[~ok], start[~ok], n_test[~ok]
            k += 1

    def big(rest):
        for i in range(int(sg.num_big)):
            if not rest.shape[0]:
                break
            tested[rest] += 1
            ok = test(sg.big[i].expand(rest.shape[0], ROW_W), rest)
            hit[rest[ok]] = True
            rest = rest[~ok]

    for walk in ((big, cells) if big_first else (cells, big)):
        walk(ids[~hit[ids]])
    if not visits:
        return hit
    return (hit, tested, ended) if stages else (hit, tested)


@functools.cache
def load_kernel():
    """Build K3 (on first use) and load it; returns its launch function."""
    fn = load_cuda_library("shadow_grid.cu").shadow_grid_trace_launch
    fn.restype = ctypes.c_int
    ptr, num, flt = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([ptr] * 4 + [num] + [ptr] * 3 + [ptr, flt, ptr, flt] + [num] * 4
                   + [ptr] * 2 + [num] * 2 + [ptr] * 2 + [num, ptr])
    return fn


def launch_args(sg: ShadowGrid, origin, direction, tmin, tmax, out,
                max_steps: int = MAX_STEPS, alpha_tables: shadetab.ShadeTables | None = None,
                width: int | None = None, stage_rows: int = STAGE_ROWS, stats=None):
    """The arguments of one K3 launch (load_kernel()(*args)) writing the
    (R,) bool `out`, on tensors trace_shadow has checked.  A Python float
    tmin / tmax goes by value, a tensor by pointer; the grid's num_big by
    pointer (the kernel reads it on the device).  `stats`: None, or a (2,)
    int64 CUDA tensor the kernel adds its lane-steps that tested a row and
    all its lane-steps to."""
    def scalar(t):
        return (t.data_ptr(), 0.0) if torch.is_tensor(t) else (None, float(t))

    if alpha_tables is None:
        tables = (None, None, 0, 0)
    else:
        tables = (alpha_tables.tri_static.data_ptr(), alpha_tables.atlas_q.data_ptr(),
                  alpha_tables.atlas_q.shape[0], alpha_tables.atlas_w)
    dev = origin.device
    return (sg.entries.data_ptr(), sg.offsets.data_ptr(), sg.big.data_ptr(),
            sg.num_big.data_ptr(), sg.grid, sg.frame.data_ptr(), origin.data_ptr(),
            direction.data_ptr(), *scalar(tmin), *scalar(tmax), origin.shape[0], width or 0,
            max_steps, stage_rows, *tables, out.data_ptr(),
            None if stats is None else stats.data_ptr(), dev.index, current_stream(dev.index))


def trace_shadow(sg: ShadowGrid, origin, direction, tmin, tmax, hit_filter=None,
                 strips: int = 32, max_steps: int = MAX_STEPS, *,
                 alpha_tables: shadetab.ShadeTables | None = None, width: int | None = None,
                 stage_rows: int = STAGE_ROWS):
    """Any-hit occlusion of near-parallel rays through the grid: (R,) bool,
    with the reference's signature.  origin / direction (R, 3) float32;
    tmin / tmax Python floats (passed to K3 by value) or (R,) float32
    tensors.  hit_filter: None or a filter of traverse.make_alpha_hit_filter,
    which stands for its shade tables (K3 runs the filter inside the walk);
    `strips` only steers the reference's TPU loop and is ignored.  The
    port's keywords: alpha_tables, the scene's shade tables for the alpha
    any-hit filter (None: every geometric hit counts); width: the rays are
    an image's pixels, row-major, `width` a row, and a K3 block takes a
    pixel tile of them, as the render path passes them (raygen); None, for
    callers of the reference's API that hold no image, a block takes
    consecutive rays.  stage_rows: the cell rows a K3 block stages in shared
    memory; the rest of a list is read from device memory.  The mask is the
    same for every strips, width and stage_rows."""
    alpha_tables = filter_tables("trace_shadow", hit_filter, alpha_tables)
    dev = origin.device
    r = origin.shape[0]
    if stage_rows < 0:
        raise ValueError(f"trace_shadow: stage_rows must be >= 0, got {stage_rows}")
    if dev.type == "cpu":
        def full(t):
            return torch.as_tensor(t, dtype=torch.float32).expand(r)

        return trace_shadow_plain(
            sg, origin, direction, full(tmin), full(tmax), max_steps,
            None if alpha_tables is None else make_alpha_hit_filter(None, alpha_tables),
            big_first=True)
    if dev.type != "cuda":
        raise ValueError(f"trace_shadow: unsupported device {dev}")
    checks = [("entries", sg.entries, (sg.num_entries, ROW_W), torch.float32),
              ("offsets", sg.offsets, (sg.grid * sg.grid + 1,), torch.int32),
              ("big", sg.big, (BIG_CAP, ROW_W), torch.float32),
              ("num_big", sg.num_big, (), torch.int32),
              ("frame", sg.frame, (10,), torch.float32),
              ("origin", origin, (r, 3), torch.float32),
              ("direction", direction, (r, 3), torch.float32)]
    checks += [(name, t, (r,), torch.float32) for name, t in (("tmin", tmin), ("tmax", tmax))
               if torch.is_tensor(t)]
    if alpha_tables is not None:
        ts, aq = alpha_tables.tri_static, alpha_tables.atlas_q
        checks += [("tri_static", ts, (ts.shape[0], shadetab._N_STATIC), torch.float32),
                   ("atlas_q", aq, (aq.shape[0], 16), torch.float32)]
    for name, t, shape, dtype in checks:
        if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(
                f"trace_shadow: {name} must be a contiguous {dtype} {shape} tensor on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty(r, dtype=torch.bool, device=dev)
    err = load_kernel()(*launch_args(sg, origin, direction, tmin, tmax, out, max_steps,
                                     alpha_tables, width, stage_rows))
    if err != 0:
        raise RuntimeError(f"shadow_grid kernel launch failed: CUDA error {err}")
    trace_shadow.launches += 1
    return out


trace_shadow.launches = 0
