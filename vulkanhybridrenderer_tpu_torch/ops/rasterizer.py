"""Visibility buffer and homogeneous triangle setup (port of ``ops/rasterizer.py``).

Triangles are rastered from homogeneous screen coordinates with no near-plane
clipping: for vertex i with clip (x, y, z, w), X_i = (0.5x + 0.5w) * width and
Y_i = (0.5y + 0.5w) * height; with M = rows (X_i, Y_i, w_i) the functions
lambda_i/w are affine in screen space, plane_i = adjugate column i / det(M).
A pixel is covered when all three planes are >= 0 and the reverse-Z depth
plane lies in [0, 1], which doubles as the near / behind-camera clip.  The
visibility buffer keeps the winner's (l1, l2, l0+l1+l2); perspective-correct
weights are l / sum (weights_from_bary).

``rasterize`` is the brute reference rasterizer (``config.raster="brute"``):
every triangle against every pixel, in chunks of triangles and bands of
rows, with the depth-compare presets of RasterState.  The binned raster
(ops/rasterizer_tiled.py) is the production path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from vulkanhybridrenderer_tpu_torch.utils.math3d import cross, div


@dataclasses.dataclass(frozen=True)
class VisibilityBuffer:
    tri_id: Any  # (H, W) int32, -1 = none
    depth: Any  # (H, W) float32 reverse-Z (0 = far / clear)
    bary: Any  # (H, W, 3) winner's (l1, l2, l0 + l1 + l2)


@dataclasses.dataclass(frozen=True)
class TriangleSetup:
    #: (T, 12) affine screen planes [l0 A,B,C | l1 A,B,C | l2 A,B,C | z A,B,C],
    #: evaluated as A*px + B*py + C at pixel centers
    planes: Any
    sx: Any  # (T, 3) projected screen x (w-clamped)
    sy: Any  # (T, 3)
    #: (T, 4) conservative screen bbox [xmin, ymin, xmax, ymax] of the visible
    #: projection, correct for any clip-w signs
    bbox: Any
    w_any: Any  # (T,) some clip w > eps (else never visible)
    front: Any  # (T,) front-facing (det < 0: the baked y-flip convention)
    valid: Any  # (T,) non-degenerate


def weights_from_bary(bary, eps: float = 1e-12):
    """(..., 3) visibility bary -> perspective-correct vertex weights."""
    s = bary[..., 2]
    inv = 1.0 / torch.where(torch.abs(s) > eps, s, torch.ones_like(s))
    l1 = bary[..., 0] * inv
    l2 = bary[..., 1] * inv
    return torch.stack([1.0 - l1 - l2, l1, l2], dim=-1)


def triangle_setup(clip, tri_vertex, width: int, height: int) -> TriangleSetup:
    """clip: (V, 4) clip-space vertices; tri_vertex: (T, 3) vertex ids."""
    v = clip[tri_vertex.long()]  # (T, 3, 4)
    x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    X = (0.5 * x + 0.5 * w) * width
    Y = (0.5 * y + 0.5 * w) * height
    w_ok = torch.all(w > 1e-6, dim=-1)
    w_any = torch.any(w > 1e-6, dim=-1)
    safe_w = torch.where(torch.abs(w) > 1e-6, w, torch.full_like(w, 1e-6))
    sx = X / safe_w
    sy = Y / safe_w

    # centroid-centered coordinates condition the adjugate; the translation
    # is folded back into the constant term
    zero = torch.zeros_like(w_ok, dtype=torch.float32)
    cx = torch.where(w_ok, div(sx[:, 0] + sx[:, 1] + sx[:, 2], 3.0), zero)
    cy = torch.where(w_ok, div(sy[:, 0] + sy[:, 1] + sy[:, 2], 3.0), zero)
    Xc = X - cx[:, None] * w
    Yc = Y - cy[:, None] * w

    def cross_rows(j, k):
        a = torch.stack([Xc[:, j], Yc[:, j], w[:, j]], dim=-1)
        b = torch.stack([Xc[:, k], Yc[:, k], w[:, k]], dim=-1)
        return cross(a, b)

    adj0 = cross_rows(1, 2)
    adj1 = cross_rows(2, 0)
    adj2 = cross_rows(0, 1)
    det = Xc[:, 0] * adj0[:, 0] + Yc[:, 0] * adj0[:, 1] + w[:, 0] * adj0[:, 2]
    valid = torch.abs(det) > 1e-18
    inv_det = 1.0 / torch.where(valid, det, torch.ones_like(det))

    def plane(adj):
        a = adj[:, 0] * inv_det
        b = adj[:, 1] * inv_det
        c = adj[:, 2] * inv_det - a * cx - b * cy
        return a, b, c

    a0, b0, c0 = plane(adj0)
    a1, b1, c1 = plane(adj1)
    a2, b2, c2 = plane(adj2)
    za = a0 * z[:, 0] + a1 * z[:, 1] + a2 * z[:, 2]
    zb = b0 * z[:, 0] + b1 * z[:, 1] + b2 * z[:, 2]
    zc = c0 * z[:, 0] + c1 * z[:, 1] + c2 * z[:, 2]
    planes = torch.stack([a0, b0, c0, a1, b1, c1, a2, b2, c2, za, zb, zc], dim=-1)
    # poison invalid planes so they can never cover
    planes = torch.where(valid[:, None], planes, torch.zeros_like(planes))
    planes[:, 2] = torch.where(valid, planes[:, 2], torch.full_like(det, -1.0))

    # Conservative bbox for any w signs: hull of the projected w > eps
    # vertices plus, for edges crossing w = eps, the crossing point projected
    # at w = eps.  Fully-behind triangles get an empty bbox.
    eps = 1e-6
    big = 3.0e38
    in_front = w > eps
    bxmin = torch.where(in_front, sx, big).amin(dim=-1)
    bxmax = torch.where(in_front, sx, -big).amax(dim=-1)
    bymin = torch.where(in_front, sy, big).amin(dim=-1)
    bymax = torch.where(in_front, sy, -big).amax(dim=-1)
    for i, j in ((0, 1), (1, 2), (2, 0)):
        crosses = in_front[:, i] ^ in_front[:, j]
        dw = w[:, j] - w[:, i]
        tt = (eps - w[:, i]) / torch.where(torch.abs(dw) > 1e-20, dw, torch.ones_like(dw))
        cxp = div(X[:, i] + tt * (X[:, j] - X[:, i]), eps)
        cyp = div(Y[:, i] + tt * (Y[:, j] - Y[:, i]), eps)
        bxmin = torch.where(crosses, torch.minimum(bxmin, cxp), bxmin)
        bxmax = torch.where(crosses, torch.maximum(bxmax, cxp), bxmax)
        bymin = torch.where(crosses, torch.minimum(bymin, cyp), bymin)
        bymax = torch.where(crosses, torch.maximum(bymax, cyp), bymax)
    bbox = torch.stack([bxmin, bymin, bxmax, bymax], dim=-1)
    return TriangleSetup(
        planes=planes.contiguous(), sx=sx, sy=sy, bbox=bbox, w_any=w_any,
        front=det < 0, valid=valid,
    )


#: elements of one (triangles, rows, width) block of the brute rasterizer,
#: which bounds its memory (each float32 plane of a block takes 4 bytes an
#: element; a block with a fragment mask takes a quarter as many elements,
#: for the mask's atlas taps) and changes no value
BRUTE_BLOCK_ELEMENTS = 1 << 26
DEPTH_COMPARES = ("greater_equal", "less_equal", "always")


def rasterize(setup: TriangleSetup, width: int, height: int, chunk: int = 64,
              cull_backface: bool = True, frag_mask_fn: Callable | None = None,
              depth_compare: str = "greater_equal", depth_clear: float = 0.0
              ) -> VisibilityBuffer:
    """The brute reference rasterizer (the reference's ``rasterize``,
    rasterizer.py:195-280): every triangle is tested at every pixel centre,
    and the depth compare merges the fragments in submission order, ties
    going to the later triangle.

    Sized statically, as the reference is: the T triangles go in
    ceil(T / chunk) chunks, padded to equal sizes (as even as the count
    allows; the sizes come from T alone), and culled, degenerate and
    padding lanes are masked (the reference's ``val & (tri_ids < T)``), so
    nothing is read back from the device and a CUDA graph can hold the
    whole raster.  The reference merges one triangle at a time.  The merge
    here is one step a block, with the same result, since a masked lane
    never wins: with greater_equal the last fragment to pass is the
    lexicographic maximum of (z, triangle) over the covering fragments with
    z >= the clear depth, with less_equal the minimum z with the largest
    triangle, with always the last covering triangle.  A block is a chunk
    of triangles by as many rows as keep it near BRUTE_BLOCK_ELEMENTS
    elements, so memory stays bounded at any size (a 4096^2 shadow map
    never holds a (chunk, 4096, 4096) plane); neither changes a value.

    frag_mask_fn(tri_ids (C,), wts (C, rows, W, 3)) -> keep (C, rows, W)
    bool: the optional per-fragment kill (the alpha mask discard,
    gbuffer.make_alpha_frag_mask), evaluated densely over a block's
    fragments as the reference's is over (C, H, W), with the
    perspective-correct weights (l0, l1, l2) / (l0 + l1 + l2).  Padding
    lanes are asked about the last triangle (the reference's gather clamps
    their ids alike); their answer is masked."""
    if depth_compare not in DEPTH_COMPARES:
        raise ValueError(f"unknown depth_compare {depth_compare!r}")
    dev = setup.planes.device
    t = setup.planes.shape[0]
    keep = setup.valid & setup.front if cull_backface else setup.valid
    n_chunks = -(-t // chunk)
    size = -(-t // n_chunks) if n_chunks else chunk  # lanes a chunk
    pad = n_chunks * size - t
    planes = torch.cat([setup.planes, setup.planes.new_zeros((pad, 12))])
    val = torch.cat([keep, keep.new_zeros(pad)])  # padding lanes never cover
    best_z = torch.full((height, width), float(depth_clear), dtype=torch.float32, device=dev)
    best_tri = torch.full((height, width), -1, dtype=torch.int32, device=dev)
    best_b1 = torch.zeros((height, width), dtype=torch.float32, device=dev)
    best_b2 = torch.zeros((height, width), dtype=torch.float32, device=dev)
    best_s = torch.ones((height, width), dtype=torch.float32, device=dev)
    px = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    lanes = torch.arange(size, dtype=torch.int32, device=dev)
    order = lanes + 1
    block = BRUTE_BLOCK_ELEMENTS if frag_mask_fn is None else BRUTE_BLOCK_ELEMENTS // 4
    band = max(1, block // (size * width))
    for c0 in range(0, n_chunks * size, size):
        cids = lanes + c0
        p = planes[c0:c0 + size][:, :, None, None]  # (C, 12, 1, 1)
        v = val[c0:c0 + size][:, None, None]
        for y0 in range(0, height, band):
            y1 = min(height, y0 + band)
            py = (torch.arange(y0, y1, dtype=torch.float32, device=dev) + 0.5)[:, None]

            def ev(k):  # (a * px + b * py) + c, the reference's order
                return (p[:, k] * px + p[:, k + 1] * py) + p[:, k + 2]

            l0, l1, l2, z = ev(0), ev(3), ev(6), ev(9)  # (C, rows, W)
            inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & (z >= 0.0) & (z <= 1.0) & v
            if frag_mask_fn is not None:
                s = (l0 + l1) + l2
                inv = 1.0 / torch.where(torch.abs(s) > 1e-12, s, torch.ones_like(s))
                wts = torch.stack([l0 * inv, l1 * inv, l2 * inv], dim=-1)
                inside &= frag_mask_fn(torch.clamp(cids, max=t - 1), wts)
            any_in = inside.any(dim=0)
            if depth_compare == "greater_equal":
                zw = torch.where(inside, z, -torch.inf).amax(dim=0)
                cand = inside & (z == zw)
                better = any_in & (zw >= best_z[y0:y1])
            elif depth_compare == "less_equal":
                zw = torch.where(inside, z, torch.inf).amin(dim=0)
                cand = inside & (z == zw)
                better = any_in & (zw <= best_z[y0:y1])
            else:
                cand, better = inside, any_in
            # the last candidate of the block in submission order
            j = (torch.where(cand, order[:, None, None], 0).amax(dim=0) - 1).clamp(min=0)
            pick = lambda a: a.gather(0, j[None].long())[0]  # noqa: E731
            w0, w1, w2 = pick(l0), pick(l1), pick(l2)
            for best, new in ((best_z, pick(z)), (best_tri, cids[j.long()]), (best_b1, w1),
                              (best_b2, w2), (best_s, (w0 + w1) + w2)):
                best[y0:y1] = torch.where(better, new, best[y0:y1])
    return VisibilityBuffer(tri_id=best_tri, depth=best_z,
                            bary=torch.stack([best_b1, best_b2, best_s], dim=-1))
