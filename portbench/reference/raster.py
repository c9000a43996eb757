"""The reference's rasterizer: a visibility buffer by plain scatter.

Semantics (the JAX package's ``ops/rasterizer.py`` states them): each
triangle's homogeneous screen planes, so that no near-plane clipping is
needed; a pixel centre is covered where its three plane values are >= 0 and
its NDC depth lies in [0, 1]; reverse-Z, the greater depth wins, and of
equal depths the later triangle; back faces (plane determinant >= 0) culled;
an alpha-masked fragment killed where its texture's alpha is under the
cutoff.  The buffer keeps the winner's raw plane values (l1, l2, l0+l1+l2).

Here every (triangle, pixel) pair of each triangle's screen box is tested,
in bounded batches, and the winner of each pixel is the maximum of
(depth bits, triangle id), one scatter a batch.
"""
from __future__ import annotations

import torch

PAIRS = 1 << 24  # (triangle, pixel) pairs a batch


def setup(clip: torch.Tensor, tri_vertex: torch.Tensor, width: int, height: int) -> dict:
    """Planes (T, 12) [l0 a b c | l1 | l2 | z], the screen box (T, 4) of
    what can be covered, and which triangles are non-degenerate and front."""
    v = clip[tri_vertex]  # (T, 3, 4)
    x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    X = (0.5 * x + 0.5 * w) * width
    Y = (0.5 * y + 0.5 * w) * height
    w_ok = (w > 1e-6).all(-1)
    safe_w = torch.where(w.abs() > 1e-6, w, torch.full_like(w, 1e-6))
    sx, sy = X / safe_w, Y / safe_w
    zero = torch.zeros_like(sx[:, 0])
    cx = torch.where(w_ok, sx.mean(-1), zero)
    cy = torch.where(w_ok, sy.mean(-1), zero)
    Xc = X - cx[:, None] * w
    Yc = Y - cy[:, None] * w
    rows = [torch.stack([Xc[:, i], Yc[:, i], w[:, i]], -1) for i in range(3)]
    adj = [torch.linalg.cross(rows[1], rows[2]), torch.linalg.cross(rows[2], rows[0]),
           torch.linalg.cross(rows[0], rows[1])]
    det = Xc[:, 0] * adj[0][:, 0] + Yc[:, 0] * adj[0][:, 1] + w[:, 0] * adj[0][:, 2]
    valid = det.abs() > 1e-18
    inv = 1.0 / torch.where(valid, det, torch.ones_like(det))
    planes = []
    for a in adj:
        pa, pb = a[:, 0] * inv, a[:, 1] * inv
        planes += [pa, pb, a[:, 2] * inv - pa * cx - pb * cy]
    za = planes[0] * z[:, 0] + planes[3] * z[:, 1] + planes[6] * z[:, 2]
    zb = planes[1] * z[:, 0] + planes[4] * z[:, 1] + planes[7] * z[:, 2]
    zc = planes[2] * z[:, 0] + planes[5] * z[:, 1] + planes[8] * z[:, 2]
    planes = torch.stack(planes + [za, zb, zc], -1)
    planes = torch.where(valid[:, None], planes, torch.zeros_like(planes))
    # the box: projected vertices in front, and where an edge crosses w = eps
    eps, big = 1e-6, 3.0e38
    front_v = w > eps
    inf = torch.full_like(sx, big)
    box = [torch.where(front_v, sx, inf).amin(-1), torch.where(front_v, sy, inf).amin(-1),
           torch.where(front_v, sx, -inf).amax(-1), torch.where(front_v, sy, -inf).amax(-1)]
    for i, j in ((0, 1), (1, 2), (2, 0)):
        crosses = front_v[:, i] ^ front_v[:, j]
        dw = w[:, j] - w[:, i]
        tt = (eps - w[:, i]) / torch.where(dw.abs() > 1e-20, dw, torch.ones_like(dw))
        px = (X[:, i] + tt * (X[:, j] - X[:, i])) / eps
        py = (Y[:, i] + tt * (Y[:, j] - Y[:, i])) / eps
        box = [torch.where(crosses, torch.minimum(box[0], px), box[0]),
               torch.where(crosses, torch.minimum(box[1], py), box[1]),
               torch.where(crosses, torch.maximum(box[2], px), box[2]),
               torch.where(crosses, torch.maximum(box[3], py), box[3])]
    return {"planes": planes, "box": torch.stack(box, -1), "valid": valid, "front": det < 0,
            "any_front": front_v.any(-1)}


def rasterize(st: dict, width: int, height: int, cull_back: bool = True, keep=None) -> dict:
    """The visibility buffer: tri (H, W) int64 (-1 none), depth (H, W)
    (0 where none), bary (H, W, 3).  keep(tri, l0, l1, l2) -> bool: the
    fragment test of each covered pair (the alpha kill), or None."""
    planes = st["planes"]
    dev = planes.device
    live = st["valid"] & st["any_front"]
    if cull_back:
        live = live & st["front"]
    box = torch.nan_to_num(st["box"], nan=0.0, posinf=3e38, neginf=-3e38)
    x0 = torch.clamp(torch.floor(box[:, 0]) - 1, 0, width - 1).long()
    y0 = torch.clamp(torch.floor(box[:, 1]) - 1, 0, height - 1).long()
    x1 = torch.clamp(torch.ceil(box[:, 2]) + 1, -1, width - 1).long()
    y1 = torch.clamp(torch.ceil(box[:, 3]) + 1, -1, height - 1).long()
    bw = (x1 - x0 + 1).clamp_min(0)
    area = torch.where(live, bw * (y1 - y0 + 1).clamp_min(0), torch.zeros_like(bw))
    tris = torch.nonzero(area > 0).flatten()
    best = torch.full((height * width,), -1, dtype=torch.int64, device=dev)
    if tris.numel():
        counts = area[tris]
        ends = torch.cumsum(counts, 0).cpu()
        lo, n = 0, len(tris)
        while lo < n:  # batches of whole triangles, at most PAIRS pairs or one triangle
            base = int(ends[lo - 1]) if lo else 0
            hi = max(int(torch.searchsorted(ends, base + PAIRS, right=True)), lo + 1)
            _scatter(best, planes, tris[lo:hi], counts[lo:hi], x0, y0, bw, width, keep)
            lo = hi
    hit = best >= 0
    tri = torch.where(hit, best & 0xFFFFFFFF, torch.full_like(best, -1))
    depth = torch.where(hit, (best >> 32).to(torch.int32).view(torch.float32),
                        torch.zeros((), device=dev))
    # the winner's raw plane values at its pixel
    pix = torch.arange(height * width, device=dev)
    p = planes[tri.clamp_min(0)]
    fx = (pix % width).float() + 0.5
    fy = torch.div(pix, width, rounding_mode="floor").float() + 0.5
    l = [p[:, k] * fx + p[:, k + 1] * fy + p[:, k + 2] for k in (0, 3, 6)]
    bary = torch.stack([l[1], l[2], l[0] + l[1] + l[2]], -1)
    bary = torch.where(hit[:, None], bary, torch.tensor([0.0, 0.0, 1.0], device=dev))
    return {"tri": tri.view(height, width), "depth": depth.view(height, width),
            "bary": bary.view(height, width, 3)}


def _scatter(best, planes, tris, counts, x0, y0, bw, width, keep) -> None:
    dev = planes.device
    t = torch.repeat_interleave(tris, counts)
    start = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    k = torch.arange(t.numel(), device=dev) - start
    w = bw[t]
    px = x0[t] + k % w
    py = y0[t] + torch.div(k, w, rounding_mode="floor")
    fx, fy = px.float() + 0.5, py.float() + 0.5
    p = planes[t]
    l0 = p[:, 0] * fx + p[:, 1] * fy + p[:, 2]
    l1 = p[:, 3] * fx + p[:, 4] * fy + p[:, 5]
    l2 = p[:, 6] * fx + p[:, 7] * fy + p[:, 8]
    z = p[:, 9] * fx + p[:, 10] * fy + p[:, 11] + 0.0  # -0.0 as +0.0
    inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & (z >= 0.0) & (z <= 1.0)
    sel = torch.nonzero(inside).flatten()
    if keep is not None and sel.numel():
        ok = keep(t[sel], l0[sel], l1[sel], l2[sel])
        sel = sel[ok]
    if not sel.numel():
        return
    key = (z[sel].view(torch.int32).to(torch.int64) << 32) | t[sel]
    best.scatter_reduce_(0, py[sel] * width + px[sel], key, reduce="amax")
