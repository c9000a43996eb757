"""The reference's ray tracer: a four-wide box tree over the scene's exact
float32 triangles, walked ray by ray with a stack, in plain PyTorch.

Semantics (the JAX package's ``ops/traverse.py`` states them): Moller-
Trumbore with no face culling, a hit where |det| > 1e-9, u >= 0, v >= 0,
u + v <= 1 and tmin <= t < the nearest accepted t so far (tmax at first);
a closest-hit ray returns the nearest accepted hit and its (u, v), the
weights of vertices 1 and 2; an any-hit ray stops at its first accepted
hit; an optional filter accepts or rejects each candidate (the alpha test).
Which tree finds the hit does not change the answer, so the tree is the
reference's own: triangles sorted along a Morton curve of their centroids,
cut into leaves of equal size, and a complete four-way tree over the leaves.
"""
from __future__ import annotations

import dataclasses

import torch

LEAF_MAX = 8
CHUNK = 1 << 23  # rays a wavefront walks at once


@dataclasses.dataclass
class Tree:
    lo: torch.Tensor  # (nodes, 3) box corners, heap order: children of n are 4n+1..4n+4
    hi: torch.Tensor
    first_leaf: int
    leaf: int  # triangles a leaf
    tri: torch.Tensor  # (leaves * leaf,) triangle id, -1 padding
    v0: torch.Tensor  # (leaves * leaf, 3)
    v1: torch.Tensor
    v2: torch.Tensor
    depth: int


def _morton(c: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes of points in [0, 1)^3."""
    q = (c * 1024).long().clamp(0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


def build(tris: torch.Tensor) -> Tree:
    """tris: (T, 3, 3) world-space vertices."""
    dev = tris.device
    t = tris.shape[0]
    cen = tris.mean(1)
    lo_c, hi_c = cen.amin(0), cen.amax(0)
    order = torch.argsort(_morton((cen - lo_c) / (hi_c - lo_c).clamp_min(1e-12)), stable=True)
    depth = 0
    while t > LEAF_MAX * 4 ** depth:
        depth += 1
    leaves = 4 ** depth
    leaf = max(1, -(-t // leaves))
    slots = torch.full((leaves * leaf,), -1, dtype=torch.int64, device=dev)
    slots[:t] = order
    v = tris[slots.clamp_min(0)]
    pad = (slots < 0)[:, None, None]
    inf = torch.tensor(float("inf"), device=dev)
    lo = torch.where(pad, inf, v).amin(1).view(leaves, leaf, 3).amin(1)
    hi = torch.where(pad, -inf, v).amax(1).view(leaves, leaf, 3).amax(1)
    los, his = [lo], [hi]
    while los[0].shape[0] > 1:
        los.insert(0, los[0].view(-1, 4, 3).amin(1))
        his.insert(0, his[0].view(-1, 4, 3).amax(1))
    return Tree(lo=torch.cat(los), hi=torch.cat(his), first_leaf=(leaves - 1) // 3, leaf=leaf,
                tri=slots, v0=v[:, 0].contiguous(), v1=v[:, 1].contiguous(),
                v2=v[:, 2].contiguous(), depth=depth)


def trace(tree: Tree, origin, direction, tmin, tmax, anyhit: bool = False, accept=None):
    """(t, tri, u, v) of each ray, tri -1 and t tmax where none.  tmin and
    tmax: scalars or (R,); accept(ray, tri, u, v) -> bool, the filter."""
    r = origin.shape[0]
    dev = origin.device
    tmin = torch.broadcast_to(torch.as_tensor(tmin, dtype=torch.float32, device=dev), (r,))
    tmax = torch.broadcast_to(torch.as_tensor(tmax, dtype=torch.float32, device=dev), (r,))
    out = [torch.empty(r, device=dev), torch.empty(r, dtype=torch.int64, device=dev),
           torch.empty(r, device=dev), torch.empty(r, device=dev)]
    for s in range(0, r, CHUNK):
        e = min(r, s + CHUNK)
        got = _walk(tree, origin[s:e], direction[s:e], tmin[s:e].contiguous(),
                    tmax[s:e].contiguous(), anyhit,
                    None if accept is None else (lambda ray, *a, s=s: accept(ray + s, *a)))
        for o, g in zip(out, got):
            o[s:e] = g
    return tuple(out)


def _walk(tree, o, d, tmin, tmax, anyhit, accept):
    r = o.shape[0]
    dev = o.device
    inv = 1.0 / torch.where(d.abs() < 1e-12, torch.where(d >= 0, 1e-12, -1e-12), d)
    t_best = tmax.clone()
    tri_best = torch.full((r,), -1, dtype=torch.int64, device=dev)
    u_best = torch.zeros(r, device=dev)
    v_best = torch.zeros(r, device=dev)
    depth_cap = 3 * tree.depth + 2
    stack = torch.zeros((r, depth_cap + 1), dtype=torch.int64, device=dev)
    sp = torch.zeros(r, dtype=torch.int64, device=dev)
    node = torch.where(tmax >= tmin, 0, -1)
    lane = torch.arange(4, device=dev)
    while True:
        act = torch.nonzero(node >= 0).flatten()
        if not act.numel():
            break
        n = node[act]
        is_leaf = n >= tree.first_leaf
        # internal nodes: the four child boxes, nearest first
        ai = act[~is_leaf]
        if ai.numel():
            ch = 4 * node[ai][:, None] + 1 + lane  # (m, 4)
            lo, hi = tree.lo[ch], tree.hi[ch]
            oo, ii = o[ai][:, None], inv[ai][:, None]
            t0, t1 = (lo - oo) * ii, (hi - oo) * ii
            tn = torch.minimum(t0, t1).amax(-1)
            tf = torch.maximum(t0, t1).amin(-1)
            hit = (torch.maximum(tn, tmin[ai][:, None]) <= torch.minimum(tf, t_best[ai][:, None]))
            hit &= (lo <= hi).all(-1)
            key, idx = torch.sort(torch.where(hit, tn, torch.full_like(tn, float("inf"))), dim=1)
            cnt = hit.sum(1)
            ordered = torch.gather(ch, 1, idx)
            # push the 2nd..cnt-th nearest, farthest first; go to the nearest
            for j in (3, 2, 1):
                push = cnt > j
                col = torch.where(push, sp[ai], torch.full_like(sp[ai], depth_cap))
                stack[ai, col] = torch.where(push, ordered[:, j], stack[ai, col])
                sp[ai] += push.long()
            node[ai] = torch.where(cnt > 0, ordered[:, 0], torch.full_like(cnt, -2))
        # leaves: their triangles
        al = act[is_leaf]
        if al.numel():
            slot = (node[al] - tree.first_leaf)[:, None] * tree.leaf + torch.arange(tree.leaf,
                                                                                   device=dev)
            _leaf(tree, slot, al, o, d, tmin, t_best, tri_best, u_best, v_best, anyhit, accept)
            node[al] = -2
            if anyhit:
                done = al[tri_best[al] >= 0]
                node[done] = -1
        # pop where a node ended with nothing to go to
        pop = torch.nonzero(node == -2).flatten()
        if pop.numel():
            has = sp[pop] > 0
            top = stack[pop, (sp[pop] - 1).clamp_min(0)]
            node[pop] = torch.where(has, top, torch.full_like(top, -1))
            sp[pop] -= has.long()
    return t_best, tri_best, u_best, v_best


def _leaf(tree, slot, rays, o, d, tmin, t_best, tri_best, u_best, v_best, anyhit, accept):
    v0, v1, v2 = tree.v0[slot], tree.v1[slot], tree.v2[slot]  # (m, leaf, 3)
    oo, dd = o[rays][:, None], d[rays][:, None]
    e1, e2 = v1 - v0, v2 - v0
    p = torch.stack([dd[..., 1] * e2[..., 2] - dd[..., 2] * e2[..., 1],
                     dd[..., 2] * e2[..., 0] - dd[..., 0] * e2[..., 2],
                     dd[..., 0] * e2[..., 1] - dd[..., 1] * e2[..., 0]], -1)
    det = e1[..., 0] * p[..., 0] + e1[..., 1] * p[..., 1] + e1[..., 2] * p[..., 2]
    okd = det.abs() > 1e-9
    invdet = 1.0 / torch.where(okd, det, torch.ones_like(det))
    tv = oo - v0
    u = (tv[..., 0] * p[..., 0] + tv[..., 1] * p[..., 1] + tv[..., 2] * p[..., 2]) * invdet
    q = torch.stack([tv[..., 1] * e1[..., 2] - tv[..., 2] * e1[..., 1],
                     tv[..., 2] * e1[..., 0] - tv[..., 0] * e1[..., 2],
                     tv[..., 0] * e1[..., 1] - tv[..., 1] * e1[..., 0]], -1)
    v = (dd[..., 0] * q[..., 0] + dd[..., 1] * q[..., 1] + dd[..., 2] * q[..., 2]) * invdet
    t = (e2[..., 0] * q[..., 0] + e2[..., 1] * q[..., 1] + e2[..., 2] * q[..., 2]) * invdet
    tri = tree.tri[slot]
    ok = (okd & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (tri >= 0)
          & (t >= tmin[rays][:, None]) & (t < t_best[rays][:, None]))
    if accept is not None and bool(ok.any()):
        k = torch.nonzero(ok)
        keep = accept(rays[k[:, 0]], tri[k[:, 0], k[:, 1]], u[k[:, 0], k[:, 1]],
                      v[k[:, 0], k[:, 1]])
        ok[k[:, 0], k[:, 1]] = keep
    tm = torch.where(ok, t, torch.full_like(t, float("inf")))
    best, j = tm.min(1)
    upd = best < t_best[rays]
    r = rays[upd]
    j = j[upd]
    t_best[r] = best[upd]
    tri_best[r] = tri[upd, j]
    u_best[r] = u[upd, j]
    v_best[r] = v[upd, j]
