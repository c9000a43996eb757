"""Visibility buffer and homogeneous triangle setup (port of ``ops/rasterizer.py``).

Triangles are rastered from homogeneous screen coordinates with no near-plane
clipping: for vertex i with clip (x, y, z, w), X_i = (0.5x + 0.5w) * width and
Y_i = (0.5y + 0.5w) * height; with M = rows (X_i, Y_i, w_i) the functions
lambda_i/w are affine in screen space, plane_i = adjugate column i / det(M).
A pixel is covered when all three planes are >= 0 and the reverse-Z depth
plane lies in [0, 1], which doubles as the near / behind-camera clip.  The
visibility buffer keeps the winner's (l1, l2, l0+l1+l2); perspective-correct
weights are l / sum (weights_from_bary).

The brute reference rasterizer is not ported; the binned one
(ops/rasterizer_tiled.py) is the port's only raster path.
"""
from __future__ import annotations

import dataclasses
from typing import Any

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
