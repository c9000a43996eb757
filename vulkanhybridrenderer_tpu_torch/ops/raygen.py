"""Hybrid ray-trace pass (port of ``ops/raygen.py``): RT shadows, AO and
mirror reflections from the G-buffer (raygen.rgen:14-67, reflection_hit.rchit
and the miss shaders).

- RNG: seed_thread((y * H + x) * frame_index), xorshift draws in the
  reference's order: shadow rnd1, rnd2, then rnd1, rnd2 of each AO ray.
- Shadow: one direction in the cone around the light (cos_theta_max
  0.999995), traced any-hit through the BVH8 (K2) or, with
  ``shadow_accel="grid"``, the light-space shadow grid (K3); a miss is lit.
- AO: `ao_rays` cosine-hemisphere rays around N, tmax 5, traced any-hit as
  ONE wavefront of ao_rays * H * W rays; the result is the mean of misses.
- Reflection: the mirror reflect() of the camera ray, traced closest-hit and
  shaded by rt_shade.reflection_hit_shade; a miss is 0.
- Every ray starts at P + N * 0.1 with tmin 0.01.  Rays whose result cannot
  reach the image are dead (tmax = -1 < tmin, so K2 drops them at once): sky
  pixels, and shadow rays of pixels facing away from the light when denoise
  and reflections are off (composition multiplies the shadow by
  max(N.L, 0) = 0 there; SVGF and the reflection modes do read it, so then
  those rays stay live).  Channels no active mode reads are not traced
  (shadow / AO 1, reflections 0), as in the reference.
- Sky pixels are overridden after the trace: shadow_ao = (1, 1, 0, 1),
  reflections 0.

Rays are traced flat in image order: a GPU thread per ray needs none of the
reference's packet, strip or tiling schedules.
"""
from __future__ import annotations

import warnings

import torch

from vulkanhybridrenderer_tpu_torch.core.config import (
    AmbientOcclusionMode,
    HybridSettings,
    ReflectionMode,
    ShadowMode,
)
from vulkanhybridrenderer_tpu_torch.core.types import PerFrameData
from vulkanhybridrenderer_tpu_torch.ops import rt_shade, screen, shadowgrid, traverse
from vulkanhybridrenderer_tpu_torch.ops.bvh8 import BVH8
from vulkanhybridrenderer_tpu_torch.ops.sampling import (
    to_basis,
    uniform_sample_cone,
    uniform_sample_cosine_hemisphere,
)
from vulkanhybridrenderer_tpu_torch.utils import rng
from vulkanhybridrenderer_tpu_torch.utils.math3d import div, normalize, reflect

CONE_COS_THETA_MAX = 0.999995
SHADOW_TMIN = 0.01
SHADOW_TMAX = 10000.0
AO_TMAX = 5.0


def surface(pfd: PerFrameData, depth, normal_oid, rows: screen.Rows | None = None):
    """G-buffer surface per pixel: world position (H, W, 3), normal
    (H, W, 3) and the sky mask (depth == 0); depth and normals may be the
    `rows` of a taller image (a mesh shard's slab)."""
    h, w = depth.shape
    rows = rows or screen.Rows.whole(h)
    uv = screen.pixel_uv_grid(rows.height, w, depth.device, rows.start, h)
    p_world = screen.position_from_depth(depth, uv, pfd.camera_viewproj_inverse)
    n = normal_oid[:3].permute(1, 2, 0)
    return p_world, n, depth == 0.0


class Wavefronts:
    """Every ray of one frame's raytrace pass in image order (R = H * W):
    `origin` (R, 3); the shadow rays' `shadow_dir` (R, 3) and `shadow_tmax`
    (R,); the AO rays' `ao_dir` (ao_rays * R, 3), ray k of pixel i at
    k * R + i, and `ao_tmax` (R,); the reflection rays' `refl_dir` (R, 3)
    and `refl_tmax` (R,).  tmax is -1 for dead rays.  The AO and reflection
    rays are made only when `settings` traces them (else None); `settings`
    None traces all three kinds and keeps every lit pixel's shadow ray.
    With `rows`, depth and normals are those rows of a taller image (a mesh
    shard's slab): its pixels' rays, seeded as in the whole image."""

    def __init__(self, pfd: PerFrameData, depth, normal_oid,
                 settings: HybridSettings | None = None, ao_rays: int = 2,
                 rows: screen.Rows | None = None):
        h, w = depth.shape
        rows = rows or screen.Rows.whole(h)
        p_world, n, sky = surface(pfd, depth, normal_oid, rows)
        sky_flat = sky.reshape(-1)
        n_flat = n.reshape(-1, 3)
        l = -pfd.directional_light.direction[:3]
        self.origin = (p_world + n * 0.1).reshape(-1, 3).contiguous()

        state = rng.pixel_seed(w, rows.height, pfd.frame_index, depth.device, rows.start, h)
        state, r1 = rng.random01(state)
        state, r2 = rng.random01(state)
        u2 = torch.stack([r1, r2], dim=-1).reshape(-1, 2)
        cone = normalize(uniform_sample_cone(u2, CONE_COS_THETA_MAX))
        self.shadow_dir = to_basis(l.expand(h * w, 3), cone).contiguous()
        tmax = torch.where(sky_flat, -1.0, SHADOW_TMAX)
        if (settings is not None and not settings.denoise
                and settings.reflection_mode == ReflectionMode.OFF):
            ndl = torch.sum(n_flat * l, dim=-1)
            tmax = torch.where(ndl <= 0.0, -1.0, tmax)
        self.shadow_tmax = tmax.contiguous()

        self.ao_dir = self.ao_tmax = self.refl_dir = self.refl_tmax = None
        if settings is None or settings.ao_mode == AmbientOcclusionMode.RAYTRACED:
            dirs = []
            for _ in range(ao_rays):
                state, r1 = rng.random01(state)
                state, r2 = rng.random01(state)
                u2 = torch.stack([r1, r2], dim=-1).reshape(-1, 2)
                dirs.append(to_basis(n_flat, uniform_sample_cosine_hemisphere(u2)))
            self.ao_dir = torch.cat(dirs).contiguous()
            self.ao_tmax = torch.where(sky_flat, -1.0, AO_TMAX).contiguous()
        if settings is None or settings.reflection_mode == ReflectionMode.RAYTRACED:
            i_dir = normalize(p_world - pfd.camera_position).reshape(-1, 3)
            self.refl_dir = reflect(i_dir, n_flat).contiguous()
            self.refl_tmax = torch.where(sky_flat, -1.0, SHADOW_TMAX).contiguous()


def hybrid_raytrace(scene, tables, tri_rows, bvh: BVH8 | None, tri_verts,
                    pfd: PerFrameData, depth, normal_oid, ao_rays: int = 2,
                    settings: HybridSettings | None = None,
                    shadow_grid: shadowgrid.ShadowGrid | None = None, mesh=None):
    """depth (H, W), normal_oid (4, H, W) -> ("Raytraced Shadows and Ambient
    Occlusion" (4, H, W), "Raytraced Reflections" (4, H, W)).  The
    reference's signature: `tri_verts` (the world triangles) is accepted and
    not read, as in the reference, since the BVH8's leaf rows hold the
    vertices.  `settings` None traces shadows, AO and reflections; otherwise
    the kinds no active mode reads are not traced.  With `shadow_grid`
    (``shadow_accel="grid"``) the shadow rays go through the light-space
    grid (K3) instead of the BVH8, with the same hit / miss answers; `bvh`
    may then be None when nothing else is traced.  With a `mesh`
    (parallel/mesh.py) of N > 1 shards whose count divides H, each row
    slab runs ``raytrace_rows`` on its shard's device (its rays seeded as in
    the whole image, each wavefront traced there, K2 or K3, and its hits
    shaded there, over the mesh's replicas of the tables), and the slabs'
    images are gathered onto the primary, which gives mesh=None's
    outputs exactly.  (The mesh frame runs raytrace_rows itself and keeps
    the slabs on the shards.)  Where N does not divide H, everything runs on
    depth's device, as in the reference, and a warning says so.  Over a
    mesh, depth and normal_oid lie on its primary, where the outputs come
    back."""
    h = depth.shape[0]
    n_dev = mesh.devices.size if mesh is not None else 1
    if n_dev > 1 and h % n_dev == 0:
        slabs = []
        for i in range(n_dev):
            sc, tab, rows_t, b, f, grid = (mesh.replicate(x)[i] for x in (
                scene, tables, tri_rows, bvh, pfd, shadow_grid))
            slabs.append(raytrace_rows(sc, tab, rows_t, b, f, mesh.slab(depth, i),
                                       mesh.slab(normal_oid, i), ao_rays, settings, grid,
                                       rows=mesh.rows(i, h)))
        return tuple(mesh.gather(list(parts)) for parts in zip(*slabs))
    if n_dev > 1:
        warnings.warn(f"hybrid_raytrace: {h} trace rows do not divide over the mesh's "
                      f"{n_dev} shards; the rays are traced on {depth.device} alone, as the "
                      "reference's mesh does")
    return raytrace_rows(scene, tables, tri_rows, bvh, pfd, depth, normal_oid, ao_rays,
                         settings, shadow_grid)


def raytrace_rows(scene, tables, tri_rows, bvh: BVH8 | None, pfd: PerFrameData, depth,
                  normal_oid, ao_rays: int = 2, settings: HybridSettings | None = None,
                  shadow_grid: shadowgrid.ShadowGrid | None = None,
                  rows: screen.Rows | None = None):
    """hybrid_raytrace's body on one device: depth (h, W) and normal_oid
    (4, h, W) are the `rows` of the trace image (all of it by default),
    every other argument on their device.  Each pixel's rays are those of
    the whole image (Wavefronts with `rows`) and K2 and K3 give each ray
    the answer it gets in any wavefront, so a slab's outputs are those rows
    of the whole image's."""
    h, w = depth.shape
    dev = depth.device
    rays = Wavefronts(pfd, depth, normal_oid, settings, ao_rays, rows)
    ones = torch.ones((h, w), dtype=torch.float32, device=dev)

    def trace(origin, direction, tmax, anyhit, rays_per_pixel=1):
        if rays_per_pixel > 1:
            origin, tmax = origin.repeat(rays_per_pixel, 1), tmax.repeat(rays_per_pixel)
        return traverse.trace(bvh, None, origin, direction, SHADOW_TMIN, tmax, anyhit=anyhit)

    if settings is None or settings.shadow_mode == ShadowMode.RAYTRACED:
        if shadow_grid is not None:
            hit = shadowgrid.trace_shadow(shadow_grid, rays.origin, rays.shadow_dir,
                                          SHADOW_TMIN, rays.shadow_tmax, width=w)
        else:
            hit = trace(rays.origin, rays.shadow_dir, rays.shadow_tmax, anyhit=True).hit
        shadow = torch.where(hit, 0.0, 1.0).reshape(h, w)
    else:
        shadow = ones

    if rays.ao_dir is not None:
        rec = trace(rays.origin, rays.ao_dir, rays.ao_tmax, anyhit=True,
                    rays_per_pixel=ao_rays)
        miss = torch.where(rec.hit, 0.0, 1.0).reshape(ao_rays, h, w)
        ao = div(torch.sum(miss, dim=0), ao_rays)
    else:
        ao = ones

    sky = depth == 0.0
    if rays.refl_dir is not None:
        rec = trace(rays.origin, rays.refl_dir, rays.refl_tmax, anyhit=False)
        shaded = rt_shade.reflection_hit_shade(
            scene, tables, tri_rows, pfd, rec.tri, rec.u, rec.v
        )
        refl = torch.where(rec.hit[:, None], shaded, 0.0).reshape(h, w, 4)
        refl = torch.where(sky[..., None], 0.0, refl).permute(2, 0, 1).contiguous()
    else:
        refl = torch.zeros((4, h, w), dtype=torch.float32, device=dev)

    shadow = torch.where(sky, 1.0, shadow)
    ao = torch.where(sky, 1.0, ao)
    shadow_ao = torch.stack([shadow, ao, torch.zeros_like(shadow), ones], dim=0)
    return shadow_ao, refl
