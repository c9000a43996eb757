"""The reference's frames: the benchmark's plain renderer of the cells'
paths, written from the renderer's semantics and independent of the
program's code (``PERF.md`` says how it was checked).

``Reference(scene, settings, path, width, height, device)``: `scene` a
``scene.RefScene``, `settings` the cell's ``render_config`` mapping.
``frame(pose, prev_pose, frame_index, state)`` renders one frame at `pose`,
`prev_pose` the frame before it, and returns it with the SVGF history the
next frame reads (`state` the one this frame reads, None: empty; None on a
path that carries none, ``stateful`` False).  With ``lowp`` the frame is
computed at bfloat16, the control one precision below the float32 the
configurations state: every float image a pass writes, the rays' origins
and directions and the hits' attributes are rounded to bfloat16 before the
next step reads them.

Supported: the hybrid path (ray-traced or rasterized shadows, ray-traced or
screen-space AO, ray-traced reflections or none, SVGF, rt_scale 1, the
alpha kill on or off) and the raytraced path (with or without the alpha
test).
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import raster, shading, trace
from portbench.reference.scene import RefScene, perspective

SKY = (0.3, 0.8, 0.2, 1.0)
HYBRID = {"shadow_mode": "RAYTRACED", "ao_mode": "OFF", "reflection_mode": "OFF",
          "denoise": False, "rt_scale": 1, "ssao": {"radius": 0.75}}


def _lowp(x):
    return x.to(torch.bfloat16).to(torch.float32) if x.dtype == torch.float32 else x


class Reference:
    def __init__(self, scene: RefScene, settings: dict, path: str, width: int, height: int,
                 device):
        self.device = torch.device(device)
        self.sc = scene.to(self.device)
        self.path, self.width, self.height = path, int(width), int(height)
        s = dict(settings)
        self.hybrid = {**HYBRID, **s.get("hybrid", {})}
        self.hybrid["ssao"] = {**HYBRID["ssao"], **self.hybrid.get("ssao", {})}
        self.ao_rays = int(s.get("ao_rays", 2))
        self.shadow_map_size = int(s.get("shadow_map_size", 4096))
        self.alpha_raster = s.get("alpha_raster", "brute") != "off"
        self.test_alpha = bool(s.get("raytraced", {}).get("test_alpha", False))
        if path not in ("hybrid", "raytraced"):
            raise NotImplementedError(f"the reference has no {path!r} path")
        if int(self.hybrid["rt_scale"]) != 1 or "SSR" in (self.hybrid["reflection_mode"],):
            raise NotImplementedError("the reference traces at full resolution, no SSR")
        sc = self.sc
        # world-space vertices: each vertex's primitive's model matrix
        prim_of_v = torch.zeros(sc.positions.shape[0], dtype=torch.int64, device=self.device)
        prim_of_v[sc.tri_vertex.flatten()] = sc.tri_prim.repeat_interleave(3)
        xf = sc.transform[prim_of_v]
        p = sc.positions
        self.world = (xf[:, :3, 0] * p[:, 0:1] + xf[:, :3, 1] * p[:, 1:2]
                      + xf[:, :3, 2] * p[:, 2:3] + xf[:, :3, 3])
        self.masked = bool((sc.alpha_mask & (sc.base_tex >= 0)).any())
        self.tree = None
        if path == "raytraced" or self._rt_needed():
            self.tree = trace.build(self.world[sc.tri_vertex])

    @property
    def stateful(self) -> bool:
        """Whether a frame reads the history the frame before it left."""
        return self.path == "hybrid" and bool(self.hybrid["denoise"]) and self._rt_needed()

    # ----------------------------------------------------------- per frame ---
    def _rt_needed(self) -> bool:
        h = self.hybrid
        return "RAYTRACED" in (h["shadow_mode"], h["ao_mode"], h["reflection_mode"])

    def frame_data(self, pose, prev_pose, frame_index: int) -> dict:
        cam, lt = self.sc.camera, self.sc.light
        proj = perspective(cam.yfov, self.width / self.height, cam.znear)
        view = cam.view(pose.position, pose.yaw, pose.pitch)
        prev = cam.view(prev_pose.position, prev_pose.yaw, prev_pose.pitch)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        view_inv = np.linalg.inv(view).astype(np.float32)
        return {
            "view": t(view), "proj": t(proj), "view_inv": t(view_inv),
            "proj_inv": t(np.linalg.inv(proj)),
            "viewproj": t(proj) @ t(view),
            "viewproj_inv": t(np.linalg.inv((proj @ view).astype(np.float32))),
            "prev_viewproj": t(proj) @ t(prev),
            "camera_pos": t(view_inv[:3, 3]), "to_light": t(-lt.direction),
            "light_color": t(lt.color), "light_intensity": t(np.full(3, lt.intensity)),
            "light_projview": t(lt.projview), "frame_index": int(frame_index),
        }

    def _alpha_ok(self, tri, w):
        """False where a masked triangle's texture alpha at weights w is
        under its cutoff."""
        sc = self.sc
        prim = sc.tri_prim[tri]
        uv = shading.mix3(sc.uv0[sc.tri_vertex[tri]], w)
        a = shading.sample(sc.textures, sc.base_tex[prim], uv)[..., 3]
        return ~(sc.alpha_mask[prim] & (sc.base_tex[prim] >= 0) & (a < sc.alpha_cutoff[prim]))

    def _keep_fragment(self, tri, l0, l1, l2):
        s = l0 + l1 + l2
        inv = 1.0 / torch.where(s.abs() > 1e-12, s, torch.ones_like(s))
        return self._alpha_ok(tri, torch.stack([l0 * inv, l1 * inv, l2 * inv], -1))

    def _accept_hit(self, ray, tri, u, v):
        return self._alpha_ok(tri, torch.stack([1.0 - u - v, u, v], -1))

    def _raster(self, viewproj, w, h, alpha: bool):
        clip = torch.cat([self.world, torch.ones_like(self.world[:, :1])], -1) @ viewproj.T
        st = raster.setup(clip, self.sc.tri_vertex, w, h)
        keep = self._keep_fragment if (alpha and self.masked) else None
        return raster.rasterize(st, w, h, cull_back=True, keep=keep)

    def frame(self, pose, prev_pose, frame_index: int, state=None, lowp: bool = False):
        """(RENDER_OUTPUT (4, H, W), the SVGF state after it or None)."""
        rnd = _lowp if lowp else (lambda x: x)
        f = self.frame_data(pose, prev_pose, frame_index)
        if self.path == "raytraced":
            return rnd(self._raytraced(f, rnd)).permute(2, 0, 1), None
        return self._hybrid(f, state, rnd)

    def _raytraced(self, f, rnd):
        sc, h, w = self.sc, self.height, self.width
        uv = shading.pixel_uv(h, w, self.device).view(-1, 2)
        ndc = torch.cat([uv * 2.0 - 1.0, torch.ones_like(uv[:, :1])], -1)
        d = shading.normalize(shading.points(f["proj_inv"], ndc)[:, :3]) @ f["view_inv"][:3, :3].T
        o = torch.broadcast_to(f["view_inv"][:3, 3], d.shape).contiguous()
        o, d = rnd(o), rnd(d)
        accept = self._accept_hit if (self.test_alpha and self.masked) else None
        t, tri, u, v = trace.trace(self.tree, o, d, 0.1, 10000.0, accept=accept)
        hit = tri >= 0
        at = _attributes(shading.hit_attributes(sc, tri, u, v, self.world), rnd)
        pos = at["position"]
        l_dir = torch.broadcast_to(f["to_light"], pos.shape).contiguous()
        st = trace.trace(self.tree, pos, l_dir, 0.1, torch.where(hit, 10000.0, -1.0),
                         anyhit=True, accept=accept)
        shaded = shading.primary_shade(sc, at, st[1] < 0, f, self.test_alpha)
        img = torch.where(hit[:, None], shaded, torch.tensor(SKY, device=self.device))
        return img.view(h, w, 4)

    def _hybrid(self, f, state, rnd):
        sc, h, w, hs = self.sc, self.height, self.width, self.hybrid
        vis = self._raster(f["viewproj"], w, h, self.alpha_raster)
        gb = {k: rnd(v) for k, v in shading.gbuffer(sc, vis, self.world, f).items()}
        one = torch.ones(h, w, device=self.device)
        shadow, ao, refl = one, one, None
        if hs["shadow_mode"] == "RASTERIZED":
            n = self.shadow_map_size
            smap = rnd(self._raster(f["light_projview"], n, n, alpha=False)["depth"])
            p = shading.from_depth(gb["depth"], shading.pixel_uv(h, w, self.device),
                                   f["viewproj_inv"])
            shadow = shading.pcf16(smap, f["light_projview"], p)
        if self._rt_needed():
            shadow_ao, refl = (rnd(x) for x in self._rays(f, gb, rnd))
            if hs["denoise"]:
                st = self._state(state)
                shadow_ao, new = shading.svgf(gb["normal_oid"], gb["motion_mr"], shadow_ao, st)
                shadow_ao = rnd(shadow_ao)
                state = {k: rnd(v) for k, v in new.items()}
            if hs["shadow_mode"] == "RAYTRACED":
                shadow = shadow_ao[..., 0]
            if hs["ao_mode"] == "RAYTRACED":
                ao = shadow_ao[..., 1]
            if hs["reflection_mode"] != "RAYTRACED":
                refl = None
        if hs["ao_mode"] == "SSAO":
            ao = rnd(shading.ssao(f, gb["depth"], gb["normal_oid"],
                                  float(hs["ssao"]["radius"])))
        out = rnd(shading.compose(gb, f, shadow, ao, refl))
        return out.permute(2, 0, 1), (state if self.stateful else None)

    def _state(self, state):
        h, w = self.height, self.width
        if state is not None:
            return state
        return {"shadow_ao_history": torch.zeros(h, w, 2, device=self.device),
                "moments_history": torch.zeros(h, w, 4, device=self.device),
                "prev_normal_oid": torch.full((h, w, 4), -1.0, device=self.device)}

    def _rays(self, f, gb, rnd):
        """(shadow, ao, 0, 1) and the reflections (H, W, 4) of the hybrid
        ray-trace pass: rays from P + 0.1 N, tmin 0.01, the shader RNG's
        draws in the upstream order (shadow cone, then each AO ray); the
        any-hit rays (shadow and AO) walked as one wavefront."""
        sc, h, w, hs = self.sc, self.height, self.width, self.hybrid
        dev = self.device
        px = h * w
        depth = gb["depth"]
        sky = (depth == 0.0).view(-1)
        p = rnd(shading.from_depth(depth, shading.pixel_uv(h, w, dev),
                                   f["viewproj_inv"]).view(-1, 3))
        n = gb["normal_oid"][..., :3].reshape(-1, 3)
        origin = rnd(p + n * 0.1)
        state = shading.pixel_seed(w, h, f["frame_index"], dev).view(-1)
        state, r1 = shading.random01(state)
        state, r2 = shading.random01(state)
        l_dir = torch.broadcast_to(f["to_light"], n.shape)
        far = torch.where(sky, -1.0, 10000.0)
        # the any-hit wavefront: [shadow rays][AO rays 1][AO rays 2] ...
        dirs, tmax = [], []
        if hs["shadow_mode"] == "RAYTRACED":
            dirs.append(shading.to_basis(l_dir, shading.normalize(shading.cone(r1, r2, 0.999995))))
            tmax.append(far)
        for _ in range(self.ao_rays):
            state, r1 = shading.random01(state)
            state, r2 = shading.random01(state)
            if hs["ao_mode"] == "RAYTRACED":
                dirs.append(shading.to_basis(n, shading.cosine_hemisphere(r1, r2)))
                tmax.append(torch.where(sky, -1.0, 5.0))
        blocked = torch.zeros(0, px, device=dev)
        if dirs:
            k = len(dirs)
            hit = trace.trace(self.tree, origin.repeat(k, 1), rnd(torch.cat(dirs)), 0.01,
                              torch.cat(tmax), anyhit=True)[1]
            blocked = (hit >= 0).view(k, px).float()
        shadow = torch.ones(px, device=dev)
        if hs["shadow_mode"] == "RAYTRACED":
            shadow, blocked = 1.0 - blocked[0], blocked[1:]
        ao = torch.ones(px, device=dev)
        if hs["ao_mode"] == "RAYTRACED":
            ao = (1.0 - blocked).sum(0) / self.ao_rays
        refl = torch.zeros(px, 4, device=dev)
        if hs["reflection_mode"] == "RAYTRACED":
            rd = rnd(shading.reflect(shading.normalize(p - f["camera_pos"]), n))
            _, tri, u, v = trace.trace(self.tree, origin, rd, 0.01, far)
            at = _attributes(shading.hit_attributes(sc, tri, u, v, self.world), rnd)
            refl = torch.where((tri >= 0)[:, None], shading.reflection_shade(sc, at, f), 0.0)
        skyc = sky.view(h, w)
        shadow = torch.where(skyc, 1.0, shadow.view(h, w))
        ao = torch.where(skyc, 1.0, ao.view(h, w))
        shadow_ao = torch.stack([shadow, ao, torch.zeros_like(ao), torch.ones_like(ao)], -1)
        refl = torch.where(skyc[..., None], 0.0, refl.view(h, w, 4))
        return shadow_ao, refl


def _attributes(at: dict, rnd) -> dict:
    """A hit's attributes, each float one rounded by `rnd`."""
    return {k: rnd(v) for k, v in at.items()}
