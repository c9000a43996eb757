"""The port's ray-traced effects' shading against the JAX package on the
same seeded inputs: direct lighting, the reflection hit shader (with and
without metallic-roughness textures), the AO and reflection rays of the
raytrace pass in the reference's RNG order, and composition's RT AO and RT
reflection branches.

Tolerance 1e-5: float32 in both, with different libm sin / cos / exp / pow
and XLA's fusion of multiply-adds.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vulkanhybridrenderer_tpu.core import config as jcfg
from vulkanhybridrenderer_tpu.core import types as jtypes
from vulkanhybridrenderer_tpu.ops import brdf as jbrdf
from vulkanhybridrenderer_tpu.ops import composition as jcomp
from vulkanhybridrenderer_tpu.ops import geometry as jgeo
from vulkanhybridrenderer_tpu.ops import rt_shade as jrt_shade
from vulkanhybridrenderer_tpu.ops import sampling as jsamp
from vulkanhybridrenderer_tpu.ops import screen as jscreen
from vulkanhybridrenderer_tpu.ops import shadetab as jtab
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu.utils import math3d as jm3
from vulkanhybridrenderer_tpu.utils import rng as jrng
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.core import types as ptypes
from vulkanhybridrenderer_tpu_torch.ops import brdf as pbrdf
from vulkanhybridrenderer_tpu_torch.ops import composition as pcomp
from vulkanhybridrenderer_tpu_torch.ops import raygen as praygen
from vulkanhybridrenderer_tpu_torch.ops import rt_shade as prt_shade
from vulkanhybridrenderer_tpu_torch.ops import shadetab as ptab

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
H, W = 24, 40


def _t(a):
    return torch.from_numpy(np.array(a))


def _unit(rng, shape):
    v = rng.normal(size=shape + (3,)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def sponza():
    js = jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8)
    view, proj = js.camera.view(), js.camera.projection(W / H)
    world = jgeo.to_world(js.buffers)
    clip = jgeo.to_clip(world.position, jnp.asarray((proj @ view).astype(np.float32)))
    jtabs = jtab.build_shade_tables(js.buffers)
    jrows = jtab.make_tri_rows(jtabs, js.buffers, world.position, clip)
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    ptabs = ptab.ShadeTables(tri_static=_t(jtabs.tri_static), prim_rows=_t(jtabs.prim_rows),
                             atlas_q=_t(jtabs.atlas_q), atlas_w=jtabs.atlas_w)
    jpfd = jtypes.make_per_frame_data(view, proj, js.light, W, H, 2)
    ppfd = ptypes.make_per_frame_data(view, proj, ps.light, W, H, 2)
    return dict(js=js, pb=ps.buffers.to("cpu"), jtabs=jtabs, jrows=jrows, ptabs=ptabs,
                prows=_t(jrows), jpfd=jpfd, ppfd=ppfd)


def test_direct_lighting():
    rng = np.random.default_rng(4)
    n, v, l = (_unit(rng, (2048,)) for _ in range(3))
    albedo = rng.uniform(size=(2048, 3)).astype(np.float32)
    metallic = rng.uniform(-0.2, 1.2, 2048).astype(np.float32)  # clamped inside
    rough = rng.uniform(0.0, 1.2, 2048).astype(np.float32)
    color, intensity = np.float32([1.0, 0.9, 0.8]), np.float32([3.0, 3.0, 3.0])
    args = (albedo, metallic, rough, n, v, l, color, intensity)
    j = jbrdf.direct_lighting(*map(jnp.asarray, args), ambient_factor=jm3.PI_INVERSE * 0.2)
    p = pbrdf.direct_lighting(*map(torch.from_numpy, args), ambient_factor=jm3.PI_INVERSE * 0.2)
    np.testing.assert_allclose(p.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("mr_textures", [True, False])
def test_reflection_hit_shade(sponza, mr_textures):
    rng = np.random.default_rng(5)
    r = 4096
    tri = rng.integers(-1, sponza["pb"].num_triangles, r).astype(np.int32)
    u = rng.uniform(size=r).astype(np.float32)
    v = (rng.uniform(size=r) * (1.0 - u)).astype(np.float32)
    rows = np.array(sponza["jrows"])
    if mr_textures:
        # the proxy has no metallic-roughness maps: give every textured
        # material its base texture as one (TriRow cols 40+14.. = 40+4..)
        rows[:, 54:59] = rows[:, 44:49]
    jscene = dataclasses.replace(sponza["js"].buffers, has_mr_textures=mr_textures)
    pscene = dataclasses.replace(sponza["pb"], has_mr_textures=mr_textures)
    j = jrt_shade.reflection_hit_shade(jscene, sponza["jtabs"], jnp.asarray(rows), sponza["jpfd"],
                                       jnp.asarray(tri), jnp.asarray(u), jnp.asarray(v))
    p = prt_shade.reflection_hit_shade(pscene, sponza["ptabs"], _t(rows), sponza["ppfd"],
                                       _t(tri), _t(u), _t(v))
    assert p.shape == (r, 4)
    np.testing.assert_allclose(p.numpy(), np.asarray(j), **TOL)
    if mr_textures:  # the textured branch does change something
        flat = prt_shade.reflection_hit_shade(
            dataclasses.replace(pscene, has_mr_textures=False), sponza["ptabs"],
            _t(rows), sponza["ppfd"], _t(tri), _t(u), _t(v))
        assert not torch.equal(flat, p)


def test_ao_and_reflection_rays_in_rng_order(sponza):
    """AO directions come after the shadow pair in each pixel's xorshift
    stream, one (rnd1, rnd2) pair per AO ray; reflections mirror the camera
    ray.  The expected rays are built from the JAX package's functions in
    the order of its hybrid_raytrace."""
    rng = np.random.default_rng(6)
    depth = rng.uniform(0.01, 1.0, (H, W)).astype(np.float32)
    depth[:3] = 0.0  # sky
    normal_oid = np.concatenate([_unit(rng, (H, W)).transpose(2, 0, 1),
                                 np.ones((1, H, W), np.float32)])
    settings = pcfg.HybridSettings(ao_mode=pcfg.AmbientOcclusionMode.RAYTRACED,
                                   reflection_mode=pcfg.ReflectionMode.RAYTRACED, denoise=True)
    rays = praygen.Wavefronts(sponza["ppfd"], _t(depth), _t(normal_oid), settings, ao_rays=3)

    jpfd = sponza["jpfd"]
    state = jrng.pixel_seed(W, H, jpfd.frame_index)
    for _ in range(2):  # the shadow ray's pair
        state, _ = jrng.random01(state)
    n = jnp.asarray(normal_oid[:3].transpose(1, 2, 0).reshape(-1, 3))
    dirs = []
    for _ in range(3):
        state, r1 = jrng.random01(state)
        state, r2 = jrng.random01(state)
        u2 = jnp.stack([r1, r2], axis=-1).reshape(-1, 2)
        dirs.append(jsamp.to_basis(n, jsamp.uniform_sample_cosine_hemisphere(u2)))
    np.testing.assert_allclose(rays.ao_dir.numpy(), np.concatenate(dirs), **TOL)
    sky = depth.reshape(-1) == 0.0
    np.testing.assert_array_equal(rays.ao_tmax.numpy(), np.where(sky, -1.0, 5.0))

    p_world = jscreen.position_from_depth(jnp.asarray(depth), jscreen.pixel_uv_grid(H, W),
                                          jpfd.camera_viewproj_inverse)
    i_dir = jm3.normalize(p_world - jpfd.camera_position).reshape(-1, 3)
    np.testing.assert_allclose(rays.refl_dir.numpy(), np.asarray(jm3.reflect(i_dir, n)), **TOL)
    np.testing.assert_array_equal(rays.refl_tmax.numpy(), np.where(sky, -1.0, 10000.0))
    # with denoise on, shadow rays facing away from the light stay live
    assert (rays.shadow_tmax.numpy()[~sky] == 10000.0).all()


@pytest.mark.parametrize("ao,refl", [(True, True), (True, False), (False, True)])
def test_composition_rt_branches(sponza, ao, refl):
    rng = np.random.default_rng(7)
    albedo = np.concatenate([rng.uniform(size=(3, H, W)), np.ones((1, H, W))]).astype(np.float32)
    normal_oid = np.concatenate([_unit(rng, (H, W)).transpose(2, 0, 1),
                                 np.ones((1, H, W))]).astype(np.float32)
    motion_mr = rng.uniform(size=(4, H, W)).astype(np.float32)
    motion_mr[2, :, ::3] = 1.0  # fully metallic pixels take the reflection as is
    depth = rng.uniform(0.01, 1.0, (H, W)).astype(np.float32)
    shadow_ao = np.stack([rng.uniform(size=(H, W)) < 0.5, rng.uniform(size=(H, W)),
                          np.zeros((H, W)), np.ones((H, W))]).astype(np.float32)
    reflections = rng.uniform(size=(4, H, W)).astype(np.float32)

    def settings(m):
        return m.HybridSettings(
            ao_mode=m.AmbientOcclusionMode.RAYTRACED if ao else m.AmbientOcclusionMode.OFF,
            reflection_mode=m.ReflectionMode.RAYTRACED if refl else m.ReflectionMode.OFF)

    jg = jtypes.GBuffer(*map(jnp.asarray, (albedo, normal_oid, motion_mr, depth)))
    pg = ptypes.GBuffer(*map(_t, (albedo, normal_oid, motion_mr, depth)))
    j = jcomp.compose(jg, sponza["jpfd"], settings(jcfg), rt_shadow_ao=jnp.asarray(shadow_ao),
                      rt_reflections=jnp.asarray(reflections))
    p = pcomp.compose(pg, sponza["ppfd"], settings(pcfg), rt_shadow_ao=_t(shadow_ao),
                      rt_reflections=_t(reflections))
    np.testing.assert_allclose(p.numpy(), np.asarray(j), **TOL)
    base = pcomp.compose(pg, sponza["ppfd"], pcfg.HybridSettings(), rt_shadow_ao=_t(shadow_ao))
    assert not torch.equal(p, base)  # the branch is live
