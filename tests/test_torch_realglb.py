"""bench.py's flagship asset ("realglb", scene/sample_asset.build_sponza_class_glb)
through each package's own writer and reader, rendered in the flagship
configuration (RT shadows + RT AO with 2 rays + RT reflections + SVGF,
alpha_raster="brute" with 4 peel rounds) at 96x64, frames 0-2.

The asset is cut to scale=0.12 for the CPU (its 39 textures, normal and
metallic-roughness maps, foliage and node layout stay).  The reference
renderer gets bvh_dtype="f32", bvh_leaf_max=8 (its default picks bf16 rows
for large tables) and shadow_map_size=128 (its binning check also runs at
the light's view, which this configuration never rasters, and its static
entry cap does not fit this asset at 4096^2).

Tolerances.  The frames against the jitted reference: every pixel within
1e-2 and >= 95% of pixels within 1e-4.  Measured: max 0.0067, 0.9647-0.9655
of pixels within 1e-4 (frames 0-2).  test_torch_hybrid_full.py's 1e-4 on
>= 99.9% does not hold here: XLA's CPU backend contracts multiply-adds into
FMAs under jit and the port rounds every product (ROADMAP §3).  On this
asset the texture-sampling and normal-map arithmetic that no procedural
scene reaches carries those last-bit differences (albedo up to 1.9e-5),
the light's intensity of 30 scales them, and the mirror reflections of
high-contrast textures turn a 1e-5 change of a ray into a visible one.
The two tests after the frames hold those stages against the reference's
own arithmetic without contraction (``jax.disable_jit()``) on the same
inputs: the G-buffer resolve within 2.4e-7 (measured 1.2e-7) and the
reflection shading on the same hits within 1e-6 (measured 2.4e-7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanhybridrenderer_tpu.core import config as jcfg
from vulkanhybridrenderer_tpu.ops import gbuffer as jgbuffer
from vulkanhybridrenderer_tpu.ops import geometry as jgeometry
from vulkanhybridrenderer_tpu.ops import rt_shade as jrt_shade
from vulkanhybridrenderer_tpu.ops import shadetab as jshadetab
from vulkanhybridrenderer_tpu.ops.rasterizer import VisibilityBuffer as JVisibility
from vulkanhybridrenderer_tpu.runtime import renderer as jrenderer
from vulkanhybridrenderer_tpu.scene import gltf as jgltf
from vulkanhybridrenderer_tpu.scene import sample_asset as jasset
from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.models import hybrid as hybrid_path
from vulkanhybridrenderer_tpu_torch.ops import gbuffer, raygen, rt_shade, traverse
from vulkanhybridrenderer_tpu_torch.ops import rasterizer_tiled as rt
from vulkanhybridrenderer_tpu_torch.runtime import renderer as prenderer
from vulkanhybridrenderer_tpu_torch.scene import gltf as pgltf
from vulkanhybridrenderer_tpu_torch.scene import sample_asset as passet

torch.set_num_threads(2)
W, H = 96, 64
FRAMES = 3
SCALE = 0.12


def full_settings(m):
    return m.HybridSettings(
        shadow_mode=m.ShadowMode.RAYTRACED, ao_mode=m.AmbientOcclusionMode.RAYTRACED,
        reflection_mode=m.ReflectionMode.RAYTRACED, denoise=True, rt_scale=1,
    )


@pytest.fixture(scope="module")
def renderers(tmp_path_factory):
    d = tmp_path_factory.mktemp("realglb")
    jasset.build_sponza_class_glb(d / "jax.glb", scale=SCALE)
    passet.build_sponza_class_glb(d / "port.glb", scale=SCALE)
    js, ps = jgltf.load_scene(d / "jax.glb"), pgltf.load_scene(d / "port.glb")
    jr = jrenderer.Renderer(js, jcfg.RenderConfig(
        width=W, height=H, bvh_dtype="f32", bvh_leaf_max=8, shadow_map_size=128,
        alpha_raster="brute", alpha_peel_rounds=4, ao_rays=2, hybrid=full_settings(jcfg)),
        path="hybrid")
    # no pass reads the blue-noise stack; generating it takes minutes on a CPU
    jr._blue_noise = jnp.zeros((4, 128, 128, 4), jnp.float32)
    pr = prenderer.Renderer(ps, pcfg.RenderConfig(
        width=W, height=H, shadow_map_size=128, alpha_raster="brute", alpha_peel_rounds=4,
        ao_rays=2, hybrid=full_settings(pcfg)), device="cpu")
    return jr, pr


@pytest.fixture(scope="module")
def frames(renderers):
    jr, pr = renderers
    return [(np.asarray(jr.render_frame()), pr.render_frame().numpy()) for _ in range(FRAMES)]


def test_scene_counts(renderers):
    jr, pr = renderers
    jb, pb = jr.scene.buffers, pr.scene.buffers
    assert pb.num_triangles == jb.num_triangles
    assert pb.alpha_tri_idx.shape[0] == np.asarray(jb.alpha_tri_idx).shape[0] > 0
    assert pb.atlas.uv_offset.shape[0] == np.asarray(jb.atlas.uv_offset).shape[0]
    np.testing.assert_array_equal(pb.atlas.data, np.asarray(jb.atlas.data))
    assert pb.has_normal_maps and pb.has_mr_textures


@pytest.mark.parametrize("frame", range(FRAMES))
def test_flagship_frame_matches_jax(frames, frame):
    j, p = frames[frame]
    assert p.shape == j.shape == (4, H, W)
    assert np.isfinite(p).all()
    d = np.abs(p - j).max(axis=0)
    assert d.max() <= 1e-2, d.max()
    assert (d <= 1e-4).mean() >= 0.95, (d <= 1e-4).mean()
    assert p[:3].std() > 0.01


def _reference_inputs(jr):
    """The reference's shade tables, per-frame data and TriRow table of the
    next frame, computed without jit."""
    pfd = jr._make_pfd()
    tables = jr._get_shade_tables()
    scene = jr.scene.buffers
    with jax.disable_jit():
        world = jgeometry.to_world(scene, scene.prim_transform)
        clip = jgeometry.to_clip(world.position, pfd.camera_proj @ pfd.camera_view)
        tri_rows = jshadetab.make_tri_rows(tables, scene, world.position, clip)
    return pfd, tables, tri_rows


def test_gbuffer_resolve_equals_reference_unfused(renderers):
    """The resolve (normal maps, metallic-roughness maps, the 39-texture
    atlas) of the port's visibility buffer against the reference's resolve
    of the same buffer."""
    jr, pr = renderers
    res = pr.fetch_resources("pfd", "Clip", "shade_tables", "TriRows")
    vis = rt.rasterize_scene(pr.buffers, res["Clip"], W, H, tables=res["shade_tables"])
    got = gbuffer.resolve_gbuffer(pr.buffers, res["shade_tables"], res["TriRows"], vis,
                                  res["pfd"])
    pfd, tables, tri_rows = _reference_inputs(jr)
    jvis = JVisibility(tri_id=jnp.asarray(vis.tri_id.numpy()),
                       depth=jnp.asarray(vis.depth.numpy()), bary=jnp.asarray(vis.bary.numpy()))
    with jax.disable_jit():
        want = jgbuffer.resolve_gbuffer(jr.scene.buffers, tables, tri_rows, jvis, pfd)
    for f in dataclasses.fields(got):
        np.testing.assert_allclose(getattr(got, f.name).numpy(),
                                   np.asarray(getattr(want, f.name)), rtol=0, atol=2.4e-7,
                                   err_msg=f.name)


def test_reflection_shading_equals_reference_unfused(renderers):
    """The reflection hits' shading (textured, metallic-roughness maps) on
    the port's hits of its reflection wavefront against the reference's
    shading of the same hits."""
    jr, pr = renderers
    res = pr.fetch_resources("pfd", "BVH", "shade_tables", "TriRows", hybrid_path.DEPTH,
                             hybrid_path.NORMALS)
    rays = raygen.Wavefronts(res["pfd"], res[hybrid_path.DEPTH], res[hybrid_path.NORMALS],
                             pr.config.hybrid, ao_rays=2)
    hits = traverse.trace(res["BVH"], rays.origin, rays.refl_dir, raygen.SHADOW_TMIN,
                          rays.refl_tmax, anyhit=False)
    assert int(hits.hit.sum()) > 100
    got = rt_shade.reflection_hit_shade(pr.buffers, res["shade_tables"], res["TriRows"],
                                        res["pfd"], hits.tri, hits.u, hits.v).numpy()
    pfd, tables, tri_rows = _reference_inputs(jr)
    with jax.disable_jit():
        want = np.asarray(jrt_shade.reflection_hit_shade(
            jr.scene.buffers, tables, tri_rows, pfd, jnp.asarray(hits.tri.numpy()),
            jnp.asarray(hits.u.numpy()), jnp.asarray(hits.v.numpy())))
    hit = hits.hit.numpy()
    np.testing.assert_allclose(got[hit], want[hit], rtol=0, atol=1e-6)
