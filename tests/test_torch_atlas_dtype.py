"""The reference's atlas_dtype and its last keyword signatures on the port.

``build_atlas(dtype=)``, ``build_scene_buffers`` / ``load_scene(atlas_dtype=)``
and ``SceneBuilder.build`` / ``sponza_proxy`` / ``bistro_proxy(atlas_dtype=)``
against the JAX package on the same seeded inputs: a bf16 atlas equals the
reference's bit for bit (uint16 patterns, the reference rounding to nearest
even through jnp.asarray), and the quad table every sampler reads
(``build_shade_tables``' atlas_q, float32 in both packages) equals the
reference's.  ``bridge.scene_from_numpy`` carries the reference's bf16 atlas
as bf16.  ``make_temporal_state(dtype=)`` and ``moller_trumbore(origin=,
direction=)`` take the reference's calls.  ~10 s alone.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanhybridrenderer_tpu.core import types as jtypes
from vulkanhybridrenderer_tpu.ops import shadetab as jshadetab
from vulkanhybridrenderer_tpu.ops import traverse as jtrav
from vulkanhybridrenderer_tpu.scene import atlas as jatlas
from vulkanhybridrenderer_tpu.scene import gltf as jgltf
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.core import types as ptypes
from vulkanhybridrenderer_tpu_torch.ops import shadetab as pshadetab
from vulkanhybridrenderer_tpu_torch.ops import traverse as ptrav
from vulkanhybridrenderer_tpu_torch.scene import atlas as patlas
from vulkanhybridrenderer_tpu_torch.scene import gltf as pgltf
from vulkanhybridrenderer_tpu_torch.scene import procedural as pproc
from vulkanhybridrenderer_tpu_torch.scene import sample_asset as passet

torch.set_num_threads(2)


def _bits(a) -> np.ndarray:
    """uint16 bit patterns of a bf16 atlas of either package."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == torch.bfloat16
        return a.view(torch.int16).numpy().view(np.uint16)
    assert a.dtype == jnp.bfloat16
    return np.asarray(a).view(np.uint16)


def _images(seed):
    """Seeded RGBA images of every form build_atlas takes: uint8 RGBA, float
    RGBA, uint8 RGB, grey."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (17, 23, 4), dtype=np.uint8),
            rng.random((9, 31, 4)).astype(np.float32),
            rng.integers(0, 256, (40, 12, 3), dtype=np.uint8),
            rng.integers(0, 256, (5, 7), dtype=np.uint8)]


@pytest.mark.parametrize("srgb", [None, [True, False, True, False], [True] * 4],
                         ids=["linear", "mixed", "srgb"])
def test_build_atlas_bf16_bits(srgb):
    images = _images(3)
    j = jatlas.build_atlas(images, srgb, dtype=jnp.bfloat16)
    p = patlas.build_atlas(images, srgb, dtype=torch.bfloat16)
    assert p.data.shape == j.data.shape
    np.testing.assert_array_equal(_bits(p.data), _bits(j.data))
    np.testing.assert_array_equal(p.uv_offset, np.asarray(j.uv_offset))
    np.testing.assert_array_equal(p.uv_scale, np.asarray(j.uv_scale))
    # the default stays the reference's float32, a numpy array as before
    f = patlas.build_atlas(images, srgb)
    assert isinstance(f.data, np.ndarray) and f.data.dtype == np.float32
    np.testing.assert_array_equal(f.data, np.asarray(jatlas.build_atlas(images, srgb).data))
    # half the bytes
    assert p.data.element_size() * p.data.numel() * 2 == f.data.nbytes


def test_empty_atlas_bf16():
    j = jatlas.build_atlas([], dtype=jnp.bfloat16)
    p = patlas.build_atlas([], dtype=torch.bfloat16)
    np.testing.assert_array_equal(_bits(p.data), _bits(j.data))
    assert p.num_textures == j.uv_offset.shape[0] == 1


def test_build_atlas_refuses_other_dtypes():
    with pytest.raises(ValueError, match="bfloat16"):
        patlas.build_atlas(_images(0), dtype=torch.float16)


def _assert_atlas_and_quads(js, ps):
    """js / ps: the two packages' scenes with bf16 atlases: the atlases bit
    for bit, and atlas_q (float32) equal."""
    np.testing.assert_array_equal(_bits(ps.buffers.atlas.data), _bits(js.buffers.atlas.data))
    jq = np.asarray(jshadetab.build_shade_tables(js.buffers).atlas_q)
    pq = pshadetab.build_shade_tables(ps.buffers.to("cpu")).atlas_q
    assert pq.dtype == torch.float32 and jq.dtype == np.float32
    np.testing.assert_array_equal(pq.numpy(), jq)


@pytest.fixture(scope="module")
def small_glb(tmp_path_factory):
    path = tmp_path_factory.mktemp("atlas") / "sponza_class_small.glb"
    passet.build_sponza_class_glb(path, scale=0.05)
    return path


def test_load_scene_bf16_atlas(small_glb):
    js = jgltf.load_scene(small_glb, atlas_dtype=jnp.bfloat16)
    ps = pgltf.load_scene(small_glb, atlas_dtype=torch.bfloat16)
    assert ps.buffers.atlas.num_textures > 1
    _assert_atlas_and_quads(js, ps)
    # the float32 default is another atlas: the dtype reached the scene
    pf = pgltf.load_scene(small_glb)
    assert isinstance(pf.buffers.atlas.data, np.ndarray)
    assert not np.array_equal(
        pf.buffers.atlas.data, ps.buffers.atlas.data.to(torch.float32).numpy())


def test_sponza_proxy_bf16_atlas():
    kw = dict(columns=3, segments=6, extra_boxes=12, grid_res=8)
    js = jproc.sponza_proxy(**kw, atlas_dtype=jnp.bfloat16)
    ps = pproc.sponza_proxy(**kw, atlas_dtype=torch.bfloat16)
    _assert_atlas_and_quads(js, ps)
    # atlas_dtype None is "not given": build_scene_buffers' float32
    assert isinstance(pproc.sponza_proxy(**kw, atlas_dtype=None).buffers.atlas.data, np.ndarray)


@pytest.mark.parametrize("form", ["uint16", "bfloat16"])
def test_scene_from_numpy_keeps_bf16_atlas(form):
    js = jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8,
                            atlas_dtype=jnp.bfloat16)
    buffers = dataclasses.asdict(js.buffers)
    atlas = np.asarray(buffers["atlas"]["data"])
    buffers["atlas"]["data"] = atlas.view(np.uint16) if form == "uint16" else atlas
    ps = bridge.scene_from_numpy(js.name, buffers, dataclasses.asdict(js.camera),
                                 dataclasses.asdict(js.light))
    assert ps.buffers.atlas.data.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(ps.buffers.atlas.data), _bits(js.buffers.atlas.data))
    dev = ps.buffers.to("cpu")
    assert dev.atlas.data.dtype == torch.bfloat16


def test_scene_functions_take_atlas_dtype():
    """Every reference function with atlas_dtype / dtype has it on the port,
    with the reference's default; bistro_proxy (434,460 triangles, too large
    for the CPU) by its signature."""
    pairs = [(jatlas.build_atlas, patlas.build_atlas, "dtype", torch.float32),
             (jgltf.build_scene_buffers, pgltf.build_scene_buffers, "atlas_dtype", torch.float32),
             (jgltf.load_scene, pgltf.load_scene, "atlas_dtype", torch.float32),
             (jproc.SceneBuilder.build, pproc.SceneBuilder.build, "atlas_dtype", None),
             (jproc.sponza_proxy, pproc.sponza_proxy, "atlas_dtype", None),
             (jproc.bistro_proxy, pproc.bistro_proxy, "atlas_dtype", None)]
    for jfn, pfn, name, default in pairs:
        jp, pp = inspect.signature(jfn).parameters, inspect.signature(pfn).parameters
        assert list(jp) == list(pp), (pfn.__qualname__, list(jp), list(pp))
        assert pp[name].default == default, pfn.__qualname__
        assert (jp[name].default is None) == (default is None)


@pytest.mark.parametrize("dtype", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16"])
def test_make_temporal_state_dtype(dtype):
    j = jtypes.make_temporal_state(5, 7, dtype=dtype[0])
    p = ptypes.make_temporal_state(5, 7, dtype=dtype[1])
    for f in ("shadow_ao_history", "moments_history", "prev_normal_oid"):
        a, b = getattr(j, f), getattr(p, f)
        assert b.dtype == dtype[1] and tuple(b.shape) == a.shape
        np.testing.assert_array_equal(b.to(torch.float32).numpy(), np.asarray(a, np.float32))
    assert ptypes.make_temporal_state(2, 3).shadow_ao_history.dtype == torch.float32
    assert ptypes.make_temporal_state(2, 3, torch.bfloat16).moments_history.dtype == torch.bfloat16


def test_moller_trumbore_reference_keywords():
    """The reference's keyword call, exact under jax.disable_jit() (no
    contracted multiply-adds)."""
    rng = np.random.default_rng(5)
    v0 = rng.normal(size=(256, 3)).astype(np.float32)
    v1, v2 = (v0 + rng.normal(size=(256, 3)).astype(np.float32) for _ in range(2))
    o = (v0 + v1 + v2) / 3 + rng.normal(size=(256, 3)).astype(np.float32)
    d = (v0 + v1 + v2) / 3 - o + 0.3 * rng.normal(size=(256, 3)).astype(np.float32)
    with jax.disable_jit():
        jt, ju, jv, jok = (np.asarray(a) for a in jtrav.moller_trumbore(
            *map(jnp.asarray, (v0, v1, v2)), origin=jnp.asarray(o), direction=jnp.asarray(d),
            eps=1e-9))
    pt, pu, pv, pok = (a.numpy() for a in ptrav.moller_trumbore(
        *map(torch.from_numpy, (v0, v1, v2)), origin=torch.from_numpy(o),
        direction=torch.from_numpy(d), eps=1e-9))
    for a, b in ((pok, jok), (pt, jt), (pu, ju), (pv, jv)):
        np.testing.assert_array_equal(a, b)
    assert 0.2 < pok.mean() < 1.0
    assert list(inspect.signature(ptrav.moller_trumbore).parameters)[:6] == list(
        inspect.signature(jtrav.moller_trumbore).parameters)
