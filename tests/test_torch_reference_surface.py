"""The reference's public helpers the port carries, against their JAX
functions on inputs made from a seed with numpy, and ``Renderer.fetch_resource``.

``SceneBuffers.num_primitives`` and ``TextureAtlas.num_textures`` equal the
reference's on its scenes.  Exact (np.array_equal) where the two packages
round alike: ``gbuffer.interpolate`` (a row gather and three products
summed in vertex order), ``perspective_weights``, ``shadetab.fetch_prim``
and ``fetch_tri_uv`` (gathers), ``oct_encode`` (a sum of three absolute
values, a division, a select).  Within 1e-6 relative (of each output's
largest magnitude; measured up to 1.2e-7) where the reference goes through
a library call whose summation order the port does not repeat:
``object_normals_world`` (einsum, then jnp.linalg.norm), ``oct_decode``
(jnp.linalg.norm) and ``project_points`` (a matmul).  ``fetch_resource``
returns one tensor for one name and a tuple for several, equal to
``fetch_resources``' entries, and leaves the frame index where it was.
~14 s alone.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanhybridrenderer_tpu.ops import gbuffer as jgbuf
from vulkanhybridrenderer_tpu.ops import geometry as jgeo
from vulkanhybridrenderer_tpu.ops import shadetab as jshade
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu.utils import math3d as jm
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.models import hybrid as phybrid
from vulkanhybridrenderer_tpu_torch.ops import gbuffer as pgbuf
from vulkanhybridrenderer_tpu_torch.ops import geometry as pgeo
from vulkanhybridrenderer_tpu_torch.ops import shadetab as pshade
from vulkanhybridrenderer_tpu_torch.runtime import renderer as prenderer
from vulkanhybridrenderer_tpu_torch.utils import math3d as pm

torch.set_num_threads(2)
REL = 1e-6


def _close(p, j):
    p, j = p.numpy(), np.asarray(j)
    assert p.shape == j.shape and p.dtype == j.dtype, (p.shape, j.shape, p.dtype, j.dtype)
    scale = max(float(np.abs(j).max()), 1e-30)
    assert float(np.abs(p - j).max()) <= REL * scale, float(np.abs(p - j).max()) / scale


def _exact(p, j):
    p, j = p.numpy(), np.asarray(j)
    assert p.shape == j.shape and p.dtype == j.dtype, (p.shape, j.shape, p.dtype, j.dtype)
    np.testing.assert_array_equal(p, j)


@pytest.fixture(scope="module")
def scenes():
    """(reference scene, port scene from the same arrays, its buffers as CPU
    tensors) per scene."""
    out = {}
    for name, js in (("cornell", jproc.cornell_box()),
                     ("sponza", jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12,
                                                   grid_res=8))):
        ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                     dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
        out[name] = (js, ps, ps.buffers.to("cpu"))
    return out


@pytest.mark.parametrize("name", ["cornell", "sponza"])
def test_counts(scenes, name):
    js, ps, pb = scenes[name]
    assert ps.buffers.num_primitives == pb.num_primitives == js.buffers.num_primitives > 1
    assert ps.buffers.atlas.num_textures == pb.atlas.num_textures == js.buffers.atlas.num_textures


def test_perspective_weights():
    rng = np.random.default_rng(0)
    bary = rng.uniform(0.0, 0.5, (7, 9, 2)).astype(np.float32)
    inv_w = rng.uniform(0.05, 2.0, (7, 9, 3)).astype(np.float32)
    p = pgbuf.perspective_weights(torch.from_numpy(bary), torch.from_numpy(inv_w))
    _exact(p, jgbuf.perspective_weights(jnp.asarray(bary), jnp.asarray(inv_w)))
    assert torch.allclose(p.sum(-1), torch.ones(7, 9), atol=1e-6)


def test_interpolate():
    rng = np.random.default_rng(1)
    attr = rng.standard_normal((50, 5)).astype(np.float32)
    vidx = rng.integers(0, 50, (4, 6, 3)).astype(np.int32)
    w = rng.uniform(0.0, 1.0, (4, 6, 3)).astype(np.float32)
    p = pgbuf.interpolate(torch.from_numpy(attr), torch.from_numpy(vidx), torch.from_numpy(w))
    _exact(p, jgbuf.interpolate(jnp.asarray(attr), jnp.asarray(vidx), jnp.asarray(w)))


@pytest.mark.parametrize("name", ["cornell", "sponza"])
def test_object_normals_world(scenes, name):
    js, _, pb = scenes[name]
    rng = np.random.default_rng(2)
    n_obj = rng.standard_normal((5, 40, 3)).astype(np.float32)
    prim = rng.integers(0, js.buffers.num_primitives, (5, 40)).astype(np.int32)
    p = pgeo.object_normals_world(pb, torch.from_numpy(n_obj), torch.from_numpy(prim))
    _close(p, jgeo.object_normals_world(js.buffers, jnp.asarray(n_obj), jnp.asarray(prim)))
    assert torch.allclose(p.norm(dim=-1), torch.ones(5, 40), atol=1e-6)


@pytest.mark.parametrize("name", ["cornell", "sponza"])
def test_fetch_prim_and_tri_uv(scenes, name):
    js, _, pb = scenes[name]
    jt, pt = jshade.build_shade_tables(js.buffers), pshade.build_shade_tables(pb)
    rng = np.random.default_rng(3)
    prim = rng.integers(0, js.buffers.num_primitives, (3, 11)).astype(np.int32)
    jf = jshade.fetch_prim(jt.prim_rows, jnp.asarray(prim))
    pf = pshade.fetch_prim(pt.prim_rows, torch.from_numpy(prim))
    assert sorted(pf) == sorted(jf)
    for k in jf:
        _exact(pf[k], jf[k])
    tri = rng.integers(0, js.buffers.num_triangles, (3, 13)).astype(np.int32)
    _exact(pshade.fetch_tri_uv(pt, torch.from_numpy(tri)),
           jshade.fetch_tri_uv(jt, jnp.asarray(tri)))


def _unit_vectors(n, seed):
    v = np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32)
    v[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0]]  # the poles and the z = 0 seam
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_oct_encode_decode():
    v = _unit_vectors(400, 4)
    e = pm.oct_encode(torch.from_numpy(v))
    _exact(e, jm.oct_encode(jnp.asarray(v)))
    assert bool((v[:, 2] <= 0).any()) and bool((v[:, 2] > 0).any())
    back = pm.oct_decode(e)
    _close(back, jm.oct_decode(jnp.asarray(e.numpy())))
    assert torch.allclose(back, torch.from_numpy(v), atol=1e-5)  # the round trip


def test_project_points():
    rng = np.random.default_rng(5)
    view = jm.look_at(np.array([0.3, 1.0, 4.0]), np.zeros(3), np.array([0.0, 1.0, 0.0]))
    m = (jm.infinite_reverse_z_projection(0.8, 1.5, 0.1) @ view).astype(np.float32)
    pts = rng.uniform(-1.0, 1.0, (6, 30, 3)).astype(np.float32)
    p = pm.project_points(torch.from_numpy(m), torch.from_numpy(pts))
    _close(p, jm.project_points(jnp.asarray(m), jnp.asarray(pts)))


def test_fetch_resource(scenes):
    _, ps, _ = scenes["cornell"]
    r = prenderer.Renderer(ps, pcfg.RenderConfig(width=32, height=24, alpha_raster="off"),
                           device="cpu")
    r.render_frame()
    idx = r.frame_index
    depth = r.fetch_resource(phybrid.DEPTH)
    assert torch.is_tensor(depth) and depth.shape == (24, 32)
    both = r.fetch_resource(phybrid.DEPTH, phybrid.ALBEDO)
    assert isinstance(both, tuple) and len(both) == 2
    ref = r.fetch_resources(phybrid.DEPTH, phybrid.ALBEDO)
    assert torch.equal(depth, ref[phybrid.DEPTH]) and torch.equal(both[0], ref[phybrid.DEPTH])
    assert torch.equal(both[1], ref[phybrid.ALBEDO]) and float(depth.max()) > 0
    assert r.frame_index == idx
