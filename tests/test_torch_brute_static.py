"""The port's statically sized brute rasterizer (ops/rasterizer.rasterize)
against the reference's ``rasterize``.

Both iterate over every chunk of the triangles padded to whole chunks and
mask culled, degenerate and padding lanes; the port evaluates the fragment
mask densely over a block's (chunk, rows, width) fragments, as the
reference does over (chunk, H, W).  Exact: tri id, depth and bary equal on
every pixel, against the reference run op by op (``jax.disable_jit()``).
Cases: cornell_box() at 64x48 under each depth-compare preset and cull mode
at chunk 16 (74 triangles: 5 chunks of 15, one padding lane); chunk 1 with
back faces culled, where every back-facing triangle fills a chunk of its
own, so whole chunks hold only culled lanes; and
checker_quad(alpha_leaf=True) with the alpha fragment mask
(make_alpha_frag_mask) at chunk 3.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vulkanhybridrenderer_tpu.ops import gbuffer as jgb
from vulkanhybridrenderer_tpu.ops import geometry as jgeo
from vulkanhybridrenderer_tpu.ops import rasterizer as jrast
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.ops import gbuffer as pgb
from vulkanhybridrenderer_tpu_torch.ops import rasterizer as prast

torch.set_num_threads(2)
W, H = 64, 48


def _setups(js, w, h):
    world = jgeo.to_world(js.buffers)
    vp = js.camera.projection(aspect=w / h) @ js.camera.view()
    clip = jgeo.to_clip(world.position, jnp.asarray(np.asarray(vp, np.float32)))
    j = jrast.triangle_setup(clip, js.buffers.tri_vertex, w, h)
    p = prast.TriangleSetup(**{f.name: torch.tensor(np.array(getattr(j, f.name)))
                               for f in dataclasses.fields(prast.TriangleSetup)})
    return clip, j, p


def _assert_equal(j, p):
    for f in ("tri_id", "depth", "bary"):
        np.testing.assert_array_equal(getattr(p, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)


@pytest.fixture(scope="module")
def cornell():
    return _setups(jproc.cornell_box(), W, H)


@pytest.mark.parametrize("cull", [True, False], ids=["cull", "no-cull"])
@pytest.mark.parametrize("compare, clear", [("greater_equal", 0.0), ("less_equal", 1.0),
                                            ("always", 0.0)])
def test_presets_and_cull_modes(cornell, compare, clear, cull):
    _, j, p = cornell
    assert p.planes.shape[0] == 74
    kw = dict(chunk=16, cull_backface=cull, depth_compare=compare, depth_clear=clear)
    with jax.disable_jit():
        want = jrast.rasterize(j, W, H, **kw)
    got = prast.rasterize(p, W, H, **kw)
    _assert_equal(want, got)
    assert bool((got.tri_id >= 0).any())


def test_chunks_of_culled_triangles(cornell):
    """At chunk 1 every back-facing or degenerate triangle is a chunk with
    no live lane: it must change nothing."""
    _, j, p = cornell
    assert bool((~(p.valid & p.front)).any()) and bool((p.valid & p.front).any())
    with jax.disable_jit():
        want = jrast.rasterize(j, W, H, chunk=1)
    _assert_equal(want, prast.rasterize(p, W, H, chunk=1))


def test_dense_alpha_frag_mask():
    """checker_quad(alpha_leaf=True): the leaf quad's transparent texels
    are killed by the dense mask on both sides, and the kill exposes the
    floor behind them."""
    js = jproc.checker_quad(alpha_leaf=True)
    clip, j, p = _setups(js, W, H)
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    with jax.disable_jit():
        want = jrast.rasterize(j, W, H, chunk=3,
                               frag_mask_fn=jgb.make_alpha_frag_mask(js.buffers, clip))
    got = prast.rasterize(p, W, H, chunk=3,
                          frag_mask_fn=pgb.make_alpha_frag_mask(ps.buffers.to("cpu")))
    _assert_equal(want, got)
    solid = prast.rasterize(p, W, H, chunk=3)
    assert bool((got.tri_id != solid.tri_id).any())
