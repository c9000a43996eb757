"""The port's multisampled raster (K1d; on the CPU its plain version) against
the JAX package's rasterize_scene_msaa, whose Pallas kernel runs in
interpret mode, on the same clip-space vertices.

Tolerances, per sample: the triangle id agrees on >= 99.9% of pixels
(measured >= 0.99967); where it agrees, depth within 1e-5 (measured 7.5e-6)
and bary within 1e-4 (measured 6.1e-5).  These are looser than the
single-sample raster's because XLA contracts the jitted triangle setup's
multiply-adds into FMAs (the port rounds every product) and a sample offset
moves C by up to 7/16 of a pixel's A and B, which carries that difference
further on steep triangles.  The offset planes themselves equal the
reference's bit for bit.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vulkanhybridrenderer_tpu.ops import geometry as jgeo
from vulkanhybridrenderer_tpu.ops import rasterizer as jrast
from vulkanhybridrenderer_tpu.ops import rasterizer_tiled as jrt
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.ops import rasterizer as prast
from vulkanhybridrenderer_tpu_torch.ops import rasterizer_tiled as prt
from vulkanhybridrenderer_tpu_torch.ops import shadetab as ptab

torch.set_num_threads(2)
W, H = 96, 64


@functools.cache
def _case(name):
    js = (jproc.cornell_box() if name == "cornell"
          else jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8))
    view, proj = js.camera.view(), js.camera.projection(W / H)
    clip = jgeo.to_clip(jgeo.to_world(js.buffers).position,
                        jnp.asarray((proj @ view).astype(np.float32)))
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    pb = ps.buffers.to("cpu")
    return dict(js=js, clip=clip, pb=pb, pclip=torch.from_numpy(np.array(clip)),
                tables=ptab.build_shade_tables(pb))


def test_patterns_are_the_reference_patterns():
    assert prt.MSAA_PATTERNS == {k: v for k, v in jrt.MSAA_PATTERNS.items() if k > 1}


@pytest.mark.parametrize("samples", [2, 4, 8])
def test_offset_planes_match_reference(samples):
    """offset_planes rounds C + ((A dx) + (B dy)) like both reference forms:
    _offset_setup on the triangle planes, offset_bins on the packed entry
    rows (which also shift the padding rows' zero planes)."""
    case = _case("sponza")
    setup = jrast.triangle_setup(case["clip"], case["js"].buffers.tri_vertex, W, H)
    planes = np.array(setup.planes)
    bins = jrt.bin_triangles(setup, W, H)
    rows = np.array(bins.entry_data).transpose(0, 2, 1).reshape(-1, 16)[:, :12]
    for sx, sy in jrt.MSAA_PATTERNS[samples]:
        dx, dy = sx / 16.0, sy / 16.0
        want = np.asarray(jrt._offset_setup(setup, dx, dy).planes)
        got = prt.offset_planes(torch.from_numpy(planes), dx, dy).numpy()
        np.testing.assert_array_equal(got, want)
        shifted = np.array(jrt.offset_bins(bins, dx, dy).entry_data)
        want_rows = shifted.transpose(0, 2, 1).reshape(-1, 16)[:, :12]
        got_rows = prt.offset_planes(torch.from_numpy(rows.copy()), dx, dy).numpy()
        np.testing.assert_array_equal(got_rows, want_rows)


def _assert_sample_matches(p, j):
    jt, pt = np.asarray(j.tri_id), p.tri_id.numpy()
    agree = jt == pt
    assert agree.mean() >= 0.999, agree.mean()
    np.testing.assert_allclose(p.depth.numpy()[agree], np.asarray(j.depth)[agree],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(p.bary.numpy()[agree], np.asarray(j.bary)[agree],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("name,samples,alpha", [
    ("cornell", 2, False), ("cornell", 4, False), ("cornell", 8, False),
    ("sponza", 2, False), ("sponza", 4, False), ("sponza", 8, False),
    # one JAX peel per sample compiles for ~10 s: the 4-sample peel is held
    # in test_torch_forward_sponza.py's frames
    ("sponza", 2, True),
])
def test_msaa_matches_jax(name, samples, alpha):
    case = _case(name)
    run = functools.partial(jrt.rasterize_scene_msaa, width=W, height=H, samples=samples,
                            interpret=True, alpha=alpha)
    if alpha:  # eager, each peel round's lax.cond would compile anew
        run = jax.jit(run)
    j = run(case["js"].buffers, case["clip"])
    p = prt.rasterize_scene_msaa(case["pb"], case["pclip"], W, H, samples, alpha=alpha,
                                 tables=case["tables"])
    assert len(p) == len(j) == samples
    for pv, jv in zip(p, j):
        _assert_sample_matches(pv, jv)
    # the samples really sit at different positions: some edge pixel differs
    assert any(bool((pv.tri_id != p[0].tri_id).any()) for pv in p[1:])
    if alpha:
        masked = set(case["pb"].alpha_tri_idx.tolist())
        assert any(masked & set(np.unique(pv.tri_id.numpy()).tolist()) for pv in p)


@pytest.mark.parametrize("samples", [2, 4, 8])
def test_k1d_plain_is_k1a_on_offset_planes(samples):
    """K1d's plain version (CPU tensors) launches nothing and equals K1a's
    plain version on offset_planes bit for bit, sample by sample, on bins
    made once at pixel centres."""
    case = _case("sponza")
    setup = prast.triangle_setup(case["pclip"], case["pb"].tri_vertex, W, H)
    bins = prt.bin_triangles(setup, W, H)
    before = prt.raster_tiles_msaa.launches
    vises = prt.raster_tiles_msaa(setup.planes, bins, W, H, samples)
    assert prt.raster_tiles_msaa.launches == before
    for (sx, sy), v in zip(prt.MSAA_PATTERNS[samples], vises):
        want = prt.raster_tiles(prt.offset_planes(setup.planes, sx / 16.0, sy / 16.0),
                                bins, W, H)
        for f in ("tri_id", "depth", "bary"):
            assert torch.equal(getattr(v, f), getattr(want, f)), f


def test_msaa_rejects_other_sample_counts():
    case = _case("cornell")
    for samples in (1, 3, 16):
        with pytest.raises(ValueError):
            prt.rasterize_scene_msaa(case["pb"], case["pclip"], W, H, samples)
