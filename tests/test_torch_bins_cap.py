"""The port's static binning against the JAX package's: default_e_cap, the
per-tile entry lists and Bins.overflow of a binning cut short by its cap,
the NaN depth poison of rasterize_scene (and rasterize_scene_msaa) on
overflow, and Renderer.check_binning's error.

Tolerance: none.  The cap, the kept entries (the first e_cap in triangle
order), their per-tile order, the overflow counts and the error text are
integers and strings, equal to the reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vulkanhybridrenderer_tpu.core import config as jcfg
from vulkanhybridrenderer_tpu.ops import geometry as jgeo
from vulkanhybridrenderer_tpu.ops import rasterizer as jrast
from vulkanhybridrenderer_tpu.ops import rasterizer_tiled as jrt
from vulkanhybridrenderer_tpu.runtime import renderer as jrenderer
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.ops import rasterizer as prast
from vulkanhybridrenderer_tpu_torch.ops import rasterizer_tiled as prt
from vulkanhybridrenderer_tpu_torch.runtime import renderer as prenderer

torch.set_num_threads(2)
W, H = 96, 64


@pytest.mark.parametrize("t", [0, 1, 100, 16383, 16384, 16385, 65536, 108732, 254636, 10**6])
@pytest.mark.parametrize("npix", [1, W * H, 1920 * 1080, 2**22, 2**22 + 1, 4096 * 4096])
def test_default_e_cap_as_reference(t, npix):
    assert prt.default_e_cap(t, npix) == jrt.default_e_cap(t, npix)


def _setups(js, w, h):
    clip = jgeo.to_clip(jgeo.to_world(js.buffers).position,
                        jnp.asarray((js.camera.projection(w / h) @ js.camera.view())
                                    .astype(np.float32)))
    j = jrast.triangle_setup(clip, js.buffers.tri_vertex, w, h)
    p = prast.TriangleSetup(**{f.name: torch.from_numpy(np.array(getattr(j, f.name)))
                               for f in dataclasses.fields(j)})
    return clip, j, p


def _per_tile(j, p, ntiles):
    """Each tile's entries from both binnings, in order."""
    ids = np.asarray(j.entry_data)[:, 12, :].reshape(-1).astype(np.int32)
    offs, counts = np.asarray(j.offsets), np.asarray(j.counts)
    for t in range(ntiles):
        yield (ids[offs[t]:offs[t] + counts[t]],
               p.entry_tri[p.offsets[t]:p.offsets[t + 1]].numpy())


@pytest.mark.parametrize("e_cap", [None, 700, 64])
def test_bins_per_tile_and_overflow_match_jax(e_cap):
    """The default cap, and caps that cut the small SponzaProxy's entries
    short: the same kept entries per tile, the same overflow; entries past
    the live count are padding (-1) and no tile's range reaches them."""
    js = jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8)
    _, jsetup, psetup = _setups(js, W, H)
    j = jrt.bin_triangles(jsetup, W, H, e_cap=e_cap)
    p = prt.bin_triangles(psetup, W, H, e_cap=e_cap)
    cap = e_cap or prt.default_e_cap(psetup.planes.shape[0], W * H)
    assert p.entry_tri.shape == (cap,) and p.overflow.dtype == torch.int32
    assert p.overflow.tolist() == np.asarray(j.overflow).tolist()
    if e_cap is not None:
        assert int(p.overflow[0]) > 0
    live = int(p.offsets[-1])
    assert live == min(cap, live + int(p.overflow[0]))
    assert (p.entry_tri[live:] == -1).all() and (p.entry_tri[:live] >= 0).all()
    for want, got in _per_tile(j, p, p.ntx * p.nty):
        np.testing.assert_array_equal(got, want)


def test_overflow_poisons_depth(monkeypatch):
    """The reference's every-frame guard: a cap below the entry count
    NaN-poisons the depth, as the reference's rasterize_scene does (its
    Pallas kernel in interpret mode), and every sample of the MSAA raster."""
    js = jproc.cornell_box()
    clip, _, psetup = _setups(js, W, H)
    pb = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera),
                                 dataclasses.asdict(js.light)).buffers.to("cpu")
    pclip = torch.from_numpy(np.array(clip))
    ok = prt.rasterize_scene(pb, pclip, W, H)
    assert torch.isfinite(ok.depth).all()
    monkeypatch.setattr(jrt, "default_e_cap", lambda t, npix: 8)
    monkeypatch.setattr(prt, "default_e_cap", lambda t, npix: 8)
    j = jrt.rasterize_scene(js.buffers, clip, W, H, interpret=True)
    p = prt.rasterize_scene(pb, pclip, W, H)
    assert np.isnan(np.asarray(j.depth)).all() and torch.isnan(p.depth).all()
    # the 8 kept entries raster as the reference's do, dropping the rest:
    # the same triangles, the same pixels but for edges where XLA's fused
    # multiply-adds round a plane otherwise (8 of 6,144 pixels measured)
    jt, pt = np.asarray(j.tri_id), p.tri_id.numpy()
    assert set(np.unique(jt)) == set(np.unique(pt)) and (jt == pt).mean() >= 0.998
    assert 0 < int((p.tri_id >= 0).sum()) < int((ok.tri_id >= 0).sum())
    for vis in prt.rasterize_scene_msaa(pb, pclip, W, H, 4):
        assert torch.isnan(vis.depth).all()


def test_check_binning_raises_the_reference_error(monkeypatch):
    """A cap below the camera view's entries: the first frame raises, with
    the reference's text word for word; later frames are guarded on the
    device (the poisoned depth isolated by find_nonfinite_pass)."""
    w, h = 80, 48  # a size no other binning in this file traces
    js = jproc.cornell_box()
    kw = dict(width=w, height=h, shadow_map_size=128, alpha_raster="off")
    jr = jrenderer.Renderer(js, jcfg.RenderConfig(bvh_dtype="f32", bvh_leaf_max=8, **kw))
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    pr = prenderer.Renderer(ps, pcfg.RenderConfig(**kw), device="cpu")
    ok = prenderer.Renderer(ps, pcfg.RenderConfig(**kw), device="cpu")
    ok.render_frame()
    monkeypatch.setattr(jrt, "default_e_cap", lambda t, npix: 16)
    monkeypatch.setattr(prt, "default_e_cap", lambda t, npix: 16)
    with pytest.raises(RuntimeError) as want:
        jr.check_binning()
    with pytest.raises(RuntimeError) as got:
        pr.render_frame()
    assert str(got.value) == str(want.value)
    assert "binned rasterizer entry overflow at 80x48" in str(got.value)
    assert pr.frame_index == 0
    # past the first frame nothing is checked on the host: the depth is poisoned
    assert not torch.isfinite(ok.render_frame()).all()
    assert ok.find_nonfinite_pass() == "G-Buffer Pass"
