"""The port's binned alpha depth-peel (K1b / K1c; on the CPU their plain
PyTorch version) against the JAX package's rasterize_scene(alpha=True), whose
Pallas kernel runs in interpret mode, on the same clip-space vertices.

Tolerance: the triangle id agrees on >= 99.9% of pixels; where it agrees,
depth within 1e-6 and bary within 1e-5.  XLA's CPU backend contracts the
kernel's A*px + B*py + C into FMAs (the port rounds every product), which
moves bary by up to ~1e-5 and can flip the alpha test of a pixel whose
interpolated alpha sits on the cutoff.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vulkanhybridrenderer_tpu.ops import geometry as jgeo
from vulkanhybridrenderer_tpu.ops import rasterizer_tiled as jrt
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.ops import rasterizer as prast
from vulkanhybridrenderer_tpu_torch.ops import rasterizer_tiled as prt
from vulkanhybridrenderer_tpu_torch.ops import shadetab as ptab

torch.set_num_threads(2)


def _stacked_leaves_scene(n_layers=3):
    """An opaque checker floor under n_layers alpha-masked leaf quads seen
    from above: a leaf's cutouts reveal the next leaf below, so the peel
    needs several rounds (the scene of the reference's peel tests)."""
    from vulkanhybridrenderer_tpu.scene.procedural import (
        Camera, SceneBuilder, checker_texture, leaf_texture,
        make_directional_light, quad_mesh, scale_mat, translate,
    )

    b = SceneBuilder()
    tex = b.add_texture(checker_texture(), srgb=True)
    leaf = b.add_texture(leaf_texture(), srgb=True)
    b.add(quad_mesh((1.0, 1.0)), translate([0, 0, 0]) @ scale_mat([2, 1, 2]),
          base_color_texture=tex, metallic_factor=0.0, roughness_factor=1.0)
    for i in range(n_layers):
        b.add(quad_mesh((1.0, 1.0)), translate([0.12 * i, 0.5 + 0.4 * i, 0.1 * i]),
              base_color_texture=leaf, metallic_factor=0.0, roughness_factor=1.0,
              alpha_mask=1, alpha_cutoff=0.5)
    cam = Camera(yfov=np.deg2rad(60.0), znear=0.05, aspect=1.0, pitch=-1.35,
                 position=np.array([0.0, 3.5, 0.6], np.float32))
    return b.build("StackedLeaves", cam, make_directional_light([0.0, -1.0, -0.2], intensity=6.0))


SCENES = {
    "checker_leaf": (lambda: jproc.checker_quad(alpha_leaf=True), 64, 64),
    "stacked_leaves": (_stacked_leaves_scene, 96, 96),
    "sponza": (lambda: jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12,
                                          grid_res=8), 96, 64),
}


@functools.cache
def _case(name):
    make, w, h = SCENES[name]
    js = make()
    view, proj = js.camera.view(), js.camera.projection(w / h)
    clip = jgeo.to_clip(jgeo.to_world(js.buffers).position, jnp.asarray((proj @ view).astype(np.float32)))
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    pb = ps.buffers.to("cpu")
    return dict(name=name, js=js, pb=pb, clip=clip, pclip=torch.from_numpy(np.array(clip)),
                tables=ptab.build_shade_tables(pb), w=w, h=h)


def _assert_matches(p, j):
    jt, pt = np.asarray(j.tri_id), p.tri_id.numpy()
    agree = jt == pt
    assert agree.mean() >= 0.999, agree.mean()
    np.testing.assert_allclose(p.depth.numpy()[agree], np.asarray(j.depth)[agree], rtol=0, atol=1e-6)
    np.testing.assert_allclose(p.bary.numpy()[agree], np.asarray(j.bary)[agree], rtol=0, atol=1e-5)


def test_peel_matches_jax():
    """(The other scenes are in test_torch_peel_checker.py and
    test_torch_peel_sponza.py: one JAX peel compiles for ~20 s on a CPU.)"""
    check_peel_matches_jax(_case("stacked_leaves"))


def check_peel_matches_jax(case):
    w, h = case["w"], case["h"]
    j = jrt.rasterize_scene(case["js"].buffers, case["clip"], w, h, interpret=True, alpha=True)
    trace = []
    setup = prast.triangle_setup(case["pclip"], case["pb"].tri_vertex, w, h)
    peeled, overflow = prt.rasterize_alpha_peeled(case["pb"], setup, w, h, case["tables"],
                                                  trace=trace)
    assert overflow.tolist() == [0]
    p = prt.rasterize_scene(case["pb"], case["pclip"], w, h, alpha=True, tables=case["tables"])
    _assert_matches(p, j)
    masked = set(case["pb"].alpha_tri_idx.tolist())
    assert masked & set(np.unique(p.tri_id.numpy()).tolist())  # a leaf is visible
    assert trace[0]["killed"] > 0  # the alpha kill did work
    # the masked stream is merged over the opaque one where it wins
    take = peeled.tri_id >= 0
    assert torch.equal(p.tri_id[take & (p.depth == peeled.depth)],
                       peeled.tri_id[take & (p.depth == peeled.depth)])


@pytest.mark.parametrize("rounds", [1, 2])
def test_peel_rounds_match_jax(rounds):
    """alpha_peel_rounds threads through: a smaller bound on the peel depth
    gives the reference's result at that bound (4 is the test above)."""
    case = _case("stacked_leaves")
    w, h = case["w"], case["h"]
    j = jrt.rasterize_scene(case["js"].buffers, case["clip"], w, h, interpret=True,
                            alpha=True, alpha_rounds=rounds)
    p = prt.rasterize_scene(case["pb"], case["pclip"], w, h, alpha=True,
                            tables=case["tables"], alpha_rounds=rounds)
    _assert_matches(p, j)


def test_peel_rounds_bound_the_depth():
    """On the stacked leaves one round leaves pixels uncovered that four
    rounds resolve; on a single leaf layer, rounds after the first change
    nothing."""
    for name, differ in (("stacked_leaves", True), ("checker_leaf", False)):
        case = _case(name)
        a, b = (prt.rasterize_scene(case["pb"], case["pclip"], case["w"], case["h"],
                                    tables=case["tables"], alpha_rounds=n)
                for n in (1, 4))
        assert bool((a.tri_id != b.tri_id).any()) == differ, name


def test_compact_rounds_equal_full_width_rounds(monkeypatch):
    """Rounds 2+ raster only the tiles that hold a killed pixel (K1c); run
    every round full width (K1b) instead and the result is identical, bit
    for bit, as the reference's test pins for its remapped kernel."""
    case = _case("stacked_leaves")
    w, h = case["w"], case["h"]
    setup = prast.triangle_setup(case["pclip"], case["pb"].tri_vertex, w, h)
    trace = []
    compact, _ = prt.rasterize_alpha_peeled(case["pb"], setup, w, h, case["tables"],
                                            trace=trace)
    assert len(trace) >= 3 and trace[1]["tiles"] < prt.bin_triangles(setup, w, h).offsets.shape[0] - 1
    monkeypatch.setattr(
        prt, "raster_tiles_compact",
        lambda planes, bins, w_, h_, zcap, captid, tile_ids, n_live=None: prt.raster_tiles_peel(
            planes, bins, w_, h_, zcap, captid),
    )
    full, _ = prt.rasterize_alpha_peeled(case["pb"], setup, w, h, case["tables"])
    for f in ("tri_id", "depth", "bary"):
        assert torch.equal(getattr(compact, f), getattr(full, f)), f


def test_peel_kernels_plain_on_cpu():
    """K1b and K1c on CPU tensors run the plain version and launch nothing;
    K1c leaves unlisted tiles clear and equals K1b on the listed ones."""
    case = _case("sponza")
    w, h = 256, 24  # 2 x 3 tiles
    clip = case["pclip"]
    setup = prast.triangle_setup(clip, case["pb"].tri_vertex, w, h)
    bins = prt.bin_triangles(setup, w, h)
    gen = np.random.default_rng(3)
    full = prt.raster_tiles(setup.planes, bins, w, h)
    # bound every pixel just above or at its opaque winner: the next layer
    zcap = torch.where(torch.from_numpy(gen.uniform(size=(h, w)) < 0.5), full.depth,
                       torch.tensor(prt.BIG)).contiguous()
    captid = full.tri_id.contiguous()
    tiles = torch.tensor([1, 4], dtype=torch.int32)
    before = (prt.raster_tiles_peel.launches, prt.raster_tiles_compact.launches)
    peel = prt.raster_tiles_peel(setup.planes, bins, w, h, zcap, captid)
    comp = prt.raster_tiles_compact(setup.planes, bins, w, h, zcap, captid, tiles,
                                  torch.tensor([len(tiles)], dtype=torch.int32))
    assert (prt.raster_tiles_peel.launches, prt.raster_tiles_compact.launches) == before
    assert ((peel.tri_id != full.tri_id) & (full.tri_id >= 0)).any()  # the bound bites
    listed = torch.zeros((h, w), dtype=torch.bool)
    for t in tiles.tolist():
        ty, tx = divmod(t, bins.ntx)
        listed[ty * prt.TILE_H:(ty + 1) * prt.TILE_H, tx * prt.TILE_W:(tx + 1) * prt.TILE_W] = True
    clear = prt.clear_visibility(w, h, "cpu")
    for f in ("tri_id", "depth", "bary"):
        got, want, empty = getattr(comp, f), getattr(peel, f), getattr(clear, f)
        assert torch.equal(got[listed], want[listed]), f
        assert torch.equal(got[~listed], empty[~listed]), f
