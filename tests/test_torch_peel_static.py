"""The port's alpha peel without host syncs against the reference's
rasterize_alpha_peeled itself (its Pallas kernel in interpret mode, as the
JAX package's own tests run it on the CPU), on the small SponzaProxy and on
checker_quad(alpha_leaf=True), whose later rounds have no live tile: every
round runs, over live_tiles' list of every tile with its count on the
device, and a round with nothing to raster changes nothing.

Tolerance (test_torch_peel.py's): the triangle id agrees on >= 99.9% of
pixels; where it agrees, depth within 1e-6 and bary within 1e-5 (XLA's CPU
backend contracts the kernel's A*px + B*py + C into FMAs).  The overflow
counts and the live-tile lists are integers, equal.
"""
import numpy as np
import pytest
import torch

from test_torch_peel import _assert_matches, _case
from vulkanhybridrenderer_tpu.ops import rasterizer as jrast
from vulkanhybridrenderer_tpu.ops import rasterizer_tiled as jrt
from vulkanhybridrenderer_tpu.ops import shadetab as jtab
from vulkanhybridrenderer_tpu_torch.ops import rasterizer as prast
from vulkanhybridrenderer_tpu_torch.ops import rasterizer_tiled as prt

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["sponza", "checker_leaf"])
def test_static_peel_matches_reference_peel(name):
    case = _case(name)
    w, h = case["w"], case["h"]
    jsetup = jrast.triangle_setup(case["clip"], case["js"].buffers.tri_vertex, w, h)
    j, j_overflow = jrt.rasterize_alpha_peeled(
        case["js"].buffers, jsetup, w, h, jtab.build_shade_tables(case["js"].buffers),
        rounds=4, interpret=True)
    psetup = prast.triangle_setup(case["pclip"], case["pb"].tri_vertex, w, h)
    trace = []
    p, p_overflow = prt.rasterize_alpha_peeled(case["pb"], psetup, w, h, case["tables"],
                                               rounds=4, trace=trace)
    assert p_overflow.tolist() == np.asarray(j_overflow).tolist() == [0]
    _assert_matches(p, j)
    assert (p.tri_id >= 0).any() and trace[0]["killed"] > 0
    if name == "checker_leaf":
        # one leaf layer: round 2 finds nothing under the killed pixels, and
        # rounds 3-4 run over an empty list (the trace stops at the first)
        assert len(trace) < 4


def test_live_tiles_lists_every_tile_on_the_device():
    """live_tiles: the ids of the tiles holding a killed pixel in ascending
    order, -1 in every later slot of a list as long as the image's tiles,
    and their count as a (1,) int32 tensor."""
    ntx, nty = 3, 4
    killed = torch.zeros((nty * prt.TILE_H - 3, ntx * prt.TILE_W - 5), dtype=torch.bool)
    killed[9, 130] = killed[28, 0] = killed[0, 300] = True  # tiles 4, 9 and 2
    ids, n = prt.live_tiles(killed, ntx, nty)
    assert ids.dtype == n.dtype == torch.int32 and ids.shape == (12,) and n.shape == (1,)
    assert ids.tolist() == [2, 4, 9] + [-1] * 9 and n.tolist() == [3]
    ids, n = prt.live_tiles(torch.zeros_like(killed), ntx, nty)
    assert ids.tolist() == [-1] * 12 and n.tolist() == [0]


def test_compact_list_count_and_sentinels():
    """K1c's plain version with a device count: slots at or past n_live list
    nothing even when they hold tile ids, -1 lists nothing, and n_live = 0
    leaves every pixel clear (the empty round)."""
    case = _case("sponza")
    w, h = 256, 24  # 2 x 3 tiles
    setup = prast.triangle_setup(case["pclip"], case["pb"].tri_vertex, w, h)
    bins = prt.bin_triangles(setup, w, h)
    full = prt.raster_tiles(setup.planes, bins, w, h)
    zcap = torch.full((h, w), prt.BIG)
    captid = torch.full((h, w), 2**31 - 1, dtype=torch.int32)
    want = prt.raster_tiles_compact(setup.planes, bins, w, h, zcap, captid,
                                    torch.tensor([1, 4], dtype=torch.int32),
                                    torch.tensor([2], dtype=torch.int32))
    got = prt.raster_tiles_compact(setup.planes, bins, w, h, zcap, captid,
                                   torch.tensor([1, -1, 4, 0, 5, 3], dtype=torch.int32),
                                   torch.tensor([3], dtype=torch.int32))
    for f in ("tri_id", "depth", "bary"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert (want.tri_id[:8, 128:] == full.tri_id[:8, 128:]).all()  # tile 1 rastered
    assert (want.tri_id[:8, :128] == -1).all()  # tile 0 past the count: clear
    empty = prt.raster_tiles_compact(setup.planes, bins, w, h, zcap, captid,
                                     torch.arange(6, dtype=torch.int32),
                                     torch.zeros(1, dtype=torch.int32))
    assert (empty.tri_id == -1).all() and (empty.depth == 0).all()


def test_alpha_kill_reads_the_fields_it_needs():
    """alpha_test's narrow gathers (13 columns of a static row, the alpha of
    each tap) give fetch_tri_static's fields and sample_atlas4's alpha bit
    for bit, on every triangle of the small SponzaProxy (textured or not)
    at uvs past [0, 1) in both directions."""
    from vulkanhybridrenderer_tpu_torch.ops import shadetab as ptab

    case = _case("sponza")
    tables = case["tables"]
    ids = torch.arange(case["pb"].num_triangles).repeat(3)
    uv = torch.from_numpy(np.random.default_rng(7).uniform(-3, 3, (ids.shape[0], 2))
                          .astype(np.float32))
    full, narrow = ptab.fetch_tri_static(tables, ids), ptab.fetch_alpha_fields(tables, ids)
    for k, v in narrow.items():
        assert torch.equal(v, full[k]), k
    args = (full["base_tex"], full["base_scale"], full["base_offset"], uv)
    assert torch.equal(ptab.sample_atlas_alpha(tables, *args),
                       ptab.sample_atlas4(tables, *args)[..., 3])
    assert (full["base_tex"] >= 0).any() and (full["base_tex"] < 0).any()
