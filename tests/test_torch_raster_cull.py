"""The tile raster's exact sub-tile culling (csrc/raster_tile.cu; on the CPU
its plain version, rasterizer_tiled.subtile_masks).

The kernels skip every (entry, 8x4 sub-tile) pair whose corner test fails.
Two properties make that skip exact, and each input below checks both:

- conservative: no pair is culled whose sub-tile holds a pixel centre that
  the entry covers (l0, l1, l2 >= 0 and 0 <= z <= 1, evaluated as
  raster_tiles_plain evaluates them, over every pixel of the tile);
- exact: raster_tiles_plain restricted to the passing pairs (each sub-tile's
  pixels rastered from only the entries whose bit is set for it) equals the
  dense raster_tiles_plain bit for bit (depth, tri id and bary).

Inputs: cornell_box() and the small SponzaProxy at 96x64, checker_quad with
an alpha leaf under its round-2 peel bound, each MSAA sample's offset planes
at 2, 4 and 8 samples, and random planes (hypothesis, and seeded numpy
cases) with coefficients of +-1e30, +-3.4e38, +-inf, NaN and signed zeros.
No JAX: the port's own scene builders make the inputs.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from vulkanhybridrenderer_tpu_torch.core.types import make_per_frame_data
from vulkanhybridrenderer_tpu_torch.ops import geometry, shadetab
from vulkanhybridrenderer_tpu_torch.ops import rasterizer_tiled as rt
from vulkanhybridrenderer_tpu_torch.ops.rasterizer import triangle_setup
from vulkanhybridrenderer_tpu_torch.scene import procedural
from vulkanhybridrenderer_tpu_torch.utils.math3d import matmul4

torch.set_num_threads(2)
W, H = 96, 64
SCENES = {
    "cornell": (procedural.cornell_box, 96, 64),
    "sponza": (lambda: procedural.sponza_proxy(columns=3, segments=6, extra_boxes=12,
                                               grid_res=8), 96, 64),
    "checker_leaf": (lambda: procedural.checker_quad(alpha_leaf=True), 64, 64),
}
SPECIAL = [np.inf, -np.inf, np.nan, 1e30, -1e30, 3.4e38, -3.4e38, 0.0, -0.0, 1e-30]


def _setup(name):
    make, w, h = SCENES[name]
    scene = make()
    b = scene.buffers.to("cpu")
    pfd = make_per_frame_data(scene.camera.view(), scene.camera.projection(w / h),
                              scene.light, w, h)
    clip = geometry.to_clip(geometry.to_world(b).position,
                            matmul4(pfd.camera_proj, pfd.camera_view))
    return b, triangle_setup(clip, b.tri_vertex, w, h), w, h


def _needed(planes, bins):
    """(E, 32) bool: sub-tiles holding a pixel centre the entry covers,
    evaluated over every pixel of its tile as raster_tiles_plain does."""
    tile_of = rt.entry_tiles(bins)
    local = torch.arange(rt.TILE_W * rt.TILE_H)
    lx, ly = local % rt.TILE_W, local // rt.TILE_W
    px = ((tile_of % bins.ntx) * rt.TILE_W)[:, None].float() + lx.float() + 0.5
    py = ((tile_of // bins.ntx) * rt.TILE_H)[:, None].float() + ly.float() + 0.5
    p = planes[bins.entry_tri.long()]
    l0, l1, l2, z = (px * p[:, k, None] + py * p[:, k + 1, None] + p[:, k + 2, None]
                     for k in (0, 3, 6, 9))
    covered = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & (z >= 0) & (z <= 1)
    sub = lx // rt.SUB_W + (rt.TILE_W // rt.SUB_W) * (ly // rt.SUB_H)
    need = torch.zeros((covered.shape[0], rt.N_SUBTILES), dtype=torch.bool)
    for s in range(rt.N_SUBTILES):
        need[:, s] = covered[:, sub == s].any(dim=1)
    return need


def _bits(masks):
    return ((masks[:, None] >> torch.arange(rt.N_SUBTILES)) & 1).bool()


def _same(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("tri_id", "depth", "bary"))


def _raster_passing(planes, bins, w, h, masks, zcap=None, captid=None, tile_ids=None):
    """raster_tiles_plain restricted to the passing pairs: the pixels of
    sub-tile s come from a raster of only the entries whose bit s is set."""
    tile_of = rt.entry_tiles(bins)
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    sub_of = (xs % rt.TILE_W) // rt.SUB_W + (rt.TILE_W // rt.SUB_W) * ((ys % rt.TILE_H) // rt.SUB_H)
    out = None
    for s in range(rt.N_SUBTILES):
        keep = ((masks >> s) & 1).bool()
        counts = torch.bincount(tile_of[keep], minlength=bins.ntx * bins.nty)
        offsets = torch.cat([torch.zeros(1, dtype=torch.int64), counts.cumsum(0)])
        sb = rt.Bins(entry_tri=bins.entry_tri[keep], offsets=offsets.to(torch.int32),
                     ntx=bins.ntx, nty=bins.nty)
        v = rt.raster_tiles_plain(planes, sb, w, h, zcap, captid, tile_ids)
        if out is None:
            out = v
            continue
        sel = sub_of == s
        out.depth[sel], out.tri_id[sel], out.bary[sel] = v.depth[sel], v.tri_id[sel], v.bary[sel]
    return out


def _check_exact(planes, bins, w, h, zcap=None, captid=None, masks=None):
    """Both properties on one input; returns the masks."""
    if masks is None:
        masks = rt.subtile_masks(planes, bins)
    assert masks.dtype == torch.int64 and masks.shape == bins.entry_tri.shape
    missed = _needed(planes, bins) & ~_bits(masks)
    assert not missed.any(), f"{int(missed.sum())} culled pairs hold a covered pixel"
    dense = rt.raster_tiles_plain(planes, bins, w, h, zcap, captid)
    culled = _raster_passing(planes, bins, w, h, masks, zcap, captid)
    assert _same(dense, culled)
    return masks


@pytest.mark.parametrize("name", ["cornell", "sponza"])
def test_culling_exact_on_scene(name):
    _, setup, w, h = _setup(name)
    bins = rt.bin_triangles(setup, w, h)
    assert bins.entry_tri.shape[0] > 0
    _check_exact(setup.planes, bins, w, h)


def test_culling_is_real_on_sponza():
    """On SponzaProxy most pairs are culled (0.07 of them pass at 96x64),
    and the passing ones are exactly the needed ones or a few more."""
    _, setup, w, h = _setup("sponza")
    bins = rt.bin_triangles(setup, w, h)
    masks = rt.subtile_masks(setup.planes, bins)
    share = float(_bits(masks).float().mean())
    assert 0.0 < share < 0.25, share
    assert (masks != (1 << rt.N_SUBTILES) - 1).any()
    need = float(_needed(setup.planes, bins).float().mean())
    assert need <= share < 2 * need


def test_culling_exact_under_peel_bound():
    """checker_quad with its alpha leaf: the masked stream under round 1's
    bound (admits every fragment) and under the round-2 bound of the pixels
    the alpha test killed (K1b, K1c)."""
    b, setup, w, h = _setup("checker_leaf")
    include = torch.zeros(setup.planes.shape[0], dtype=torch.bool)
    include[b.alpha_tri_idx.long()] = True
    bins = rt.bin_triangles(setup, w, h, include=include)
    zc = torch.full((h, w), rt.BIG)
    tc = torch.full((h, w), 2**31 - 1, dtype=torch.int32)
    masks = _check_exact(setup.planes, bins, w, h, zc, tc)
    v1 = rt.raster_tiles_plain(setup.planes, bins, w, h, zc, tc)
    _, killed = rt.alpha_test(shadetab.build_shade_tables(b), v1)
    assert killed.any()
    zc2, tc2 = rt.peel_bound(v1, killed)
    _check_exact(setup.planes, bins, w, h, zc2, tc2, masks=masks)
    tiles = rt.live_tiles(killed, bins.ntx, bins.nty)
    dense = rt.raster_tiles_plain(setup.planes, bins, w, h, zc2, tc2, tiles)
    culled = _raster_passing(setup.planes, bins, w, h, masks, zc2, tc2, tiles)
    assert _same(dense, culled)


@pytest.mark.parametrize("samples", [2, 4, 8])
def test_culling_exact_per_msaa_sample(samples):
    """Each sample's masks are those of its offset planes (as K1d makes
    them); K1d tests a pair when any sample passes, so the union must be
    exact on every sample too."""
    _, setup, w, h = _setup("sponza")
    bins = rt.bin_triangles(setup, w, h)
    per_sample = rt.subtile_masks(setup.planes, bins, samples=samples)
    assert per_sample.shape == (samples, bins.entry_tri.shape[0])
    union = per_sample[0]
    for m in per_sample[1:]:
        union = union | m
    for (sx, sy), m in zip(rt.MSAA_PATTERNS[samples], per_sample):
        shifted = rt.offset_planes(setup.planes, sx / 16.0, sy / 16.0)
        assert torch.equal(m, rt.subtile_masks(shifted, bins))
        _check_exact(shifted, bins, w, h, masks=m)
        _check_exact(shifted, bins, w, h, masks=union)


def _random_planes(rng, t, inject=()):
    """t triangles' planes over a 256x16 image (2 x 2 tiles): each l plane a
    line through a random point of the image, z a shallow ramp around
    [0, 1]; then `inject` (index, value) pairs overwrite coefficients."""
    planes = np.zeros((t, 12), np.float32)
    for k in range(3):
        ang = rng.uniform(0, 2 * np.pi, t)
        scale = 10.0 ** rng.uniform(-3, 2, t)
        a, b = np.cos(ang) * scale, np.sin(ang) * scale
        cx, cy = rng.uniform(0, 256, t), rng.uniform(0, 16, t)
        planes[:, 3 * k:3 * k + 3] = np.stack([a, b, -(a * cx + b * cy)], 1)
    planes[:, 9:11] = rng.normal(0, 1e-2, (t, 2))
    planes[:, 11] = rng.uniform(-0.5, 1.5, t)
    flat = planes.reshape(-1)
    for i, v in inject:
        flat[i] = v
    return torch.from_numpy(planes)


def _all_tiles_bins(t, w=256, h=16):
    """Every triangle in every tile of a w x h image, in id order."""
    ntx, nty = w // rt.TILE_W, h // rt.TILE_H
    n = ntx * nty
    return rt.Bins(entry_tri=torch.arange(t, dtype=torch.int32).repeat(n),
                   offsets=torch.arange(n + 1, dtype=torch.int32) * t, ntx=ntx, nty=nty)


T_RANDOM = 48


@settings(max_examples=30, deadline=None, database=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1),
       inject=st.lists(st.tuples(st.integers(0, T_RANDOM * 12 - 1),
                                 st.sampled_from(SPECIAL) | st.floats(width=32)),
                       max_size=48))
def test_culling_exact_on_random_planes(seed, inject):
    planes = _random_planes(np.random.default_rng(seed), T_RANDOM, inject)
    _check_exact(planes, _all_tiles_bins(T_RANDOM), 256, 16)


@pytest.mark.parametrize("seed", range(6))
def test_culling_exact_on_seeded_special_planes(seed):
    """The numpy-seeded fallbacks: a quarter of all coefficients replaced by
    special values; triangle 5 all NaN, and triangle 6 covering every pixel
    but for l0 = inf * px + -inf, NaN everywhere.  Neither covers a pixel,
    and a NaN keeps the pair: both keep every sub-tile."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(T_RANDOM * 12, T_RANDOM * 3, replace=False)
    idx = idx[(idx // 12 != 5) & (idx // 12 != 6)]
    inject = [(int(i), SPECIAL[int(j)]) for i, j in zip(idx, rng.integers(0, len(SPECIAL), idx.size))]
    inject += [(12 * 5 + k, np.nan) for k in range(12)]
    inject += list(zip(range(12 * 6, 12 * 7),
                       [np.inf, 0.0, -np.inf, 0.0, 0.0, 1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.5]))
    planes = _random_planes(rng, T_RANDOM, inject)
    assert not torch.isfinite(planes).all()
    bins = _all_tiles_bins(T_RANDOM)
    masks = _check_exact(planes, bins, 256, 16)
    assert not _needed(planes, bins)[(bins.entry_tri == 5) | (bins.entry_tri == 6)].any()
    for t in (5, 6):
        assert (masks[bins.entry_tri == t] == (1 << rt.N_SUBTILES) - 1).all()


def test_raster_pairs_prices_the_bound():
    """passing_pairs counts the pairs the masks pass, and raster_ops prices
    them as chip_smoke.py's K1 bounds do: the corner test's sign compares
    once per entry, the rest of it per (entry, sub-tile) pair."""
    _, setup, w, h = _setup("sponza")
    bins = rt.bin_triangles(setup, w, h)
    masks = rt.subtile_masks(setup.planes, bins)
    n_e, n_pass = int(bins.entry_tri.shape[0]), rt.passing_pairs(masks)
    assert n_pass == int(_bits(masks).sum())
    ops, dense = rt.raster_ops(n_e, n_pass, "K1a")
    assert dense == n_e * 1024 * rt.RASTER_OPS
    assert ops == (n_e * (rt.CULL_ENTRY_OPS + 32 * rt.CULL_PAIR_OPS)
                   + n_pass * 32 * rt.RASTER_OPS) < dense
    assert (rt.CULL_ENTRY_OPS, rt.CULL_PAIR_OPS) == (8, 25)
    assert rt.raster_ops(n_e, n_pass, "K1c")[1] == n_e * 1024 * rt.PEEL_OPS
    ops4, dense4 = rt.raster_ops(n_e, n_pass, "K1d", samples=4)
    assert dense4 == n_e * 1024 * (rt.MSAA_SHARED_OPS + 4 * rt.MSAA_SAMPLE_OPS)
    assert ops4 == (n_e * (rt.CULL_ENTRY_OPS + 4 * rt.MSAA_SHIFT_OPS
                           + 32 * (rt.MSAA_CULL_PAIR_OPS + 4 * rt.MSAA_CULL_SAMPLE_OPS))
                    + n_pass * 32 * (rt.MSAA_SHARED_OPS + 4 * rt.MSAA_SAMPLE_OPS)) < dense4
