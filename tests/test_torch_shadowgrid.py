"""The port's light-space shadow grid (ops/shadowgrid.py) against the JAX
package's, and its plain trace (K3's plain version) against the reference's
trace and the port's BVH8 any-hit walk (K2's plain version).

The build equals the reference's under ``jax.disable_jit()`` (jit contracts
the dilation's multiply-add into an FMA): the same resolution, offsets,
entry rows (inlined triangles and ids, the padding rows too), big rows,
num_big and overflow, both builds sized from the triangle count alone.  The
hit masks are compared exactly, on the rays of tests/test_shadowgrid.py:
surface-born, cone-jittered toward the light.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vulkanhybridrenderer_tpu.ops import bvh as jbvh
from vulkanhybridrenderer_tpu.ops import shadowgrid as jsg
from vulkanhybridrenderer_tpu.ops import traverse as jtrav
from vulkanhybridrenderer_tpu.ops.geometry import to_world
from vulkanhybridrenderer_tpu.ops.sampling import to_basis, uniform_sample_cone
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu.utils.math3d import normalize
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.ops import bvh8 as pbvh8
from vulkanhybridrenderer_tpu_torch.ops import shadetab as ptab
from vulkanhybridrenderer_tpu_torch.ops import shadowgrid as psg
from vulkanhybridrenderer_tpu_torch.ops import traverse as ptrav

torch.set_num_threads(2)
SCENES = {
    "cornell": (jproc.cornell_box, 4096),
    "sponza": (lambda: jproc.sponza_proxy(columns=4, segments=8, extra_boxes=24, grid_res=8),
               8192),
}


def _t(x):
    return torch.from_numpy(np.array(x))


def _scene_rays(sc, n, seed=1):
    """tests/test_shadowgrid.py:17-33: origins on triangles + 0.1 up, rays
    cone-jittered toward the light as raygen jitters them."""
    world = to_world(sc.buffers, sc.buffers.prim_transform)
    tris = jbvh.world_triangles(world.position, sc.buffers.tri_vertex)
    t = np.asarray(tris)
    rng = np.random.default_rng(seed)
    ti = rng.integers(0, t.shape[0], n)
    b = rng.dirichlet([1, 1, 1], n).astype(np.float32)
    o = np.einsum("nk,nkj->nj", b, t[ti]) + np.array([0, 0.1, 0], np.float32)
    l = -np.asarray(sc.light.direction[:3])
    u2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    cone = normalize(uniform_sample_cone(jnp.asarray(u2), 0.999995))
    d = to_basis(jnp.broadcast_to(jnp.asarray(l), (n, 3)), cone)
    return tris, jnp.asarray(o), d, jnp.asarray(l)


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    make, n = SCENES[request.param]
    sc = make()
    tris, o, d, l = _scene_rays(sc, n)
    with jax.disable_jit():
        jg = jsg.build_shadow_grid(tris, -l)
    pg = psg.build_shadow_grid(_t(tris), _t(-l))
    return dict(sc=sc, tris=tris, o=o, d=d, jg=jg, pg=pg)


def test_build_matches(case):
    jg, pg = case["jg"], case["pg"]
    assert pg.grid == jg.grid and pg.span_cap == jg.span_cap
    np.testing.assert_array_equal(pg.offsets.numpy(), np.asarray(jg.offsets))
    assert int(pg.offsets[-1]) > 0 and pg.num_entries == jg.entries.shape[0]
    np.testing.assert_array_equal(pg.entries.numpy(), np.asarray(jg.entries))
    np.testing.assert_array_equal(pg.big.numpy(), np.asarray(jg.big))
    assert pg.num_big.dtype == pg.overflow.dtype == torch.int32
    assert int(pg.num_big) == int(jg.num_big) and int(pg.overflow) == int(jg.overflow) == 0
    for f in ("u_axis", "v_axis", "origin_uv", "inv_cell"):
        np.testing.assert_array_equal(getattr(pg, f).numpy(), np.asarray(getattr(jg, f)), f)
    assert torch.equal(pg.frame, torch.cat([pg.u_axis, pg.v_axis, pg.origin_uv, pg.inv_cell]))


def test_grid_resolution_matches(case):
    """The host sizing alone, and a rebuild at a given resolution (the
    animated path's)."""
    tris, jg = case["tris"], case["jg"]
    l = np.asarray(case["sc"].light.direction[:3])
    assert psg.grid_resolution(np.asarray(tris), l) == jg.grid
    half = psg.build_shadow_grid(_t(tris), _t(l), grid=jg.grid // 2)
    assert half.grid == jg.grid // 2 and half.offsets.shape[0] == (jg.grid // 2) ** 2 + 1


def test_trace_matches_reference_and_bvh(case):
    """Identical hit masks: the port's plain grid trace, the reference's
    grid trace, and the port's BVH8 any-hit walk on the same rays."""
    o, d = _t(case["o"]), _t(case["d"])
    n = o.shape[0]
    tmin, tmax = torch.full((n,), 0.01), torch.full((n,), 1e4)
    hit, tested = psg.trace_shadow_plain(case["pg"], o, d, tmin, tmax, visits=True)
    ref = np.asarray(jsg.trace_shadow(case["jg"], case["o"], case["d"], 0.01, 1e4))
    np.testing.assert_array_equal(hit.numpy(), ref)
    b8 = pbvh8.build_bvh8_sah_host(np.asarray(case["tris"]))
    bvh_hit = ptrav.trace(b8, None, o, d, 0.01, 1e4, anyhit=True).hit
    np.testing.assert_array_equal(hit.numpy(), bvh_hit.numpy())
    assert 0 < int(hit.sum()) < n or case["pg"].num_big > 0
    # the wrapper on CPU tensors is the plain version; a ray tests at most
    # its cell's entries and the big rows
    assert torch.equal(psg.trace_shadow(case["pg"], o, d, 0.01, 1e4), hit)
    cell = psg.origin_cells(case["pg"], o)
    count = case["pg"].offsets[cell + 1] - case["pg"].offsets[cell]
    assert bool((tested <= count + case["pg"].num_big).all()) and int(tested.sum()) > 0


def test_dead_rays_and_max_steps(case):
    """tmax < tmin tests nothing; the max_steps cap equals the reference's
    (a ray tests at most max_steps cell entries, then the big tier)."""
    o, d = _t(case["o"]), _t(case["d"])
    n = o.shape[0]
    tmin = torch.full((n,), 0.01)
    tmax = torch.where(torch.arange(n) % 3 == 0, -1.0, 1e4)
    hit, tested = psg.trace_shadow_plain(case["pg"], o, d, tmin, tmax, visits=True)
    assert not hit[::3].any() and not tested[::3].any()
    full = psg.trace_shadow_plain(case["pg"], o, d, tmin, torch.full((n,), 1e4))
    for steps in (1, 3):
        capped, tested = psg.trace_shadow_plain(case["pg"], o, d, tmin, torch.full((n,), 1e4),
                                                max_steps=steps, visits=True)
        ref = jsg.trace_shadow(case["jg"], case["o"], case["d"], 0.01, 1e4, max_steps=steps)
        np.testing.assert_array_equal(capped.numpy(), np.asarray(ref))
        assert bool((tested <= steps + case["pg"].num_big).all())
        assert bool((capped <= full).all())
        if steps == 1:
            assert int(capped.sum()) < int(full.sum())


def test_alpha_filter():
    """checker_quad(alpha_leaf=True): rays straight down through the leaf
    quad; with the filter, the ones through transparent texels miss, as in
    the reference's filtered trace."""
    js = jproc.checker_quad(alpha_leaf=True)
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    tris, _, _, l = _scene_rays(js, 8)
    rng = np.random.default_rng(5)
    o = np.concatenate([rng.uniform(-1.9, 1.9, (2048, 1)), np.full((2048, 1), 2.0),
                        rng.uniform(-1.9, 1.9, (2048, 1))], 1).astype(np.float32)
    d = np.tile([[0.0, -1.0, 0.0]], (2048, 1)).astype(np.float32)
    light = np.array([0.0, -1.0, 0.0], np.float32)
    jg = jsg.build_shadow_grid(tris, jnp.asarray(light))
    pg = psg.build_shadow_grid(_t(tris), _t(light))
    tables = ptab.build_shade_tables(ps.buffers.to("cpu"))
    got = psg.trace_shadow(pg, _t(o), _t(d), 0.01, 1e4, alpha_tables=tables)
    ref = jsg.trace_shadow(jg, jnp.asarray(o), jnp.asarray(d), 0.01, 1e4,
                           hit_filter=jtrav.make_alpha_hit_filter(js.buffers))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    solid = psg.trace_shadow(pg, _t(o), _t(d), 0.01, 1e4)
    assert bool(solid.all()) and 0 < int(got.sum()) < 2048


def test_wrapper_rejects_other_devices(case):
    """Neither CPU nor CUDA: the wrapper raises (no silent fallback)."""
    o = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        psg.trace_shadow(case["pg"], o, o, 0.01, 1e4)


def test_shared_header_is_part_of_the_build_key(tmp_path, monkeypatch):
    """K2 and K3 include csrc/alpha_filter.cuh: an edit of the header gives
    each library a new build (utils/build.cuda_library_path hashes csrc's
    headers with the source).  The compiler is a fake that copies its
    sources to -o, as in test_torch_build.py."""
    import shutil
    import sys

    from vulkanhybridrenderer_tpu_torch.utils import build

    cc = tmp_path / "fake_cc.py"
    cc.write_text("import sys\na = sys.argv[1:]\nopen(a[a.index('-o') + 1], 'wb').write("
                  "b''.join(open(s, 'rb').read() for s in a[a.index('-o') + 2:]))\n")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("shadow_grid.cu", "alpha_filter.cuh"):
        shutil.copy(build.CSRC_DIR / name, csrc / name)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "NVCC_FLAGS", [str(cc)])
    monkeypatch.setattr(build, "nvcc_path", lambda: sys.executable)
    first = build.cuda_library_path("shadow_grid.cu")
    assert build.cuda_library_path("shadow_grid.cu") == first
    with open(csrc / "alpha_filter.cuh", "a") as f:
        f.write("// edited\n")
    assert build.cuda_library_path("shadow_grid.cu") != first


# ---- K3's order (the big tier first) on a hybrid frame's shadow rays ----------
# The rays of the port's RT-shadows frame at 96x64 (the grid configuration,
# frame 0) on cornell_box() and the small SponzaProxy of the port's hybrid
# tests; the JAX grid is built from the frame's world triangles.  Masks are
# compared exactly: both orders test the same rows.
FRAME_SCENES = {
    "cornell": jproc.cornell_box,
    "sponza": lambda: jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8),
}


@pytest.fixture(scope="module", params=sorted(FRAME_SCENES))
def frame_case(request):
    from vulkanhybridrenderer_tpu_torch.core.config import RenderConfig
    from vulkanhybridrenderer_tpu_torch.models import hybrid as phybrid
    from vulkanhybridrenderer_tpu_torch.ops import raygen
    from vulkanhybridrenderer_tpu_torch.runtime.renderer import Renderer

    js = FRAME_SCENES[request.param]()
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    cfg = RenderConfig(width=96, height=64, alpha_raster="off", shadow_map_size=128,
                       shadow_accel="grid")
    r = Renderer(ps, cfg, device="cpu")
    r.render_frame()
    res = r.fetch_resources("pfd", "ShadowGrid", "WorldTris", "shade_tables", phybrid.DEPTH,
                            phybrid.NORMALS)
    rays = raygen.Wavefronts(res["pfd"], res[phybrid.DEPTH], res[phybrid.NORMALS], cfg.hybrid,
                             ao_rays=cfg.ao_rays)
    light = np.asarray(js.light.direction[:3], np.float32)
    with jax.disable_jit():
        jg = jsg.build_shadow_grid(jnp.asarray(res["WorldTris"].numpy()), jnp.asarray(light))
    sg = res["ShadowGrid"]
    np.testing.assert_array_equal(sg.offsets.numpy(), np.asarray(jg.offsets))
    return dict(js=js, sg=sg, jg=jg, o=rays.origin, d=rays.shadow_dir, tmax=rays.shadow_tmax,
                tables=res["shade_tables"], tmin=raygen.SHADOW_TMIN)


@pytest.mark.parametrize("max_steps", [psg.MAX_STEPS, 2])
def test_big_first_matches_reference(frame_case, max_steps):
    """trace_shadow_plain in K3's order (big tier first) equals the JAX
    trace_shadow and the reference-order plain version, also with cells cut
    by a small max_steps.  Visit counts: a ray that misses tests
    min(count, max_steps) + num_big rows in either order, a ray that hits no
    more than that; the dead rays nothing.  The stages at which the tests
    end add up to the tests, and every hit is a full test."""
    c = frame_case
    sg, o, d, tmax = c["sg"], c["o"], c["d"], c["tmax"]
    n = o.shape[0]
    tmin = torch.full((n,), c["tmin"])
    ref, ref_n = psg.trace_shadow_plain(sg, o, d, tmin, tmax, max_steps, visits=True)
    big, big_n = psg.trace_shadow_plain(sg, o, d, tmin, tmax, max_steps, visits=True,
                                        big_first=True)
    jref = jsg.trace_shadow(c["jg"], jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), c["tmin"],
                            jnp.asarray(tmax.numpy()), max_steps=max_steps)
    np.testing.assert_array_equal(big.numpy(), np.asarray(jref))
    assert torch.equal(big, ref)
    live = tmax >= tmin
    assert 0 < int(live.sum()) < n and int(big.sum()) > 0
    cell = psg.origin_cells(sg, o)
    full = torch.clamp(sg.offsets[cell + 1] - sg.offsets[cell], max=max_steps).long() + sg.num_big
    for counts, big_first in ((ref_n, False), (big_n, True)):
        hit, tested, ended = psg.trace_shadow_plain(sg, o, d, tmin, tmax, max_steps,
                                                    visits=True, big_first=big_first,
                                                    stages=True)
        assert torch.equal(hit, big) and torch.equal(tested, counts)
        assert int(ended.sum()) == int(counts.sum()) and int(ended[3]) >= int(big.sum())
        assert torch.equal(counts[live & ~big], full[live & ~big])
        assert bool((counts[live & big] <= full[live & big]).all())
        assert bool((counts[live & big] >= 1).all()) and not counts[~live].any()
    if max_steps == 2:
        assert bool((full[live] <= 2 + sg.num_big).all())


@pytest.mark.parametrize("filtered", [False, True], ids=["unfiltered", "filtered"])
@pytest.mark.parametrize("form", ["scalar", "tensor"])
def test_orders_filter_and_tmin_forms(frame_case, filtered, form):
    """The plain version in K3's order and the CPU wrapper (which runs it),
    with and without the alpha filter, with Python-float or (R,) tmin /
    tmax: the mask of the reference-order plain version with the same filter
    and, for the filtered frame rays, the JAX trace with its alpha filter."""
    c = frame_case
    sg, o, d = c["sg"], c["o"], c["d"]
    n = o.shape[0]
    if form == "scalar":
        tmin, tmax = c["tmin"], 1e4
        tmin_a, tmax_a = torch.full((n,), c["tmin"]), torch.full((n,), 1e4)
    else:
        tmin = tmin_a = torch.full((n,), c["tmin"])
        tmax = tmax_a = c["tmax"]
    tables = c["tables"] if filtered else None
    filt = ptrav.make_alpha_hit_filter(None, tables) if filtered else None
    want = psg.trace_shadow_plain(sg, o, d, tmin_a, tmax_a, hit_filter=filt)
    assert torch.equal(psg.trace_shadow_plain(sg, o, d, tmin_a, tmax_a, hit_filter=filt,
                                              big_first=True), want)
    assert torch.equal(psg.trace_shadow(sg, o, d, tmin, tmax, alpha_tables=tables, width=96),
                       want)
    if filtered:
        jref = jsg.trace_shadow(c["jg"], jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                                c["tmin"], jnp.asarray(tmax_a.numpy()),
                                hit_filter=jtrav.make_alpha_hit_filter(c["js"].buffers))
        np.testing.assert_array_equal(want.numpy(), np.asarray(jref))
    assert int(want.sum()) > 0


# ---- the test at which K3's early-returning Moller-Trumbore ends ------------
# One triangle spanning the whole grid window (so the big tier's one row,
# which every ray tests) in the plane y = 0, v0 at the origin, e1 along x,
# e2 along z; the light shines down, so the rays go up from y = -1 and a
# ray's (u, v) is its origin's (x, z).  Stages: 0 det, 1 u, 2 v, 3 full.
STAGE_RAYS = {
    "det": ((0.2, -1.0, 0.2), (1.0, 0.0, 0.0), 1e4, 0, False),
    "u above 1": ((2.0, -1.0, 0.1), (0.0, 1.0, 0.0), 1e4, 1, False),
    "u below 0": ((-1.0, -1.0, 0.1), (0.0, 1.0, 0.0), 1e4, 1, False),
    "v": ((0.5, -1.0, 0.7), (0.0, 1.0, 0.0), 1e4, 2, False),
    "full, a hit": ((0.2, -1.0, 0.2), (0.0, 1.0, 0.0), 1e4, 3, True),
    "full, t past tmax": ((0.2, -1.0, 0.2), (0.0, 1.0, 0.0), 0.5, 3, False),
}


@pytest.mark.parametrize("name", list(STAGE_RAYS))
def test_rejection_stage(name):
    """trace_shadow_plain(stages=True) counts each test at the stage where
    K3's early return ends it, in either order; the mask equals the JAX
    trace's and the CPU wrapper's."""
    o, d, tmax, stage, want = STAGE_RAYS[name]
    tri = np.array([[[0, 0, 0], [1, 0, 0], [0, 0, 1]]], np.float32)
    light = np.array([0, -1, 0], np.float32)
    with jax.disable_jit():
        jg = jsg.build_shadow_grid(jnp.asarray(tri), jnp.asarray(light))
    pg = psg.build_shadow_grid(_t(tri), _t(light))
    assert int(pg.num_big) == 1 and int(pg.offsets[-1]) == 0
    o, d = torch.tensor([o]), torch.tensor([d])
    tmin_a, tmax_a = torch.tensor([0.01]), torch.tensor([tmax])
    for big_first in (False, True):
        hit, tested, ended = psg.trace_shadow_plain(pg, o, d, tmin_a, tmax_a, visits=True,
                                                    big_first=big_first, stages=True)
        assert hit.tolist() == [want] and tested.tolist() == [1]
        assert ended.tolist() == [int(k == stage) for k in range(4)]
    assert psg.trace_shadow(pg, o, d, 0.01, tmax).tolist() == [want]
    jref = jsg.trace_shadow(jg, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), 0.01, tmax)
    assert np.asarray(jref).tolist() == [want]


def test_negative_stage_rows_raises(case):
    """K3's staging capacity cannot be negative, on any device."""
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="stage_rows"):
        psg.trace_shadow(case["pg"], o, o, 0.01, 1e4, stage_rows=-1)
