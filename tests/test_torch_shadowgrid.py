"""The port's light-space shadow grid (ops/shadowgrid.py) against the JAX
package's, and its plain trace (K3's plain version) against the reference's
trace and the port's BVH8 any-hit walk (K2's plain version).

The build equals the reference's under ``jax.disable_jit()`` (jit contracts
the dilation's multiply-add into an FMA): the same resolution, offsets,
entry rows (inlined triangles and ids), big rows, num_big and overflow.  The
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
    n = int(jg.offsets[-1])
    assert pg.num_entries == n > 0
    np.testing.assert_array_equal(pg.entries.numpy(), np.asarray(jg.entries)[:n])
    np.testing.assert_array_equal(pg.big.numpy(), np.asarray(jg.big))
    assert pg.num_big == int(jg.num_big) and pg.overflow == int(jg.overflow) == 0
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
    b8 = pbvh8.build_bvh8_host(np.asarray(case["tris"]))
    bvh_hit = ptrav.trace(b8, o, d, 0.01, 1e4, anyhit=True).hit
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
