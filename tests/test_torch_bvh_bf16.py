"""The port's bf16 BVH8 table (ops/bvh8.table_to_bf16) and its walk
(ops/traverse.decode_rows, trace_plain) against the JAX package's.

Tables: the host SAH BVH8 (f32, 8-triangle leaves) of cornell_box() and of
the small SponzaProxy (tests/test_hybrid_path.py's size), re-encoded by
each package from the same f32 rows.  The rows are equal bit for bit as
uint16 patterns (the ±3e38 empty-slot sentinels, -0.0 and the centroid
lanes included); the bf16 roundings equal ml_dtypes' on every float32 class;
decode_rows equals _decode_row on every output; the refit metadata read
from the bf16 rows equals the f32 table's; bridge.bvh8_from_numpy carries
the reference's table over as its uint16 patterns.

The walk: trace_plain on the bf16 table against the reference's trace on
the same rows, on tests/test_torch_alpha_filter.py's rays of the small
SponzaProxy (half aimed at alpha-masked triangles, half at random),
unfiltered and through the alpha filter, run under jax.disable_jit() (XLA's
CPU backend contracts multiply-adds into FMAs under jit, the port rounds
every product): t, tri, u and v equal on every ray.
refit8 and validate_host refuse a bf16 table as the reference's do.
~10 s alone.
"""
import dataclasses

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vulkanhybridrenderer_tpu.ops import bvh8 as jbvh8
from vulkanhybridrenderer_tpu.ops import geometry as jgeo
from vulkanhybridrenderer_tpu.ops import shadetab as jshadetab
from vulkanhybridrenderer_tpu.ops import traverse as jtrav
from vulkanhybridrenderer_tpu.ops.bvh import world_triangles
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.ops import bvh8 as pbvh8
from vulkanhybridrenderer_tpu_torch.ops import shadetab as pshadetab
from vulkanhybridrenderer_tpu_torch.ops import traverse as ptrav

torch.set_num_threads(2)
SCENES = ("cornell", "sponza")
N_RAYS = 2048


def _jax_scene(name):
    if name == "cornell":
        return jproc.cornell_box()
    return jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8)


def _bits(rows):
    """uint16 patterns of a bfloat16 tensor or array."""
    if isinstance(rows, torch.Tensor):
        return rows.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(rows).view(np.uint16)


@pytest.fixture(scope="module")
def tables():
    """scene -> (JAX scene, triangles, port f32 BVH8, port bf16, reference bf16)."""
    out = {}
    for name in SCENES:
        js = _jax_scene(name)
        tris = np.asarray(world_triangles(jgeo.to_world(js.buffers).position,
                                          js.buffers.tri_vertex))
        p32 = pbvh8.build_bvh8_sah_host(tris)
        j32 = jbvh8.BVH8(rows=jnp.asarray(p32.rows.numpy()), child8=p32.child8.numpy(),
                         valid8=p32.valid8.numpy(), tri8=p32.tri8.numpy(), depth=p32.depth,
                         leaf_max=8)
        out[name] = (js, tris, p32, pbvh8.table_to_bf16(p32), jbvh8.table_to_bf16(j32))
    return out


@pytest.mark.parametrize("scene", SCENES)
def test_table_to_bf16_bit_equal(tables, scene):
    _, _, p32, p16, j16 = tables[scene]
    assert p16.rows.dtype == torch.bfloat16 and p16.rows.shape == p32.rows.shape
    assert np.array_equal(_bits(p16.rows), _bits(j16.rows))
    # the empty slots' sentinels stay inverted, the leaf flag is exact
    leaf = p32.rows[:, 127] > 0.5
    inv = ~leaf[:, None] & (p32.rows[:, 0:8] > p32.rows[:, 24:32])
    rf = p16.rows.float()
    assert bool(inv.any()) and bool((rf[:, 0:8][inv] > rf[:, 24:32][inv]).all())
    assert torch.equal(rf[:, 127], p32.rows[:, 127])
    assert p16.table_bytes * 2 == p32.table_bytes


def test_bf16_roundings_equal_ml_dtypes():
    """_bf16_nearest against numpy's astype to ml_dtypes.bfloat16 and
    _bf16_directed against the reference's, on normals, subnormals, ±0,
    ±inf, NaNs, the sentinels and random bit patterns."""
    rng = np.random.default_rng(0)
    scaled = (rng.standard_normal(20000)
              * 10.0 ** rng.integers(-44, 38, 20000)).astype(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 3e38, -3e38, 1e-45,
                        -1e-45, 1.17e-38, 3.4028235e38, -3.4028235e38, 1.0, 255.0],
                       np.float32)
    x = np.concatenate([scaled, special,
                        rng.integers(0, 2**32, 20000, dtype=np.uint64).astype(np.uint32)
                        .view(np.float32)])
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    assert np.array_equal(pbvh8._bf16_nearest(x), want)
    for up in (False, True):
        assert np.array_equal(pbvh8._bf16_directed(x, up),
                              jbvh8._bf16_directed(x, up).view(np.uint16))


@pytest.mark.parametrize("scene", SCENES)
def test_decode_rows_equals_reference(tables, scene):
    _, _, p32, p16, j16 = tables[scene]
    for prow, jrow in ((p16.rows, j16.rows), (p32.rows, jnp.asarray(p32.rows.numpy()))):
        got = ptrav.decode_rows(prow, 8)
        want = jtrav._decode_row(jrow, 8)
        assert got[0].dtype == torch.float32
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("scene", SCENES)
def test_metadata_and_bridge(tables, scene):
    """BVH8.from_rows on the bf16 rows gives the f32 table's refit
    metadata; bridge.bvh8_from_numpy takes the reference's bf16 table as
    uint16 patterns to the same rows."""
    _, _, p32, p16, j16 = tables[scene]
    m = pbvh8.BVH8.from_rows(p16.rows, p32.depth, 8)
    for f in ("child8", "valid8", "tri8"):
        assert torch.equal(getattr(m, f), getattr(p32, f)), f
    b = bridge.bvh8_from_numpy(np.asarray(j16.rows).view(np.uint16), j16.depth, j16.leaf_max)
    assert b.rows.dtype == torch.bfloat16 and np.array_equal(_bits(b.rows), _bits(p16.rows))
    assert torch.equal(b.tri8, p32.tri8)
    with pytest.raises(ValueError):
        pbvh8.BVH8.from_rows(p16.rows, p32.depth, 12)


def _rays(tris, alpha_idx, rng):
    """test_torch_alpha_filter.py's SponzaProxy rays: half aimed at masked
    triangles, half from random points in random directions."""
    t = tris[rng.choice(alpha_idx, N_RAYS)]
    b = rng.dirichlet(np.ones(3), N_RAYS)
    target = np.einsum("rk,rkc->rc", b, t)
    o = target + rng.normal(size=(N_RAYS, 3)) * 3.0
    d = target - o
    tmax = np.linalg.norm(d, axis=1) * 1.01
    lo, hi = tris.reshape(-1, 3).min(0), tris.reshape(-1, 3).max(0)
    o[N_RAYS // 2:] = rng.uniform(lo, hi, (N_RAYS // 2, 3))
    d[N_RAYS // 2:] = rng.normal(size=(N_RAYS // 2, 3))
    tmax[N_RAYS // 2:] = 1000.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32), tmax.astype(np.float32)


@pytest.fixture(scope="module")
def walks(tables):
    """(anyhit, filtered) -> (reference HitRecord, port HitRecord) on the
    small SponzaProxy's bf16 table."""
    js, tris, p32, p16, j16 = tables["sponza"]
    o, d, tmax = _rays(tris, np.asarray(js.buffers.alpha_tri_idx), np.random.default_rng(5))
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    jtables = jshadetab.build_shade_tables(js.buffers)
    ptables = pshadetab.build_shade_tables(ps.buffers.to("cpu"))
    out = {}
    for anyhit in (False, True):
        for filtered in (False, True):
            filt = jtrav.make_alpha_hit_filter(js.buffers, jtables) if filtered else None
            with jax.disable_jit():
                j = jtrav.trace(j16, jnp.asarray(tris), jnp.asarray(o), jnp.asarray(d), 0.01,
                                jnp.asarray(tmax), anyhit=anyhit, hit_filter=filt, packets=0)
            p = ptrav.trace(p16, None, torch.from_numpy(o), torch.from_numpy(d), 0.01,
                            torch.from_numpy(tmax), anyhit=anyhit,
                            alpha_tables=ptables if filtered else None)
            out[anyhit, filtered] = (j, p)
    return out


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("anyhit", [False, True])
def test_trace_equals_reference(walks, anyhit, filtered):
    j, p = walks[anyhit, filtered]
    assert int((p.tri >= 0).sum()) > N_RAYS // 4
    for f in ("t", "tri", "u", "v"):
        np.testing.assert_array_equal(getattr(p, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)


def test_filter_rejects_on_bf16(walks):
    """The alpha filter changes some answer on the bf16 table, as on f32."""
    assert not np.array_equal(walks[False, True][1].tri.numpy(),
                              walks[False, False][1].tri.numpy())


@pytest.mark.parametrize("scene", SCENES)
def test_refit_and_validate_refuse_bf16(tables, scene):
    _, tris, _, p16, j16 = tables[scene]
    with pytest.raises(ValueError, match="f32 table"):
        pbvh8.refit8(p16, torch.tensor(tris))
    with pytest.raises(ValueError, match="f32 table"):
        jbvh8.refit8(j16, jnp.asarray(tris))
    # the reference's check reads the pieces as f32 lanes and fails
    with pytest.raises(AssertionError):
        jbvh8.validate_host(j16, tris)
    with pytest.raises(AssertionError):
        pbvh8.validate_host(p16, tris)


@pytest.mark.parametrize("anyhit", [False, True])
def test_trace_rows_carries_bf16(tables, anyhit):
    """A wavefront traced in 4 row slabs, each on its own copy of a bf16
    table (as each shard of a mesh traces its slab on its replica, packed
    for K2 apart), equals the trace of the whole wavefront."""
    _, tris, _, p16, _ = tables["sponza"]
    rng = np.random.default_rng(3)
    n = 512
    lo, hi = tris.reshape(-1, 3).min(0), tris.reshape(-1, 3).max(0)
    o = torch.from_numpy(rng.uniform(lo, hi, (n, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(n, 3))
                                                       .astype(np.float32)), dim=1)
    tmax = torch.full((n,), 1000.0)
    copies = [dataclasses.replace(p16, rows=p16.rows.clone()) for _ in range(4)]
    slabs = [ptrav.trace(b, None, o[i * n // 4:(i + 1) * n // 4], d[i * n // 4:(i + 1) * n // 4],
                         0.01, tmax[i * n // 4:(i + 1) * n // 4], anyhit=anyhit)
             for i, b in enumerate(copies)]
    got = ptrav.HitRecord(**{f: torch.cat([getattr(h, f) for h in slabs])
                             for f in ("t", "tri", "u", "v")})
    want = ptrav.trace(p16, None, o, d, 0.01, tmax, anyhit=anyhit)
    for f in ("t", "tri", "u", "v"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
