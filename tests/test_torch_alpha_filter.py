"""K2's alpha any-hit filter (on the CPU its plain version, ``trace_plain``
with ``make_alpha_hit_filter``) against the JAX package's per-ray walk with
its ``make_alpha_hit_filter``, on the same BVH8 table, shade tables and rays.

Scenes: ``checker_quad(alpha_leaf=True)`` (one masked quad, rays from above,
a third of them through the leaf texture's transparent corners) and the
small SponzaProxy (rays aimed at its masked leaf discs and at random).
Tolerances: any-hit masks equal on every ray (measured: equal); closest-hit
triangle ids equal on >= 99.9% of rays (measured: 1.0 on both scenes), t
within 1e-5 where they agree; the unfiltered walk must differ on some ray.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vulkanhybridrenderer_tpu import native_bridge as jnative
from vulkanhybridrenderer_tpu.ops import bvh8 as jbvh8
from vulkanhybridrenderer_tpu.ops import geometry as jgeo
from vulkanhybridrenderer_tpu.ops import shadetab as jshadetab
from vulkanhybridrenderer_tpu.ops import traverse as jtrav
from vulkanhybridrenderer_tpu.ops.bvh import world_triangles
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.ops import shadetab as pshadetab
from vulkanhybridrenderer_tpu_torch.ops import traverse as ptrav

torch.set_num_threads(2)
N_RAYS = 2048


def _rays(name, tris, alpha_idx, rng):
    if name == "checker":
        # the quad spans [-2, 2] x [-2, 2] at y = 0: rays from above
        o = np.stack([rng.uniform(-2.5, 2.5, N_RAYS), rng.uniform(0.5, 3.0, N_RAYS),
                      rng.uniform(-2.5, 2.5, N_RAYS)], -1)
        d = np.stack([rng.normal(0, 0.2, N_RAYS), -np.ones(N_RAYS),
                      rng.normal(0, 0.2, N_RAYS)], -1)
        tmax = np.full(N_RAYS, 1000.0)
    else:
        # half the rays at random points of masked triangles, half at random
        t = tris[rng.choice(alpha_idx, N_RAYS)]  # (R, 3, 3)
        b = rng.dirichlet(np.ones(3), N_RAYS)
        target = np.einsum("rk,rkc->rc", b, t)
        o = target + rng.normal(size=(N_RAYS, 3)) * 3.0
        d = target - o
        # the hall is closed: aimed rays end just past their target
        tmax = np.linalg.norm(d, axis=1) * 1.01
        lo, hi = tris.reshape(-1, 3).min(0), tris.reshape(-1, 3).max(0)
        o[N_RAYS // 2:] = rng.uniform(lo, hi, (N_RAYS // 2, 3))
        d[N_RAYS // 2:] = rng.normal(size=(N_RAYS // 2, 3))
        tmax[N_RAYS // 2:] = 1000.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32), tmax.astype(np.float32)


@pytest.fixture(scope="module", params=["checker", "sponza"])
def setup(request):
    js = (jproc.checker_quad(alpha_leaf=True) if request.param == "checker"
          else jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8))
    world = jgeo.to_world(js.buffers)
    tris = np.asarray(world_triangles(world.position, js.buffers.tri_vertex))
    jb = jbvh8.build_bvh8_host(jnative.build_sah_host(tris), tris, leaf_max=8)
    o, d, tmax = _rays(request.param, tris, np.asarray(js.buffers.alpha_tri_idx),
                 np.random.default_rng(5))
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    return dict(
        js=js, tris=tris, jb=jb, o=o, d=d, tmax=tmax,
        jtables=jshadetab.build_shade_tables(js.buffers),
        pbvh=bridge.bvh8_from_numpy(np.asarray(jb.rows), jb.depth, jb.leaf_max),
        ptables=pshadetab.build_shade_tables(ps.buffers.to("cpu")),
    )


def _both(s, anyhit):
    filt = jtrav.make_alpha_hit_filter(s["js"].buffers, s["jtables"])
    j = jtrav.trace(s["jb"], jnp.asarray(s["tris"]), jnp.asarray(s["o"]),
                    jnp.asarray(s["d"]), 0.01, jnp.asarray(s["tmax"]), anyhit=anyhit,
                    hit_filter=filt,
                    packets=0)
    o, d, tmax = (torch.from_numpy(s[k]) for k in ("o", "d", "tmax"))
    p = ptrav.trace(s["pbvh"], None, o, d, 0.01, tmax, anyhit=anyhit, alpha_tables=s["ptables"])
    u = ptrav.trace(s["pbvh"], None, o, d, 0.01, tmax, anyhit=anyhit)
    return j, p, u


def test_anyhit_masks_equal(setup):
    j, p, u = _both(setup, anyhit=True)
    np.testing.assert_array_equal(p.hit.numpy(), np.asarray(j.hit))
    assert (u.hit & ~p.hit).any()  # the filter let rays through masked texels
    assert not (p.hit & ~u.hit).any()  # and never made a hit


def test_closesthit_equal(setup):
    j, p, u = _both(setup, anyhit=False)
    jt = np.asarray(j.tri)
    same = p.tri.numpy() == jt
    assert same.mean() >= 0.999, same.mean()
    assert (jt >= 0).mean() > 0.2
    np.testing.assert_allclose(p.t.numpy()[same], np.asarray(j.t)[same], rtol=1e-5, atol=1e-5)
    assert (u.tri != p.tri).any()


def test_filter_plain_matches_jax(setup):
    """make_alpha_hit_filter alone, on every masked triangle at seeded
    barycentrics: the same accept mask."""
    s = setup
    idx = np.asarray(s["js"].buffers.alpha_tri_idx)
    rng = np.random.default_rng(9)
    tri = rng.choice(idx, 4096).astype(np.int32)
    b = rng.dirichlet(np.ones(3), 4096).astype(np.float32)
    u, v = b[:, 1], b[:, 2]
    jf = jtrav.make_alpha_hit_filter(s["js"].buffers, s["jtables"])
    ja = np.asarray(jf(jnp.asarray(tri), jnp.asarray(u), jnp.asarray(v),
                       jnp.ones(4096, bool)))
    pa = ptrav.make_alpha_hit_filter(None, s["ptables"])(
        torch.from_numpy(tri), torch.from_numpy(u), torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(pa, ja)
    assert 0.05 < pa.mean() < 0.95  # both outcomes exercised
