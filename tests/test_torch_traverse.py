"""The port's BVH8 build and traversal (K2; on the CPU its plain PyTorch
version) against the JAX package's per-ray walk on the same table and rays."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vulkanhybridrenderer_tpu import native_bridge as jnative
from vulkanhybridrenderer_tpu.ops import bvh8 as jbvh8
from vulkanhybridrenderer_tpu.ops import geometry as jgeo
from vulkanhybridrenderer_tpu.ops import traverse as jtrav
from vulkanhybridrenderer_tpu.ops.bvh import world_triangles
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.ops import bvh8 as pbvh8
from vulkanhybridrenderer_tpu_torch.ops import traverse as ptrav

torch.set_num_threads(2)
N_RAYS = 4096


def _tris(name):
    sc = (jproc.cornell_box() if name == "cornell"
          else jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8))
    world = jgeo.to_world(sc.buffers)
    return np.asarray(world_triangles(world.position, sc.buffers.tri_vertex))


@pytest.fixture(scope="module")
def sponza():
    tris = _tris("sponza")
    jb = jbvh8.build_bvh8_host(jnative.build_sah_host(tris), tris, leaf_max=8)
    rng = np.random.default_rng(11)
    lo, hi = tris.reshape(-1, 3).min(0), tris.reshape(-1, 3).max(0)
    o = rng.uniform(lo, hi, (N_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d[:64, :2] = 0.0  # axis-aligned rays: |d| < 1e-12 components
    d[64:128, 1] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.choice(np.float32([-1.0, 0.5, 3.0, 10000.0]), N_RAYS).astype(np.float32)
    return dict(tris=tris, jb=jb, o=o, d=d, tmax=tmax)


@pytest.mark.parametrize("name", ["cornell", "sponza"])
def test_bvh8_rows_identical(name):
    tris = _tris(name)
    jb = jbvh8.build_bvh8_host(jnative.build_sah_host(tris), tris, leaf_max=8)
    pb = pbvh8.build_bvh8_sah_host(tris)
    np.testing.assert_array_equal(pb.rows.numpy(), np.asarray(jb.rows))
    assert pb.depth == jb.depth and pb.leaf_max == jb.leaf_max == 8
    assert pb.rows.dtype == torch.float32


def _both(s, anyhit, max_steps=None):
    j = jtrav.trace(s["jb"], jnp.asarray(s["tris"]), jnp.asarray(s["o"]), jnp.asarray(s["d"]),
                    0.01, jnp.asarray(s["tmax"]), anyhit=anyhit, packets=0,
                    max_steps=max_steps)
    pb = bridge.bvh8_from_numpy(np.asarray(s["jb"].rows), s["jb"].depth, s["jb"].leaf_max)
    p = ptrav.trace(pb, None, torch.from_numpy(s["o"]), torch.from_numpy(s["d"]), 0.01,
                    torch.from_numpy(s["tmax"]), anyhit=anyhit, max_steps=max_steps)
    return j, p


def test_anyhit_masks_identical(sponza):
    j, p = _both(sponza, anyhit=True)
    jh = np.asarray(j.hit)
    np.testing.assert_array_equal(p.hit.numpy(), jh)
    dead = sponza["tmax"] < 0.01
    assert dead.any() and not p.hit.numpy()[dead].any()
    assert 0.05 < jh.mean() < 0.95  # both outcomes exercised
    # misses return t = tmax
    np.testing.assert_array_equal(p.t.numpy()[~jh], sponza["tmax"][~jh])


def test_closesthit_identical(sponza):
    j, p = _both(sponza, anyhit=False)
    jt = np.asarray(j.tri)
    np.testing.assert_array_equal(p.tri.numpy(), jt)
    hit = jt >= 0
    assert hit.mean() > 0.3
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(p, f).numpy(), np.asarray(getattr(j, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    assert (p.u.numpy()[~hit] == 0).all() and (p.v.numpy()[~hit] == 0).all()


def test_step_cap_identical(sponza):
    """Rays cut at max_steps keep whatever they had found, like the reference."""
    j, p = _both(sponza, anyhit=False, max_steps=6)
    np.testing.assert_array_equal(p.tri.numpy(), np.asarray(j.tri))
    np.testing.assert_allclose(p.t.numpy(), np.asarray(j.t), rtol=1e-5, atol=1e-5)
    assert ptrav.default_max_steps(pbvh8.BVH8(rows=torch.zeros(10, 128))) == 44
