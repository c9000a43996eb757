"""The port's 12-triangle-leaf BVH8 tables (ops/bvh8.py, leaf_max=12) and
their walk against the JAX package's.

Trees: the host SAH tree (native/sah.cpp) and the port's device LBVH
(leaf_size 1 and 4) of cornell_box() and the small SponzaProxy
(tests/test_hybrid_path.py's size).  The leaf-12 rows, depth bound and
refit metadata of the port's native collapse and of its Python collapse
equal the reference's Python collapse (build_bvh8_host(...,
prefer_native=False, leaf_max=12)) exactly; validate_host passes on them in
both packages; bridge.bvh8_from_numpy carries the reference's table over.
trace_plain on the SAH table against the reference's trace on the same
rows and random rays, run under jax.disable_jit() (XLA's CPU backend
contracts multiply-adds into FMAs under jit, the port rounds every
product): t, tri, u and v equal on every ray, any-hit and closest-hit.  refit8 after a
move equals the reference's bit for bit, and build_bvh8_auto with a
budget picks the same table as the reference's at budgets that keep the
leaf-8 rows, take the leaf-12 rows, and fall back to leaf-8.  ~10 s alone.
"""
import jax
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vulkanhybridrenderer_tpu.ops import bvh8 as jbvh8
from vulkanhybridrenderer_tpu.ops import geometry as jgeo
from vulkanhybridrenderer_tpu.ops import traverse as jtrav
from vulkanhybridrenderer_tpu.ops.bvh import world_triangles
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge, native_bridge
from vulkanhybridrenderer_tpu_torch.ops import bvh as pbvh
from vulkanhybridrenderer_tpu_torch.ops import bvh8 as pbvh8
from vulkanhybridrenderer_tpu_torch.ops import traverse as ptrav

torch.set_num_threads(2)
SCENES = ("cornell", "sponza")
TREES = ("sah", "lbvh1", "lbvh4")
META = ("child8", "valid8", "tri8")
N_RAYS = 2048


def _tris(name):
    js = (jproc.cornell_box() if name == "cornell" else
          jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8))
    return np.asarray(world_triangles(jgeo.to_world(js.buffers).position,
                                      js.buffers.tri_vertex))


def _tree(tris, kind):
    if kind == "sah":
        return native_bridge.build_sah_host(tris)
    return pbvh.build(torch.tensor(tris), leaf_size=int(kind[4:]))


def _jax_bvh8(p):
    """The reference's BVH8 over the port's rows and metadata."""
    return jbvh8.BVH8(rows=jnp.asarray(p.rows.numpy()), child8=p.child8.numpy(),
                      valid8=p.valid8.numpy(), tri8=p.tri8.numpy(), depth=p.depth,
                      leaf_max=p.leaf_max)


@pytest.fixture(scope="module")
def built():
    """(scene, tree) -> (triangles, tree, reference, port native, port
    Python), each leaf-12."""
    out = {}
    for name in SCENES:
        tris = _tris(name)
        for kind in TREES:
            tree = _tree(tris, kind)
            out[name, kind] = (
                tris, tree,
                jbvh8.build_bvh8_host(tree, tris, prefer_native=False, leaf_max=12),
                pbvh8.build_bvh8_host(tree, tris, leaf_max=12),
                pbvh8.build_bvh8_host(tree, tris, prefer_native=False, leaf_max=12))
    return out


CASES = [(s, t) for s in SCENES for t in TREES]


@pytest.mark.parametrize("scene, tree", CASES)
def test_leaf12_rows_equal_reference(built, scene, tree):
    assert native_bridge.native_available()
    tris, _, j, native, python = built[scene, tree]
    for p in (native, python):
        assert p.leaf_max == 12 and p.rows.dtype == torch.float32
        np.testing.assert_array_equal(p.rows.numpy(), np.asarray(j.rows))
        for f in META:
            np.testing.assert_array_equal(getattr(p, f).numpy(), np.asarray(getattr(j, f)))
        assert p.depth == j.depth
    pbvh8.validate_host(native, tris)
    jbvh8.validate_host(_jax_bvh8(native), tris)
    b = bridge.bvh8_from_numpy(np.asarray(j.rows), j.depth, j.leaf_max)
    assert b.leaf_max == 12 and torch.equal(b.tri8, native.tri8)


@pytest.mark.parametrize("scene", SCENES)
def test_leaf12_fewer_rows(built, scene):
    """Twelve triangles a leaf: fewer rows than the leaf-8 table."""
    tris, tree, _, native, _ = built[scene, "sah"]
    assert native.num_rows < pbvh8.build_bvh8_host(tree, tris).num_rows


def _rays(tris, rng):
    lo, hi = tris.reshape(-1, 3).min(0), tris.reshape(-1, 3).max(0)
    o = rng.uniform(lo, hi, (N_RAYS, 3))
    d = rng.normal(size=(N_RAYS, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32), np.full(N_RAYS, 1000.0, np.float32)


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("anyhit", [False, True])
def test_trace_equals_reference(built, scene, anyhit):
    tris, _, j, native, _ = built[scene, "sah"]
    o, d, tmax = _rays(tris, np.random.default_rng(11))
    with jax.disable_jit():
        jh = jtrav.trace(j, jnp.asarray(tris), jnp.asarray(o), jnp.asarray(d), 0.01,
                         jnp.asarray(tmax), anyhit=anyhit, packets=0)
    ph = ptrav.trace(native, None, torch.from_numpy(o), torch.from_numpy(d), 0.01,
                     torch.from_numpy(tmax), anyhit=anyhit)
    assert int(ph.hit.sum()) > N_RAYS // 4
    for f in ("t", "tri", "u", "v"):
        np.testing.assert_array_equal(getattr(ph, f).numpy(), np.asarray(getattr(jh, f)),
                                      err_msg=f)


@pytest.mark.parametrize("scene, tree", [("sponza", "sah"), ("sponza", "lbvh1"),
                                         ("cornell", "lbvh4")])
def test_refit_leaf12_equals_reference(built, scene, tree):
    tris, _, j, native, _ = built[scene, tree]
    moved = tris + np.asarray([0.5, -1.0, 2.0], np.float32)
    moved[::3] *= np.float32(1.1)
    jr = jbvh8.refit8(j, jnp.asarray(moved))
    pr = pbvh8.refit8(native, torch.from_numpy(moved))
    np.testing.assert_array_equal(pr.rows.numpy(), np.asarray(jr.rows))
    pbvh8.validate_host(pr, moved)


@pytest.mark.parametrize("scene", SCENES)
def test_build_auto_picks_reference_table(built, scene):
    """build_bvh8_auto at a budget that holds the leaf-8 table, one that
    holds only the leaf-12 one, and one that holds neither."""
    tris, tree, _, _, _ = built[scene, "sah"]
    n8 = pbvh8.build_bvh8_host(tree, tris).num_rows
    n12 = pbvh8.build_bvh8_host(tree, tris, leaf_max=12).num_rows
    for budget, want in ((n8 * 512, 8), (n12 * 512, 12), (n12 * 512 - 1, 8)):
        p = pbvh8.build_bvh8_auto(tree, tris, budget=budget)
        j = jbvh8.build_bvh8_auto(tree, tris, budget=budget)
        assert p.leaf_max == j.leaf_max == want
        np.testing.assert_array_equal(p.rows.numpy(), np.asarray(j.rows))
