"""The port's LBVH (ops/bvh.py), its bridges and the collapse of a binary
tree against the JAX package's.

Inputs from numpy seeds at the JAX tests' sizes: random soups of 1, 37, 300
and 2,000 triangles, 16 copies of one triangle (equal morton codes: the
index tie-break), cornell_box() and the small SponzaProxy.
Tolerances: every field of ``build`` (leaf_size 1 and 4), ``refit`` and
``with_octant_links`` (on the native SAH tree), ``_clz32``, ``_expand_bits``
and ``morton_codes`` equal the reference's exactly when the reference runs
op by op (``jax.disable_jit()``); the larger trees are compared against the
jitted reference, which measured equal on every field here too (the
octant split's products by 0.5 are exact, so a multiply-add XLA contracts
there rounds the same).  The native host LBVH equals the device one (order,
left, right, escape; boxes within 1e-6, as tests/test_native.py:17-28;
measured 0); the BVH8 rows collapsed from the port's tree equal the
reference's ``build_bvh8_host`` rows.  ~36-44 s alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanhybridrenderer_tpu import native_bridge as jnative
from vulkanhybridrenderer_tpu.ops import bvh as jbvh
from vulkanhybridrenderer_tpu.ops import bvh8 as jbvh8
from vulkanhybridrenderer_tpu.ops import geometry as jgeo
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch import native_bridge as pnative
from vulkanhybridrenderer_tpu_torch.ops import bvh as pbvh
from vulkanhybridrenderer_tpu_torch.ops import bvh8 as pbvh8

torch.set_num_threads(2)
FIELDS = ("aabb_min", "aabb_max", "left", "right", "escape", "leaf_tri", "order", "next8",
          "esc8")


def _soup(n, seed=0, spread=10.0):
    """tests/test_bvh_traverse.py's soup."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (n, 1, 3))
    return (base + rng.uniform(-0.5, 0.5, (n, 3, 3))).astype(np.float32)


def _scene_tris(scene):
    world = jgeo.to_world(scene.buffers)
    return np.array(jbvh.world_triangles(world.position, scene.buffers.tri_vertex))


def _tris(name):
    if name == "one":
        return _soup(1, seed=1)
    if name == "dup16":
        return np.tile(_soup(1, seed=2), (16, 1, 1))
    if name == "cornell":
        return _scene_tris(jproc.cornell_box())
    if name == "sponza":
        return _scene_tris(jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12,
                                              grid_res=8))
    n = int(name[4:])
    return _soup(n, seed=n)


def _assert_equal(j, p, fields=FIELDS):
    for f in fields:
        a, b = getattr(j, f), getattr(p, f)
        if a is None:
            assert b is None, f
            continue
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(b.numpy(), a, err_msg=f)
    assert j.leaf_size == p.leaf_size and j.num_leaves == p.num_leaves and j.root == p.root


def test_clz32_expand_bits_morton():
    """Bit helpers on every 10-bit code and on edge values; morton codes of
    points near the box's corners and at 1023 / 1024 of it."""
    x = np.array([0, 1, 2, 3, 1022, 1023, 1024, 511, 2**29, 2**30 - 1, 2**31 - 1, 12345678],
                 np.int32)
    np.testing.assert_array_equal(pbvh._clz32(torch.from_numpy(x)).numpy(),
                                  np.asarray(jbvh._clz32(jnp.asarray(x))))
    q = np.arange(1024, dtype=np.uint32)
    np.testing.assert_array_equal(pbvh._expand_bits(torch.from_numpy(q.astype(np.int64))).numpy(),
                                  np.asarray(jbvh._expand_bits(jnp.asarray(q))).astype(np.int64))
    rng = np.random.default_rng(3)
    lo, hi = np.float32([-3, 0, 2]), np.float32([7, 0.25, 2 + 1e-7])  # a near-flat axis
    edge = lo + (hi - lo) * np.float32([[1023 / 1024], [1.0], [0.0], [1 - 1e-7]])
    pts = np.concatenate([rng.uniform(lo - 1, hi + 1, (500, 3)), edge]).astype(np.float32)
    with jax.disable_jit():
        ref = np.asarray(jbvh.morton_codes(jnp.asarray(pts), jnp.asarray(lo), jnp.asarray(hi)))
    got = pbvh.morton_codes(torch.from_numpy(pts), torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("name, leaf_size, no_jit", [
    ("one", 1, True), ("dup16", 1, True), ("soup37", 1, True), ("soup300", 4, True),
    ("soup300", 1, False), ("soup2000", 1, False), ("cornell", 1, False),
    ("sponza", 4, False)])
def test_build_equals_reference(name, leaf_size, no_jit):
    tris = _tris(name)
    if no_jit:
        with jax.disable_jit():
            j = jbvh.build(jnp.asarray(tris), leaf_size=leaf_size)
    else:
        j = jbvh.build(jnp.asarray(tris), leaf_size=leaf_size)
    p = pbvh.build(torch.from_numpy(tris), leaf_size=leaf_size)
    _assert_equal(j, p)
    pbvh.validate_host(p)
    assert pbvh.tree_depth(p) <= 64


def test_refit_equals_reference():
    """Refit for moved soup vertices (topology kept), op by op."""
    tris = _soup(300, seed=8)
    moved = tris + np.random.default_rng(9).normal(0, 0.3, tris.shape).astype(np.float32)
    j = jbvh.build(jnp.asarray(tris), leaf_size=4)
    p = bridge.bvh_from_numpy(dataclasses.asdict(j), j.leaf_size)
    with jax.disable_jit():
        jr = jbvh.refit(j, jnp.asarray(moved))
    pr = pbvh.refit(p, torch.from_numpy(moved))
    _assert_equal(jr, pr)
    pbvh.validate_host(pr)


def test_with_octant_links_on_sah_tree():
    """Octant links of the native SAH tree, op by op: the port's native
    build carries no links until asked, then the reference's."""
    tris = _soup(257, seed=11)
    p = pnative.build_sah_host(tris)
    assert p.next8 is None and p.esc8 is None
    with jax.disable_jit():
        j = jbvh.with_octant_links(jnative.build_sah_host(tris))
    _assert_equal(j, pbvh.with_octant_links(p))
    pbvh.validate_host(pbvh.with_octant_links(p))


@pytest.mark.parametrize("name", ["one", "dup16", "soup37", "soup2000", "sponza"])
def test_native_lbvh_equals_device(name):
    tris = _tris(name)
    nat = pnative.build_bvh_host(tris)
    dev = pbvh.build(torch.from_numpy(tris))
    for f in ("order", "left", "right", "escape", "leaf_tri"):
        assert torch.equal(getattr(nat, f), getattr(dev, f)), f
    assert float((nat.aabb_min - dev.aabb_min).abs().max()) <= 1e-6
    assert float((nat.aabb_max - dev.aabb_max).abs().max()) <= 1e-6
    assert nat.next8 is None
    pbvh.validate_host(nat)
    # the reference's native bridge gives the same tree
    _assert_equal(jnative.build_bvh_host(tris), pbvh.with_octant_links(nat))


@pytest.mark.parametrize("name, leaf_size", [("soup37", 1), ("soup300", 4), ("soup2000", 1),
                                             ("cornell", 1), ("sponza", 4)])
def test_collapse_equals_reference(name, leaf_size):
    """The BVH8 of an LBVH (any leaf_size, its own root) equals the
    reference's build_bvh8_host rows and refit metadata."""
    tris = _tris(name)
    j = jbvh8.build_bvh8_host(jbvh.build(jnp.asarray(tris), leaf_size=leaf_size),
                              jnp.asarray(tris))
    p = pbvh8.build_bvh8_host(pbvh.build(torch.from_numpy(tris), leaf_size=leaf_size), tris)
    np.testing.assert_array_equal(p.rows.numpy(), np.asarray(j.rows))
    np.testing.assert_array_equal(p.child8.numpy(), np.asarray(j.child8))
    np.testing.assert_array_equal(p.valid8.numpy(), np.asarray(j.valid8))
    np.testing.assert_array_equal(p.tri8.numpy(), np.asarray(j.tri8))
    assert p.depth == j.depth


def test_tree_depth_and_validate_catch_faults():
    """tree_depth is the longest root-to-leaf chain (a recursive count);
    validate_host rejects a broken escape link and a box that leaves out a
    child."""
    p = pbvh.build(torch.from_numpy(_soup(300, seed=4)))
    left, right = p.left.tolist(), p.right.tolist()

    def depth(i):
        return 0 if left[i] < 0 else 1 + max(depth(left[i]), depth(right[i]))

    assert pbvh.tree_depth(p) == depth(p.root) > 8
    assert pbvh.tree_depth(pbvh.build(torch.from_numpy(_soup(1)))) == 0
    first = p.root
    while left[first] >= 0:
        first = left[first]
    esc = p.escape.clone()
    esc[first] = -1  # the walk ends after its first leaf
    with pytest.raises(AssertionError, match="threading"):
        pbvh.validate_host(dataclasses.replace(p, escape=esc))
    amax = p.aabb_max.clone()
    amax[0, 0] -= 1.0
    with pytest.raises(AssertionError, match="box"):
        pbvh.validate_host(dataclasses.replace(p, aabb_max=amax))


def test_bvh_to_device_and_bridge_round_trip():
    j = jbvh.build(jnp.asarray(_soup(37, seed=37)))
    p = bridge.bvh_from_numpy(dataclasses.asdict(j), j.leaf_size)
    _assert_equal(j, p)
    moved = p.to("cpu")
    assert all(torch.equal(getattr(moved, f), getattr(p, f)) for f in FIELDS)
    bare = dataclasses.replace(p, next8=None, esc8=None).to("meta")
    assert bare.left.device.type == "meta" and bare.next8 is None
