"""``ops/bvh8.build_bvh8_host(bvh, tri_verts, prefer_native=True,
leaf_max=8)`` called as the reference's renderer calls it
(``build_bvh8_host(binary, tris, leaf_max=8)``), on both packages, and the
port's SAH helper ``build_bvh8_sah_host``.

Trees: the native SAH tree and the reference's jnp LBVH (leaf_size 1) over
cornell_box and the small SponzaProxy.  Exact: rows, refit metadata and
depth equal the reference's (np.array_equal), whether the reference
collapses natively or in Python.  ~10 s alone.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vulkanhybridrenderer_tpu import native_bridge as jnative
from vulkanhybridrenderer_tpu.ops import bvh as jbvh
from vulkanhybridrenderer_tpu.ops import bvh8 as jbvh8
from vulkanhybridrenderer_tpu.ops import geometry as jgeo
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.ops import bvh8 as pbvh8

torch.set_num_threads(2)
META = ("rows", "child8", "valid8", "tri8")


def _scene(name):
    if name == "cornell":
        return jproc.cornell_box()
    return jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8)


def _assert_equal(p, j):
    for f in META:
        assert np.array_equal(getattr(p, f).numpy(), np.asarray(getattr(j, f))), f
    assert p.depth == j.depth and p.leaf_max == j.leaf_max == 8


@pytest.mark.parametrize("tree", ["sah", "lbvh"])
@pytest.mark.parametrize("scene", ["cornell", "sponza"])
def test_reference_call_on_both_packages(scene, tree):
    js = _scene(scene)
    tris = np.array(jbvh.world_triangles(jgeo.to_world(js.buffers).position,
                                         js.buffers.tri_vertex))
    if tree == "sah":
        jtree = jnative.build_sah_host(tris)
    else:
        jtree = jbvh.build(jnp.asarray(tris), leaf_size=1)
    ptree = bridge.bvh_from_numpy({f.name: getattr(jtree, f.name)
                                   for f in dataclasses.fields(jtree)}, jtree.leaf_size)
    for prefer_native in (True, False):
        j = jbvh8.build_bvh8_host(jtree, jnp.asarray(tris), prefer_native, leaf_max=8)
        _assert_equal(pbvh8.build_bvh8_host(ptree, tris, prefer_native, leaf_max=8), j)
    _assert_equal(pbvh8.build_bvh8_host(ptree, tris, leaf_max=8), j)
    if tree == "sah":
        _assert_equal(pbvh8.build_bvh8_sah_host(tris), j)
        _assert_equal(pbvh8.build_bvh8_sah_host(tris, leaf_max=8), j)


def test_leaf_max_other_than_8_raises():
    """A leaf width the row layout has no room for raises, as the
    reference's assert does; 12, the reference's other width, builds its
    rows (tests/test_torch_bvh_leaf12.py holds them against the reference)."""
    tris = np.array(jbvh.world_triangles(jgeo.to_world(jproc.cornell_box().buffers).position,
                                         jproc.cornell_box().buffers.tri_vertex))
    for leaf_max in (4, 16):
        with pytest.raises(ValueError, match="8 or 12"):
            pbvh8.build_bvh8_sah_host(tris, leaf_max=leaf_max)
        with pytest.raises(AssertionError):
            jbvh8.build_bvh8_host(jnative.build_sah_host(tris), jnp.asarray(tris),
                                  leaf_max=leaf_max)
    j = jbvh8.build_bvh8_host(jnative.build_sah_host(tris), jnp.asarray(tris), leaf_max=12)
    p = pbvh8.build_bvh8_sah_host(tris, leaf_max=12)
    for f in META:
        assert np.array_equal(getattr(p, f).numpy(), np.asarray(getattr(j, f))), f
    assert p.depth == j.depth and p.leaf_max == j.leaf_max == 12
