"""The port's Python BVH8 collapse and BVH8 validate_host (ops/bvh8.py)
against the native collapse and the reference's.

Trees: the host SAH tree (native/sah.cpp), the device LBVH with leaf_size 1
and with leaf_size 4, over cornell_box() and the small SponzaProxy
(tests/test_hybrid_path.py's size).  ``collapse_host(prefer_native=False)``
gives rows, depth and refit metadata equal to the native collapse's
(torch.equal) and to the reference's ``build_bvh8_host(...,
prefer_native=False)`` (np.array_equal); ``validate_host`` passes on each
and on a ``refit8`` output, and raises, as the reference's does, on a
dropped leaf triangle, a corrupted offset map and an unreachable extra
row.  ~3 s alone.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanhybridrenderer_tpu.ops import bvh8 as jbvh8
from vulkanhybridrenderer_tpu_torch import native_bridge
from vulkanhybridrenderer_tpu_torch.ops import bvh as pbvh
from vulkanhybridrenderer_tpu_torch.ops import bvh8 as pbvh8
from vulkanhybridrenderer_tpu_torch.ops import geometry
from vulkanhybridrenderer_tpu_torch.scene import procedural

torch.set_num_threads(2)
META = ("rows", "child8", "valid8", "tri8")
SCENES = ("cornell", "sponza")
TREES = ("sah", "lbvh1", "lbvh4")


@pytest.fixture(scope="module")
def scene_tris():
    out = {}
    for name in SCENES:
        sc = (procedural.cornell_box() if name == "cornell" else
              procedural.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8))
        b = sc.buffers.to("cpu")
        out[name] = pbvh.world_triangles(geometry.to_world(b).position, b.tri_vertex)
    return out


def _tree(tris, kind):
    if kind == "sah":
        return native_bridge.build_sah_host(tris.numpy())
    return pbvh.build(tris, leaf_size=int(kind[4:]))


@pytest.fixture(scope="module")
def collapsed(scene_tris):
    """(scene, tree) -> (tree, triangles, native BVH8, Python BVH8)."""
    out = {}
    for name, tris in scene_tris.items():
        for kind in TREES:
            tree = _tree(tris, kind)
            out[name, kind] = (tree, tris, pbvh8.build_bvh8_host(tree, tris.numpy()),
                               pbvh8.build_bvh8_host(tree, tris.numpy(), prefer_native=False))
    return out


def _reference(b):
    """The reference's BVH8 of the same rows and metadata (its validate_host
    reads them through np.asarray)."""
    return jbvh8.BVH8(rows=b.rows.numpy(), child8=b.child8.numpy(), valid8=b.valid8.numpy(),
                      tri8=b.tri8.numpy(), depth=b.depth, leaf_max=b.leaf_max)


CASES = [(s, t) for s in SCENES for t in TREES]


@pytest.mark.parametrize("scene, tree", CASES)
def test_python_collapse_equals_native(collapsed, scene, tree):
    assert native_bridge.native_available()  # else both would be the Python collapse
    _, _, native, python = collapsed[scene, tree]
    for f in META:
        assert torch.equal(getattr(python, f), getattr(native, f)), f
    assert python.depth == native.depth and python.num_rows > 1


@pytest.mark.parametrize("scene, tree", CASES)
def test_python_collapse_equals_reference(collapsed, scene, tree):
    bvh, tris, _, python = collapsed[scene, tree]
    view = types.SimpleNamespace(**{f: getattr(bvh, f).numpy() for f in (
        "left", "right", "leaf_tri", "order", "aabb_min", "aabb_max")},
        leaf_size=bvh.leaf_size, root=bvh.root)
    j = jbvh8.build_bvh8_host(view, jnp.asarray(tris.numpy()), prefer_native=False)
    for f in META:
        assert np.array_equal(getattr(python, f).numpy(), np.asarray(getattr(j, f))), f
    assert python.depth == j.depth


@pytest.mark.parametrize("scene, tree", CASES)
def test_validate_host_passes(collapsed, scene, tree):
    _, tris, native, python = collapsed[scene, tree]
    pbvh8.validate_host(python, tris)
    pbvh8.validate_host(native, tris.numpy())
    jbvh8.validate_host(_reference(python), tris.numpy())


@pytest.mark.parametrize("tree", TREES)
def test_validate_host_passes_after_refit(collapsed, tree):
    """refit8 for moved triangles keeps a table validate_host accepts over
    the moved triangles (and the reference's agrees)."""
    _, tris, _, python = collapsed["sponza", tree]
    rng = np.random.default_rng(3)
    moved = tris + torch.from_numpy(rng.uniform(-0.2, 0.2, tris.shape).astype(np.float32))
    refit = pbvh8.refit8(python, moved)
    assert not torch.equal(refit.rows, python.rows)
    pbvh8.validate_host(refit, moved)
    jbvh8.validate_host(_reference(refit), moved.numpy())


def _drop_triangle(b):
    leaf = int(torch.nonzero(b.tri8[:, 0] >= 0)[0])
    tri8 = b.tri8.clone()
    tri8[leaf, 0] = -1
    return dataclasses.replace(b, tri8=tri8)


def _corrupt_offmap(b):
    slot = int(torch.nonzero(b.valid8[0])[0])
    rows = b.rows.clone()
    rows[0, 49] = float(int(rows[0, 49]) ^ (1 << (3 * slot)))
    return dataclasses.replace(b, rows=rows)


def _extra_row(b):
    def grow(a, fill):
        return torch.cat([a, torch.full((1,) + a.shape[1:], fill, dtype=a.dtype)])

    return dataclasses.replace(b, rows=grow(b.rows, 0.0), child8=grow(b.child8, -1),
                               valid8=grow(b.valid8, False), tri8=grow(b.tri8, -1))


@pytest.mark.parametrize("mutate, message", [
    (_drop_triangle, "exactly one leaf slot"),
    (_corrupt_offmap, "offmap / base disagree"),
    (_extra_row, "unreachable"),
])
def test_validate_host_catches_faults(collapsed, mutate, message):
    _, tris, _, python = collapsed["sponza", "lbvh1"]
    bad = mutate(python)
    with pytest.raises(AssertionError, match=message):
        pbvh8.validate_host(bad, tris)
    with pytest.raises(AssertionError):
        jbvh8.validate_host(_reference(bad), tris.numpy())

