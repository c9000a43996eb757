"""The port's BVH8 refit metadata and refit8 (ops/bvh8.py) against the JAX
package's.

child8 / valid8 / tri8, read back from the rows (BVH8.from_rows), equal the
fields the reference's build_bvh8_host makes for the same tree: the
reference's LBVH trees of random soups (carried over as rows) and the SAH
trees both packages build from the native builder.  refit8's rows equal the
reference's bit for bit on the moved soups of tests/test_bvh8.py:82-121
(empty leaf slots hold triangle 0's coordinates in both); closest hits
through the refit tree equal a fresh build's (tri exact, t within 1e-4, as
tests/test_bvh8.py:82-95), and a refit with too few sweeps misses hits.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vulkanhybridrenderer_tpu import native_bridge as jnative
from vulkanhybridrenderer_tpu.ops import bvh as jbvh
from vulkanhybridrenderer_tpu.ops import bvh8 as jbvh8
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.ops import bvh8 as pbvh8
from vulkanhybridrenderer_tpu_torch.ops import traverse as ptrav

torch.set_num_threads(2)


def _random_soup(n, seed=0, spread=10.0):
    """tests/test_bvh8.py's soup."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (n, 1, 3))
    return (base + rng.uniform(-0.5, 0.5, (n, 3, 3))).astype(np.float32)


def _rand_rays(n, seed, spread=12.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


def _lbvh8(tris):
    """The reference's BVH8 over its LBVH (tests/test_bvh8.py:_bvh8) and the
    port's BVH8 over the same rows."""
    j = jbvh8.build_bvh8_host(jbvh.build(jnp.asarray(tris), leaf_size=1), jnp.asarray(tris))
    return j, bridge.bvh8_from_numpy(np.asarray(j.rows), j.depth, j.leaf_max)


def _assert_meta(j, p):
    np.testing.assert_array_equal(p.rows.numpy(), np.asarray(j.rows))
    np.testing.assert_array_equal(p.child8.numpy(), np.asarray(j.child8))
    np.testing.assert_array_equal(p.valid8.numpy(), np.asarray(j.valid8))
    np.testing.assert_array_equal(p.tri8.numpy(), np.asarray(j.tri8))
    assert p.depth == j.depth


@pytest.mark.parametrize("n", [1, 8, 37, 300])
def test_metadata_from_rows_lbvh(n):
    j, p = _lbvh8(_random_soup(n, seed=n))
    _assert_meta(j, p)


def test_metadata_sah_build():
    """The port's host build (native SAH + collapse, metadata from the rows)
    against the reference's on the same triangles: the same rows, depth
    bound and metadata."""
    tris = _random_soup(900, seed=21, spread=30.0)
    j = jbvh8.build_bvh8_host(jnative.build_sah_host(tris), jnp.asarray(tris))
    _assert_meta(j, pbvh8.build_bvh8_sah_host(tris))


@pytest.mark.parametrize("n, seed, spread, move", [(100, 7, 10.0, (5.0, 0.0, 0.0)),
                                                   (900, 21, 30.0, (0.0, 40.0, 0.0))])
def test_refit_rows_match(n, seed, spread, move):
    tris = _random_soup(n, seed=seed, spread=spread)
    moved = tris + np.asarray(move, np.float32)
    j, p = _lbvh8(tris)
    jr = jbvh8.refit8(j, jnp.asarray(moved))
    pr = pbvh8.refit8(p, torch.from_numpy(moved))
    np.testing.assert_array_equal(pr.rows.numpy(), np.asarray(jr.rows))
    for sweeps in (1, 2):
        np.testing.assert_array_equal(
            pbvh8.refit8(p, torch.from_numpy(moved), sweeps=sweeps).rows.numpy(),
            np.asarray(jbvh8.refit8(j, jnp.asarray(moved), sweeps=sweeps).rows))
    assert torch.equal(pr.child8, p.child8) and torch.equal(pr.tri8, p.tri8)


def test_refit_traces_like_a_fresh_build():
    """The refit tree against a fresh host build over the moved triangles:
    closest hits equal (t within 1e-4), any-hit masks identical; a refit of
    one sweep leaves upper boxes over the old place and misses hits."""
    tris = _random_soup(900, seed=21, spread=30.0)
    moved = torch.from_numpy(tris + np.asarray([0.0, 40.0, 0.0], np.float32))
    b = pbvh8.build_bvh8_sah_host(tris)
    assert b.depth >= 3
    refit = pbvh8.refit8(b, moved)
    assert torch.equal(refit.rows, pbvh8.refit8(b, moved, sweeps=b.depth).rows)
    fresh = pbvh8.build_bvh8_sah_host(moved.numpy())
    # rays from random points toward random triangles' centroids, and
    # tests/test_bvh8.py's random rays
    o, d = _rand_rays(512, seed=13, spread=35.0)
    o = o + torch.tensor([0.0, 40.0, 0.0])
    aim = moved[torch.from_numpy(np.random.default_rng(3).integers(0, 900, 256))].mean(dim=1)
    d[:256] = torch.nn.functional.normalize(aim - o[:256], dim=-1)
    a, f = ptrav.trace(refit, None, o, d, 0.01, 1e4), ptrav.trace(fresh, None, o, d, 0.01, 1e4)
    assert torch.equal(a.tri, f.tri) and int(a.hit.sum()) > 200
    assert float((a.t - f.t).abs().max()) <= 1e-4
    assert torch.equal(ptrav.trace(refit, None, o, d, 0.01, 1e4, anyhit=True).hit,
                       ptrav.trace(fresh, None, o, d, 0.01, 1e4, anyhit=True).hit)
    bad = ptrav.trace(pbvh8.refit8(b, moved, sweeps=1), None, o, d, 0.01, 1e4)
    assert bool((bad.tri != f.tri).any())


def test_refit_needs_metadata():
    with pytest.raises(ValueError, match="metadata"):
        pbvh8.refit8(pbvh8.BVH8(rows=torch.zeros(4, 128)), torch.zeros(1, 3, 3))
