"""``trace_plain``'s per-ray visit counts (the work that prices a K2 launch)
against the JAX package's per-ray walk stepped one step at a time.

The reference ``_trace8`` runs with ``max_steps=1`` from the state the last
step returned; before each step every live ray's row is counted as internal
or leaf by ``rows[node, 127]``, with its non-empty slots (boxes with lo.x <=
hi.x, triangles with tri >= 0), and its filter evaluations are the candidates
the walk hands its hit filter.  Everything JAX runs here runs eagerly
(``jax.disable_jit``), op by op.  Scenes: cornell and the small SponzaProxy of
test_torch_traverse.py (any-hit and closest-hit, one run cut at 6 steps),
and ``checker_quad(alpha_leaf=True)`` with the alpha filter.  Counts must be
equal as integers, and the hits as well.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanhybridrenderer_tpu.ops import shadetab as jshadetab
from vulkanhybridrenderer_tpu.ops import traverse as jtrav
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch.ops import bvh as pbvh
from vulkanhybridrenderer_tpu_torch.ops import bvh8 as pbvh8
from vulkanhybridrenderer_tpu_torch.ops import geometry as pgeo
from vulkanhybridrenderer_tpu_torch.ops import shadetab as pshadetab
from vulkanhybridrenderer_tpu_torch.ops import traverse as ptrav
from vulkanhybridrenderer_tpu_torch.scene import procedural as pproc

torch.set_num_threads(2)
N_RAYS = 1024
TMIN = 0.01


def _scene(proc, name):
    if name == "cornell":
        return proc.cornell_box()
    if name == "sponza":
        return proc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8)
    return proc.checker_quad(alpha_leaf=True)


def _rays(name, tris, rng):
    if name == "checker":
        # the quad spans [-2, 2] x [-2, 2] at y = 0: rays from above
        o = np.stack([rng.uniform(-2.5, 2.5, N_RAYS), rng.uniform(0.5, 3.0, N_RAYS),
                      rng.uniform(-2.5, 2.5, N_RAYS)], -1)
        d = np.stack([rng.normal(0, 0.2, N_RAYS), -np.ones(N_RAYS),
                      rng.normal(0, 0.2, N_RAYS)], -1)
        tmax = rng.choice(np.float32([-1.0, 1000.0]), N_RAYS, p=[0.1, 0.9])
    else:
        lo, hi = tris.reshape(-1, 3).min(0), tris.reshape(-1, 3).max(0)
        o = rng.uniform(lo, hi, (N_RAYS, 3))
        d = rng.normal(size=(N_RAYS, 3))
        d[:32, :2] = 0.0  # axis-aligned rays: |d| < 1e-12 components
        tmax = rng.choice(np.float32([-1.0, 0.5, 3.0, 10000.0]), N_RAYS)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32), tmax.astype(np.float32)


@functools.cache
def _setup(name):
    """The port's scene, triangles and BVH8 table (test_torch_traverse.py
    holds the table equal to the reference's), the rays, and for the
    checker both packages' alpha filters."""
    buffers = _scene(pproc, name).buffers.to("cpu")
    world = pgeo.to_world(buffers)
    tris = pbvh.world_triangles(world.position, buffers.tri_vertex).numpy()
    pb = pbvh8.build_bvh8_sah_host(tris)
    o, d, tmax = _rays(name, tris, np.random.default_rng(23))
    out = dict(name=name, pb=pb, o=o, d=d, tmax=tmax)
    if name == "checker":
        js = _scene(jproc, name)
        out["jfilter"] = jtrav.make_alpha_hit_filter(
            js.buffers, jshadetab.build_shade_tables(js.buffers))
        out["pfilter"] = ptrav.make_alpha_hit_filter(None, pshadetab.build_shade_tables(buffers))
    return out


def _jax_visits(s, anyhit, max_steps, filtered):
    """The reference walk one step a call, eagerly (XLA's compiled CPU code
    contracts multiply-adds into FMAs, the port never does; eager, the walk
    rounds every product as the port does).  Returns (t, tri, counts (R, 5)):
    internal rows, leaf rows, boxes, triangles, filter evaluations."""
    pb, r = s["pb"], N_RAYS
    rows = pb.rows.numpy()
    counts = np.zeros((r, 5), np.int64)
    hit_filter = None
    if filtered:
        def hit_filter(tri, u, v, candidate):
            counts[:, 4] += np.asarray(candidate).reshape(r, 8).sum(axis=1)
            return s["jfilter"](tri, u, v, candidate)

    o, d, tmax = (jnp.asarray(s[k]) for k in ("o", "d", "tmax"))
    tmin = jnp.full((r,), TMIN, jnp.float32)
    # the port misses rays with tmax < tmin before the walk; the reference
    # walks them for one step whose every box test fails: start them dead
    node = np.where(s["tmax"] < TMIN, -1, 0).astype(np.int32)  # row 0: the root
    state = (jnp.asarray(node), jnp.zeros((r,), jnp.int32),
             jnp.zeros((pb.depth, r), jnp.int32), jnp.zeros((pb.depth, r), jnp.int32),
             tmax, jnp.full((r,), -1, jnp.int32), jnp.zeros((r,), jnp.float32),
             jnp.zeros((r,), jnp.float32))
    for _ in range(max_steps):
        node = np.asarray(state[0])
        live = node >= 0
        if not live.any():
            break
        row = rows[np.maximum(node, 0)]
        leaf = row[:, 127] > 0.5
        counts[:, 0] += live & ~leaf
        counts[:, 1] += live & leaf
        counts[:, 2] += np.where(live & ~leaf, (row[:, 0:8] <= row[:, 24:32]).sum(1), 0)
        counts[:, 3] += np.where(live & leaf, (row[:, 72:80] >= 0).sum(1), 0)
        state = jtrav._trace8(jnp.asarray(rows), 0, pb.depth, o, d, tmin, tmax, anyhit,
                              hit_filter, 1, init_state=state, return_state=True, leaf_max=8)
    return np.asarray(state[4]), np.asarray(state[5]), counts


@pytest.mark.parametrize("name,anyhit,max_steps", [
    ("cornell", True, None), ("cornell", False, None),
    ("sponza", True, None), ("sponza", False, None), ("sponza", False, 6),
    ("checker", True, None), ("checker", False, None),
], ids=["cornell-any-hit", "cornell-closest-hit", "sponza-any-hit", "sponza-closest-hit",
        "sponza-closest-hit-6-steps", "checker-filtered-any-hit",
        "checker-filtered-closest-hit"])
@jax.disable_jit()
def test_visits_match_reference_walk(name, anyhit, max_steps):
    s = _setup(name)
    filtered = name == "checker"  # the alpha filter runs on the masked quad
    pb = s["pb"]
    steps = max_steps or ptrav.default_max_steps(pb)
    o, d, tmax = (torch.from_numpy(s[k]) for k in ("o", "d", "tmax"))
    rec, vis = ptrav.trace_plain(pb.rows, pb.depth, o, d, torch.full_like(tmax, TMIN), tmax,
                                 anyhit, steps, s["pfilter"] if filtered else None,
                                 visits=True)
    jt, jtri, counts = _jax_visits(s, anyhit, steps, filtered)

    np.testing.assert_array_equal(rec.tri.numpy() >= 0, jtri >= 0)
    if not anyhit:
        np.testing.assert_array_equal(rec.tri.numpy(), jtri)
    for k, name in enumerate(("internal", "leaf", "boxes", "triangles", "filtered")):
        got = getattr(vis, name).numpy()
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, counts[:, k], err_msg=name)
    dead = s["tmax"] < TMIN
    assert dead.any() and (vis.internal.numpy()[dead] == 0).all()
    assert ((vis.internal + vis.leaf).numpy()[~dead] >= 1).all() and vis.leaf.sum() > 0
    # the slots priced: none above 8 a row, and some rows with empty slots
    assert (vis.boxes <= 8 * vis.internal).all() and (vis.triangles <= 8 * vis.leaf).all()
    assert 0 < vis.boxes.sum() + vis.triangles.sum() < 8 * (vis.internal + vis.leaf).sum()
    if filtered:
        assert vis.filtered.sum() > 0
    else:
        assert vis.filtered.sum() == 0 and vis.internal.sum() > 0
    if max_steps is not None:
        assert (vis.internal + vis.leaf).max() == max_steps
