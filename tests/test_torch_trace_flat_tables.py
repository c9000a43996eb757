"""K4's tables, packed once per tree (``traverse.pack_flat``): the leaf
slots at ``order``'s positions, the links that name a leaf by its slots,
packed from the tree's integer links or from pack_nodes' float rows (which
refuse a tree past 2^24 ids), the plain walk over them against
the JAX package's binary-tree walk (``_trace_flat``), and the wrapper's
contract.

Inputs as test_torch_trace_flat.py makes them, from numpy seeds: a
300-triangle soup at leaf_size 1 and 4 and checker_quad(alpha_leaf=True),
rays aimed at random triangles and at random, every sixth with tmax < tmin.
Tolerances: the tables' ids and vertices exact, and equal bit for bit
from either packing; the walk's (t, tri, u, v) and visit counts equal over
the tables and over the tree packed per call; against the
reference run op by op (``jax.disable_jit()``) (t, tri, u, v) equal on
every ray, closest-hit and any-hit, with a step cap that bites and with the
alpha filter.  ~25-30 s alone, most of it the reference's walk op by op.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanhybridrenderer_tpu.ops import bvh as jbvh
from vulkanhybridrenderer_tpu.ops import geometry as jgeo
from vulkanhybridrenderer_tpu.ops import shadetab as jshadetab
from vulkanhybridrenderer_tpu.ops import traverse as jtrav
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge, native_bridge
from vulkanhybridrenderer_tpu_torch.ops import bvh as pbvh
from vulkanhybridrenderer_tpu_torch.ops import shadetab as pshadetab
from vulkanhybridrenderer_tpu_torch.ops import traverse as ptrav

torch.set_num_threads(2)
N_RAYS = 192


def _soup(n, seed):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-10.0, 10.0, (n, 1, 3))
    return (base + rng.uniform(-0.5, 0.5, (n, 3, 3))).astype(np.float32)


def _rays(tris, seed, targets=None):
    """Half the rays aimed at random points of `targets` (default: every
    triangle) from 2-6 units away, half from random points in random
    directions; every sixth ray has tmax < tmin."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(np.arange(tris.shape[0]) if targets is None else targets, N_RAYS)
    target = np.einsum("rk,rkc->rc", rng.dirichlet(np.ones(3), N_RAYS), tris[ids])
    o = target + rng.normal(size=(N_RAYS, 3)) * 2.0
    d = target - o
    lo, hi = tris.reshape(-1, 3).min(0), tris.reshape(-1, 3).max(0)
    o[N_RAYS // 2:] = rng.uniform(lo, hi, (N_RAYS // 2, 3))
    d[N_RAYS // 2:] = rng.normal(size=(N_RAYS // 2, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(N_RAYS, 1000.0, np.float32)
    tmax[::6] = -1.0
    return o.astype(np.float32), d.astype(np.float32), tmax


def _trees(n, leaf_size, seed):
    """(triangles, the reference's LBVH, the port's copy of it)."""
    tris = _soup(n, seed)
    j = jbvh.build(jnp.asarray(tris), leaf_size=leaf_size)
    return tris, j, bridge.bvh_from_numpy(dataclasses.asdict(j), leaf_size)


def _reference(j, tris, o, d, tmax, anyhit, max_steps=None, hit_filter=None):
    with jax.disable_jit():
        r = jtrav.trace(j, jnp.asarray(tris), jnp.asarray(o), jnp.asarray(d), 0.01,
                        jnp.asarray(tmax), anyhit=anyhit, max_steps=max_steps,
                        hit_filter=hit_filter)
    return {f: np.asarray(getattr(r, f)) for f in ("t", "tri", "u", "v")}


def _assert_same(got, ref):
    for f in ("t", "tri", "u", "v"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), ref[f], err_msg=f)


def _links(nodes, new_id):
    """pack_nodes' node ids (-1: the end) -> FlatTables links: an internal
    node's row by `new_id`, a leaf's -(start + 2), -1."""
    nxt = nodes[:, 6].long()

    def link(ids):
        i = ids.clamp(min=0)
        return torch.where(ids < 0, -1, torch.where(nxt[i] <= -2, nxt[i], new_id[i]))

    return link


@pytest.mark.parametrize("leaf_size", [1, 4])
def test_leaf_slots_at_order_positions(leaf_size):
    """Slot k holds triangle order[k] (its int32 id bits exact, its
    vertices equal) and its leaf's escape link; a padded slot holds id -1
    and zero vertices."""
    tris = _soup(301, seed=leaf_size)
    p = pbvh.build(torch.from_numpy(tris), leaf_size=leaf_size)
    tables = ptrav.pack_flat(p, torch.from_numpy(tris))
    slots = tables.leaf_tris.reshape(-1, 3, 4)
    assert tables.leaf_tris.shape == (p.order.shape[0], 12)
    assert tables.leaf_tris.dtype == torch.float32
    assert torch.equal(ptrav.table_ints(tables.leaf_tris, 3), p.order)
    real = p.order >= 0
    assert torch.equal(slots[real][:, :, :3], torch.from_numpy(tris)[p.order[real].long()])
    assert int((~real).sum()) == (-301) % leaf_size
    assert not slots[~real][:, :, :3].any() and not slots[:, 2, 3].any()
    assert torch.equal(slots[:, 0, 3].contiguous().view(torch.int32), p.order)
    # the escape links: leaf i's slots carry link(escape[i]); the LBVH
    # numbers its internal nodes first, so each keeps its id
    nodes = ptrav.pack_nodes(p)
    link = _links(nodes, torch.arange(nodes.shape[0]))
    leaves = torch.nonzero(p.leaf_tri >= 0).squeeze(1)
    want = link(p.escape[leaves].long()).repeat_interleave(leaf_size)
    start = p.leaf_tri[leaves].long().repeat_interleave(leaf_size) + torch.arange(
        leaf_size).repeat(leaves.shape[0])
    assert torch.equal(ptrav.table_ints(tables.leaf_tris, 7)[start].long(), want)


@pytest.mark.parametrize("build", ["lbvh", "lbvh leaf 4", "sah"])
def test_integer_links_equal_the_float_rows(build):
    """pack_flat's tables, from the tree's integer links, equal bit for bit
    those flat_tables packs from pack_nodes' float rows: the internal rows
    in id order, links mapped through it, the root's link."""
    tris = _soup(257, seed=9)
    if build == "sah":
        p = native_bridge.build_sah_host(tris)
    else:
        p = pbvh.build(torch.from_numpy(tris), leaf_size=4 if build.endswith("4") else 1)
    tv = torch.from_numpy(tris)
    got = ptrav.pack_flat(p, tv)
    want = ptrav.flat_tables(ptrav.pack_nodes(p), ptrav.pack_tris(tv), p.order, p.leaf_size,
                             p.root)
    internal = torch.nonzero(p.left >= 0).squeeze(1)
    assert got.nodes.shape == (internal.shape[0], 8) and got.leaf_size == p.leaf_size
    assert torch.equal(got.nodes[:, :6], ptrav.pack_nodes(p)[internal, :6])
    assert got.root == want.root
    for f in ("nodes", "leaf_tris"):
        assert torch.equal(getattr(got, f).view(torch.int32), getattr(want, f).view(torch.int32))


@pytest.mark.parametrize("nodes, slots", [((1 << 24) + 1, 8), (7, (1 << 24) - 1)])
def test_float_rows_refuse_ids_past_2_24(nodes, slots):
    """pack_nodes' rows hold links as floats, exact up to 2^24: flat_tables
    refuses a tree with more nodes, or with leaf links -(start + 2) past it,
    before it reads a row (the rows here are views of one row)."""
    rows = torch.zeros((1, 8)).expand(nodes, 8)
    order = torch.zeros(1, dtype=torch.int32).expand(slots)
    with pytest.raises(ValueError, match="exact as floats up to 2"):
        ptrav.flat_tables(rows, torch.zeros((1, 9)), order, 1, 0)


def test_one_leaf_tree():
    """A tree of one leaf has no internal row: the root's link is the leaf,
    -2, and the walk tests its triangles, as the reference's."""
    tris, j, p = _trees(3, 4, seed=11)
    tables = ptrav.pack_flat(p, torch.from_numpy(tris))
    assert tables.root == -2 and tables.nodes.shape == (0, 8) and tables.num_nodes == 1
    o, d, tmax = _rays(tris, seed=11)
    for anyhit in (False, True):
        ref = _reference(j, tris, o, d, tmax, anyhit)
        _assert_same(ptrav.trace(tables, torch.from_numpy(o), torch.from_numpy(d), 0.01,
                                 torch.from_numpy(tmax), anyhit=anyhit), ref)
        assert int((ref["tri"] >= 0).sum()) > 0


@pytest.mark.parametrize("leaf_size, anyhit", [(1, False), (4, True), (4, False)])
def test_tables_walk_equals_the_per_call_packing(leaf_size, anyhit):
    """Hits and per-ray visit counts (which price K4's bound) equal over
    pack_flat's tables and over the tables packed per call from pack_nodes
    / pack_tris / order."""
    tris = _soup(300, seed=6)
    p = pbvh.build(torch.from_numpy(tris), leaf_size=leaf_size)
    o, d, tmax = (torch.from_numpy(a) for a in _rays(tris, seed=6))
    tmin = torch.full((N_RAYS,), 0.01)
    tv = torch.from_numpy(tris)
    tables = ptrav.pack_flat(p, tv)
    steps = ptrav.default_flat_max_steps(tables)
    assert steps == ptrav.default_flat_max_steps(ptrav.pack_nodes(p))
    rec, vis = ptrav.trace_flat_plain(tables, o, d, tmin, tmax, anyhit, steps, visits=True)
    other, ovis = ptrav.trace_flat_plain(ptrav.pack_nodes(p), ptrav.pack_tris(tv), p.order,
                                         leaf_size, p.root, o, d, tmin, tmax, anyhit, steps,
                                         visits=True)
    assert int(rec.hit.sum()) > N_RAYS // 8
    for f in ("t", "tri", "u", "v"):
        assert torch.equal(getattr(rec, f), getattr(other, f)), f
    for f in ("internal", "leaf", "triangles", "filtered"):
        assert torch.equal(getattr(vis, f), getattr(ovis, f)), f


@pytest.mark.parametrize("n, leaf_size, anyhit, max_steps", [
    (300, 1, False, None), (300, 1, True, None), (300, 4, False, None), (300, 4, True, None),
    (300, 1, False, 20), (300, 4, True, 15)])
def test_tables_walk_equals_reference(n, leaf_size, anyhit, max_steps):
    """The plain walk over pack_flat's tables, through trace with the
    tables and with the tree, and through trace_flat with the per-call
    packing, against the reference op by op."""
    tris, j, p = _trees(n, leaf_size, seed=n + 7 * leaf_size)
    o, d, tmax = _rays(tris, seed=n + leaf_size)
    ref = _reference(j, tris, o, d, tmax, anyhit, max_steps)
    tables = ptrav.pack_flat(p, torch.from_numpy(tris))
    args = (torch.from_numpy(o), torch.from_numpy(d), 0.01, torch.from_numpy(tmax))
    _assert_same(ptrav.trace(tables, *args, anyhit=anyhit, max_steps=max_steps), ref)
    _assert_same(ptrav.trace_flat(ptrav.pack_nodes(p), ptrav.pack_tris(torch.from_numpy(tris)),
                                  p.order, leaf_size, p.root, *args, anyhit=anyhit,
                                  max_steps=max_steps), ref)
    _assert_same(ptrav.trace(p, *args, anyhit=anyhit, max_steps=max_steps,
                             tri_verts=torch.from_numpy(tris)), ref)
    assert int((ref["tri"] >= 0).sum()) > N_RAYS // 8
    assert not (ref["tri"][::6] >= 0).any() and (ref["t"][::6] == -1.0).all()
    if max_steps is not None:  # the cap bites: the uncapped walk finds more
        assert int(ptrav.trace(tables, *args, anyhit=anyhit).hit.sum()) > int(
            (ref["tri"] >= 0).sum())


@pytest.mark.parametrize("anyhit", [True, False])
def test_tables_walk_with_alpha_filter_equals_reference(anyhit):
    """checker_quad(alpha_leaf=True), rays aimed at its masked quad and
    ending just past it: the filtered walk over the tables equals the
    reference's, and the filter rejects something."""
    js = jproc.checker_quad(alpha_leaf=True)
    world = jgeo.to_world(js.buffers)
    tris = np.array(jbvh.world_triangles(world.position, js.buffers.tri_vertex))
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    j = jbvh.build(jnp.asarray(tris), leaf_size=4)
    p = bridge.bvh_from_numpy(dataclasses.asdict(j), 4)
    o, d, _ = _rays(tris, seed=21, targets=np.asarray(js.buffers.alpha_tri_idx))
    n = N_RAYS // 2
    o, d, tmax = o[:n], d[:n], np.full(n, 2.5, np.float32)
    tmax[::5] = -1.0
    filt = jtrav.make_alpha_hit_filter(js.buffers, jshadetab.build_shade_tables(js.buffers))
    ref = _reference(j, tris, o, d, tmax, anyhit, hit_filter=filt)
    tables = ptrav.pack_flat(p, torch.from_numpy(tris))
    args = (torch.from_numpy(o), torch.from_numpy(d), 0.01, torch.from_numpy(tmax))
    got = ptrav.trace_flat(tables, *args, anyhit=anyhit,
                           alpha_tables=pshadetab.build_shade_tables(ps.buffers.to("cpu")))
    _assert_same(got, ref)
    assert int((ptrav.trace_flat(tables, *args, anyhit=anyhit).tri != got.tri).sum()) > 0


def test_wrapper_contract():
    """On CPU tensors trace_flat runs the plain walk (equal to
    trace_flat_plain, a Python-float or (R,) tmin / tmax alike); any other
    device raises, in both call forms; a call with neither tables nor the
    packed tree is a TypeError."""
    tris = _soup(64, seed=5)
    p = pbvh.build(torch.from_numpy(tris))
    tables = ptrav.pack_flat(p, torch.from_numpy(tris))
    o, d, tmax = (torch.from_numpy(a) for a in _rays(tris, seed=5))
    got = ptrav.trace_flat(tables, o, d, 0.01, 1000.0)
    steps = ptrav.default_flat_max_steps(tables)
    want = ptrav.trace_flat_plain(tables, o, d, torch.full((N_RAYS,), 0.01),
                                  torch.full((N_RAYS,), 1000.0), False, steps)
    for f in ("t", "tri", "u", "v"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(got.hit.sum()) > 0
    meta = torch.empty((4, 3), device="meta")
    meta_tables = dataclasses.replace(tables, nodes=tables.nodes.to("meta"),
                                      leaf_tris=tables.leaf_tris.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        ptrav.trace_flat(meta_tables, meta, meta, 0.01, 1e4)
    with pytest.raises(ValueError, match="unsupported device"):
        ptrav.trace(meta_tables, meta, meta, 0.01, 1e4)
    with pytest.raises(ValueError, match="unsupported device"):
        ptrav.trace_flat(ptrav.pack_nodes(p).to("meta"), torch.empty((64, 9), device="meta"),
                         p.order.to("meta"), 1, p.root, meta, meta, 0.01, 1e4)
    with pytest.raises(TypeError, match="FlatTables"):
        ptrav.trace_flat(tables.nodes, o, d)
