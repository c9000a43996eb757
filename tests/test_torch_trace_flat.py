"""K4, the threaded walk of a binary LBVH (on the CPU its plain version,
``trace_flat_plain``), against the JAX package's ``traverse.trace`` on a
binary tree (``_trace_flat``), on the same tree, triangles and rays.

Inputs from numpy seeds: a 300-triangle soup (leaf_size 1 and 4), 2,000
triangles, the small SponzaProxy with its alpha-masked leaves and
checker_quad(alpha_leaf=True); rays aimed at random triangles and at
random, a sixth of them with tmax < tmin.
Tolerances: (t, tri, u, v) equal on every ray against the reference run op
by op (``jax.disable_jit()``), closest-hit and any-hit, with a max_steps cap
that bites, and with the alpha filter.  Against the jitted reference the
triangles are equal and t, u, v differ in the last bits on some rays (XLA
contracts Moller-Trumbore's products into FMAs).  Closest hits also equal the port's K2 plain walk over the SAH
BVH8 of the same triangles (t within 1e-4 and tri equal, as
tests/test_native.py:61-79, but where two triangles lie at exactly the same
t; measured: none of these 256 rays).  The visit counts that price K4's
bound equal a walk of each ray on its own.  ~44-46 s alone, most of it the
reference's walk op by op.
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
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.ops import bvh as pbvh
from vulkanhybridrenderer_tpu_torch.ops import bvh8 as pbvh8
from vulkanhybridrenderer_tpu_torch.ops import shadetab as pshadetab
from vulkanhybridrenderer_tpu_torch.ops import traverse as ptrav

torch.set_num_threads(2)
N_RAYS = 256


def _soup(n, seed=0, spread=10.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (n, 1, 3))
    return (base + rng.uniform(-0.5, 0.5, (n, 3, 3))).astype(np.float32)


def _rays(tris, seed, targets=None):
    """Half the rays aimed at random points of `targets` (default: every
    triangle) from 2-6 units away, half from random points in random
    directions; every sixth ray has tmax < tmin."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(np.arange(tris.shape[0]) if targets is None else targets, N_RAYS)
    b = rng.dirichlet(np.ones(3), N_RAYS)
    target = np.einsum("rk,rkc->rc", b, tris[ids])
    o = target + rng.normal(size=(N_RAYS, 3)) * 2.0
    d = target - o
    lo, hi = tris.reshape(-1, 3).min(0), tris.reshape(-1, 3).max(0)
    o[N_RAYS // 2:] = rng.uniform(lo, hi, (N_RAYS // 2, 3))
    d[N_RAYS // 2:] = rng.normal(size=(N_RAYS // 2, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(N_RAYS, 1000.0, np.float32)
    tmax[::6] = -1.0
    return o.astype(np.float32), d.astype(np.float32), tmax


def _setup(n, leaf_size, seed):
    tris = _soup(n, seed=seed)
    j = jbvh.build(jnp.asarray(tris), leaf_size=leaf_size)
    p = bridge.bvh_from_numpy(dataclasses.asdict(j), leaf_size)
    return tris, j, p


def _reference(j, tris, o, d, tmax, anyhit, max_steps=None, hit_filter=None):
    with jax.disable_jit():
        r = jtrav.trace(j, jnp.asarray(tris), jnp.asarray(o), jnp.asarray(d), 0.01,
                        jnp.asarray(tmax), anyhit=anyhit, max_steps=max_steps,
                        hit_filter=hit_filter)
    return {f: np.asarray(getattr(r, f)) for f in ("t", "tri", "u", "v")}


def _assert_same(got, ref):
    for f in ("t", "tri", "u", "v"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), ref[f], err_msg=f)


@pytest.mark.parametrize("n, leaf_size, anyhit, max_steps", [
    (300, 1, False, None), (300, 4, False, None), (300, 4, True, None), (300, 1, False, 20),
    (300, 4, True, 15), (2000, 1, True, None)])
def test_walk_equals_reference(n, leaf_size, anyhit, max_steps):
    tris, j, p = _setup(n, leaf_size, seed=n + leaf_size)
    o, d, tmax = _rays(tris, seed=n)
    ref = _reference(j, tris, o, d, tmax, anyhit, max_steps)
    got = ptrav.trace(p, torch.from_numpy(tris), torch.from_numpy(o), torch.from_numpy(d), 0.01,
                      torch.from_numpy(tmax), anyhit=anyhit, max_steps=max_steps)
    _assert_same(got, ref)
    hits = int((ref["tri"] >= 0).sum())
    assert hits > N_RAYS // 8 and not (ref["tri"][::6] >= 0).any()
    if max_steps is not None:
        # the cap bites: the uncapped walk finds more (measured 68 of 110,
        # 35 of 110)
        full = ptrav.trace(p, torch.from_numpy(tris), torch.from_numpy(o), torch.from_numpy(d),
                           0.01, torch.from_numpy(tmax), anyhit=anyhit)
        assert int(full.hit.sum()) > hits


def _scene(js):
    world = jgeo.to_world(js.buffers)
    tris = np.array(jbvh.world_triangles(world.position, js.buffers.tri_vertex))
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    return dict(js=js, tris=tris, jtables=jshadetab.build_shade_tables(js.buffers),
                ptables=pshadetab.build_shade_tables(ps.buffers.to("cpu")),
                alpha_idx=np.asarray(js.buffers.alpha_tri_idx))


@pytest.fixture(scope="module")
def sponza():
    return _scene(jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8))


@pytest.mark.parametrize("name, anyhit", [("sponza", False),
                                          ("checker", True)])
def test_alpha_filter_equals_reference(sponza, name, anyhit):
    """The filtered walk, rays aimed at masked triangles and ending just
    past them: SponzaProxy's leaf discs (48 rays; the reference's filtered
    walk op by op takes ~0.1 s a step) and checker_quad(alpha_leaf=True)'s
    quad, whose texture's corners are transparent.  Equal to the
    reference's, and the filter rejects something."""
    s = sponza if name == "sponza" else _scene(jproc.checker_quad(alpha_leaf=True))
    tris = s["tris"]
    j = jbvh.build(jnp.asarray(tris), leaf_size=4)
    p = bridge.bvh_from_numpy(dataclasses.asdict(j), 4)
    o, d, _ = _rays(tris, seed=21, targets=s["alpha_idx"])
    n = 48 if name == "sponza" else N_RAYS // 2
    o, d, tmax = o[:n], d[:n], np.full(n, 2.5, np.float32)
    filt = jtrav.make_alpha_hit_filter(s["js"].buffers, s["jtables"])
    ref = _reference(j, tris, o, d, tmax, anyhit, hit_filter=filt)
    args = (torch.from_numpy(o), torch.from_numpy(d), 0.01, torch.from_numpy(tmax))
    got = ptrav.trace(p, torch.from_numpy(tris), *args, anyhit=anyhit, alpha_tables=s["ptables"])
    _assert_same(got, ref)
    solid = ptrav.trace(p, torch.from_numpy(tris), *args, anyhit=anyhit)
    assert int((solid.tri != got.tri).sum()) > 0


def test_closest_hits_equal_k2_on_sah_bvh8(sponza):
    """The oracle: K4's plain walk over the LBVH against K2's plain walk
    over the SAH BVH8 of the same triangles."""
    tris = sponza["tris"]
    lbvh = pbvh.build(torch.from_numpy(tris))
    sah = pbvh8.build_bvh8_sah_host(tris)
    o, d, tmax = (torch.from_numpy(a) for a in _rays(tris, seed=4))
    flat = ptrav.trace(lbvh, torch.from_numpy(tris), o, d, 0.01, tmax)
    wide = ptrav.trace(sah, None, o, d, 0.01, tmax)
    # two triangles at exactly the same t (a shared edge) may each be the
    # nearest: the only disagreement allowed
    assert torch.equal(flat.tri != wide.tri, (flat.tri != wide.tri) & (flat.t == wide.t))
    assert int((flat.tri != wide.tri).sum()) <= 2 and int(flat.hit.sum()) > N_RAYS // 3
    assert float((flat.t - wide.t).abs().max()) <= 1e-4
    any_flat = ptrav.trace(lbvh, torch.from_numpy(tris), o, d, 0.01, tmax, anyhit=True)
    assert torch.equal(any_flat.hit, ptrav.trace(sah, None, o, d, 0.01, tmax, anyhit=True).hit)


def _walk_one(nodes, tris9, order, leaf_size, root, o, d, tmin, tmax, anyhit, max_steps):
    """One ray's threaded walk with plain Python control flow and the port's
    arithmetic on one-element tensors: (tri, internal, leaf, triangles)."""
    inv = 1.0 / torch.where(d.abs() < 1e-12, torch.where(d >= 0, 1e-12, -1e-12), d)
    node, best, tri_best, counts = root, tmax.clone(), -1, [0, 0, 0]
    for _ in range(max_steps):
        if node < 0:
            break
        row = nodes[node]
        if row[6] >= -1.5:
            counts[0] += 1
            t0, t1 = (row[0:3] - o) * inv, (row[3:6] - o) * inv
            lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            tn = torch.maximum(torch.maximum(lo[0], lo[1]), lo[2])
            tf = torch.minimum(torch.minimum(hi[0], hi[1]), hi[2])
            hit = bool(torch.maximum(tn, tmin) <= torch.minimum(tf, best))
            node = int(row[6]) if hit else int(row[7])
            continue
        counts[1] += 1
        start, found = int(-row[6] - 2), False
        for k in range(leaf_size):
            tri = int(order[start + k])
            if tri < 0:
                continue
            counts[2] += 1
            v = tris9[tri]
            t, _, _, ok = ptrav.moller_trumbore(v[0:3], v[3:6], v[6:9], o, d)
            if bool(ok) and bool(t >= tmin) and bool(t < best):
                best, tri_best, found = t, tri, True
        node = -1 if (anyhit and found) else int(row[7])
    return tri_best, *counts


@pytest.mark.parametrize("leaf_size, anyhit", [(1, False), (4, True)])
def test_visit_counts_equal_a_walk_per_ray(leaf_size, anyhit):
    tris = _soup(300, seed=6)
    p = pbvh.build(torch.from_numpy(tris), leaf_size=leaf_size)
    o, d, tmax = (torch.from_numpy(a)[:96] for a in _rays(tris, seed=6))
    nodes, tris9 = ptrav.pack_nodes(p), ptrav.pack_tris(torch.from_numpy(tris))
    tmin = torch.full((96,), 0.01)
    steps = ptrav.default_flat_max_steps(nodes)
    rec, vis = ptrav.trace_flat_plain(nodes, tris9, p.order, leaf_size, p.root, o, d, tmin, tmax,
                                      anyhit, steps, visits=True)
    for i in range(96):
        want = _walk_one(nodes, tris9, p.order, leaf_size, p.root, o[i], d[i], tmin[i], tmax[i],
                         anyhit, steps)
        assert (int(rec.tri[i]), int(vis.internal[i]), int(vis.leaf[i]),
                int(vis.triangles[i])) == want, i
    # a ray with tmax < tmin walks the root's step and nothing else
    assert int(vis.internal[0]) == 1 and int(vis.leaf[0] + vis.triangles[0]) == 0
    assert not bool(vis.filtered.any())


def test_k4_wrapper_contract(tmp_path, monkeypatch):
    """trace needs the triangles for a binary tree; K4's wrapper raises on
    a device that is neither CPU nor CUDA (no silent fallback); its library's
    build key covers the header it includes (alpha_filter.cuh), as
    utils/build.cuda_library_path hashes csrc's headers."""
    import shutil
    import sys

    from vulkanhybridrenderer_tpu_torch.utils import build

    tris = _soup(37, seed=3)
    p = pbvh.build(torch.from_numpy(tris))
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="tri_verts"):
        ptrav.trace(p, None, o, o, 0.01, 1e4)
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ptrav.trace_flat(ptrav.pack_nodes(p).to("meta"), meta, p.order.to("meta"), 1, 0, meta,
                         meta, 0.01, 1e4)
    assert ptrav.default_flat_max_steps(ptrav.pack_nodes(p)) == 4 * 73 + 4

    cc = tmp_path / "fake_cc.py"
    cc.write_text("import sys\na = sys.argv[1:]\nopen(a[a.index('-o') + 1], 'wb').write("
                  "b''.join(open(s, 'rb').read() for s in a[a.index('-o') + 2:]))\n")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("bvh_flat_trace.cu", "alpha_filter.cuh"):
        shutil.copy(build.CSRC_DIR / name, csrc / name)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "NVCC_FLAGS", [str(cc)])
    monkeypatch.setattr(build, "nvcc_path", lambda: sys.executable)
    first = build.cuda_library_path("bvh_flat_trace.cu")
    assert build.cuda_library_path("bvh_flat_trace.cu") == first
    with open(csrc / "alpha_filter.cuh", "a") as f:
        f.write("// edited\n")
    assert build.cuda_library_path("bvh_flat_trace.cu") != first
