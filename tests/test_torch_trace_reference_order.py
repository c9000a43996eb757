"""``traverse.trace`` takes the reference's signature: the reference's own
positional call ``trace(bvh, tri_verts, origin, direction, tmin, tmax)``
and its ``anyhit=True, hit_filter=make_alpha_hit_filter(...)`` run on the
port with the reference's results, on a BVH8 and on a binary LBVH.

Scene: checker_quad(alpha_leaf=True), rays from above, a third of them
through the leaf texture's transparent corners (tests/test_torch_alpha_filter.py).
The BVH8 is the native SAH build's, the same table on both sides; the
binary tree is the reference's LBVH, carried across by bridge.bvh_from_numpy.
Tolerances: any-hit masks equal on every ray; closest hits the same
triangle on every ray, t within 1e-5 against the jitted BVH8 walk (XLA
contracts Moller-Trumbore into FMAs) and equal, with u and v, against the
binary walk run op by op (``jax.disable_jit()``).  The TPU schedule
keywords change no hit; a filter that is not make_alpha_hit_filter's
raises.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanhybridrenderer_tpu import native_bridge as jnative
from vulkanhybridrenderer_tpu.ops import bvh as jbvh
from vulkanhybridrenderer_tpu.ops import bvh8 as jbvh8
from vulkanhybridrenderer_tpu.ops import geometry as jgeo
from vulkanhybridrenderer_tpu.ops import traverse as jtrav
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.ops import traverse as ptrav

torch.set_num_threads(2)
N_RAYS = 384


@pytest.fixture(scope="module")
def case():
    js = jproc.checker_quad(alpha_leaf=True)
    world = jgeo.to_world(js.buffers)
    tris = np.array(jbvh.world_triangles(world.position, js.buffers.tri_vertex))
    rng = np.random.default_rng(11)
    o = np.stack([rng.uniform(-2.5, 2.5, N_RAYS), rng.uniform(0.5, 3.0, N_RAYS),
                  rng.uniform(-2.5, 2.5, N_RAYS)], -1)
    d = np.stack([rng.normal(0, 0.2, N_RAYS), -np.ones(N_RAYS), rng.normal(0, 0.2, N_RAYS)], -1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(N_RAYS, 1000.0, np.float32)
    tmax[::7] = -1.0
    jb8 = jbvh8.build_bvh8_host(jnative.build_sah_host(tris), tris, leaf_max=8)
    jlb = jbvh.build(jnp.asarray(tris), leaf_size=1)
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    return dict(
        js=js, ps=ps, tris=tris, o=o.astype(np.float32), d=d.astype(np.float32), tmax=tmax,
        bvh8=(jb8, bridge.bvh8_from_numpy(np.asarray(jb8.rows), jb8.depth, jb8.leaf_max)),
        binary=(jlb, bridge.bvh_from_numpy(dataclasses.asdict(jlb), 1)))


def _port_args(c):
    return (torch.from_numpy(c["tris"]), torch.from_numpy(c["o"]), torch.from_numpy(c["d"]),
            0.01, torch.from_numpy(c["tmax"]))


@pytest.mark.parametrize("mode", ["closest-hit", "any-hit", "filtered any-hit"])
@pytest.mark.parametrize("kind", ["bvh8", "binary"])
def test_reference_positional_call(case, kind, mode):
    jb, pb = case[kind]
    kw, pkw = {}, {}
    if mode != "closest-hit":
        kw["anyhit"] = pkw["anyhit"] = True
    if mode.startswith("filtered"):
        kw["hit_filter"] = jtrav.make_alpha_hit_filter(case["js"].buffers)
        pkw["hit_filter"] = ptrav.make_alpha_hit_filter(case["ps"].buffers.to("cpu"))
    args = (jnp.asarray(case["tris"]), jnp.asarray(case["o"]), jnp.asarray(case["d"]), 0.01,
            jnp.asarray(case["tmax"]))
    if kind == "binary":
        with jax.disable_jit():
            want = jtrav.trace(jb, *args, **kw)
    else:
        want = jtrav.trace(jb, *args, **kw)
    got = ptrav.trace(pb, *_port_args(case), **pkw)
    hit = np.asarray(want.tri) >= 0
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    assert 0 < int(hit.sum()) < N_RAYS
    if mode == "closest-hit":
        np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
        if kind == "binary":
            for f in ("t", "u", "v"):
                np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
        else:
            np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], atol=1e-5)
    if mode.startswith("filtered"):
        # the filter maps to the port's alpha_tables: the same walk, and
        # through the leaf's transparent texels fewer hits than unfiltered
        tables = pkw["hit_filter"].tables
        same = ptrav.trace(pb, *_port_args(case), anyhit=True, alpha_tables=tables)
        assert torch.equal(same.hit, got.hit)
        solid = ptrav.trace(pb, *_port_args(case), anyhit=True)
        assert int(solid.hit.sum()) > int(got.hit.sum())


@pytest.mark.parametrize("kind", ["bvh8", "binary"])
def test_schedule_keywords_change_nothing(case, kind):
    """strips, compact, sort_rays, packets, packet_phases and unroll steer
    only the reference's TPU loops: the port takes them by position and by
    name and returns the same record."""
    pb = case[kind][1]
    base = ptrav.trace(pb, *_port_args(case), True)
    for got in (ptrav.trace(pb, *_port_args(case), True, None, None, 4, True, True, 128,
                            ((32, 4),), 2),
                ptrav.trace(pb, *_port_args(case), anyhit=True, strips=1, compact=True,
                            sort_rays=True, packets=64, packet_phases=((16, 2), (8, 1)),
                            unroll=4)):
        for f in ("t", "tri", "u", "v"):
            assert torch.equal(getattr(got, f), getattr(base, f)), f


def test_other_hit_filters_raise(case):
    """The port filters inside the kernel: a callable that is not
    make_alpha_hit_filter's has nothing the kernel can run."""
    pb = case["bvh8"][1]
    with pytest.raises(ValueError, match="make_alpha_hit_filter"):
        ptrav.trace(pb, *_port_args(case), True, lambda tri, u, v, cand: cand)
    tables = ptrav.make_alpha_hit_filter(case["ps"].buffers.to("cpu")).tables
    other = ptrav.make_alpha_hit_filter(case["ps"].buffers.to("cpu"))
    with pytest.raises(ValueError, match="both hit_filter and alpha_tables"):
        ptrav.trace(pb, *_port_args(case), True, other, alpha_tables=tables)


def test_signature_matches_reference():
    """The reference's parameters, defaults and order, then the port's
    keyword-only alpha_tables."""
    ref = list(inspect.signature(jtrav.trace).parameters.values())
    port = list(inspect.signature(ptrav.trace).parameters.values())
    assert [(p.name, p.default) for p in port[:len(ref)]] == [(p.name, p.default) for p in ref]
    assert [(p.name, p.kind) for p in port[len(ref):]] == [("alpha_tables",
                                                            inspect.Parameter.KEYWORD_ONLY)]
