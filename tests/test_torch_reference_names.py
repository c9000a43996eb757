"""Calls written for the reference, made on both packages: the repaired
signatures of ``Renderer.profile`` and ``ops/traverse.moller_trumbore``,
and the reference's public names the port had lacked: ``BVH8.root`` /
``is_leaf_rows``, ``traverse.ray_octants``, ``geometry.to_world``'s
``prim_normal_mat``, ``make_alpha_hit_filter(scene)`` and
``filters.flat_gather``.  (``build_bvh8_host``, ``hybrid_raytrace`` and
``add_shadow_map_pass``, which compile the reference's walks or its brute
raster, have files of their own.)

Exact where the two compute the same operations in the same order
(octants, gathers, leaf rows, the alpha filter's mask), and Möller–Trumbore
against the reference under ``jax.disable_jit()``, where it rounds every
product as the port does (jitted, XLA contracts them into FMAs and 4 of
the 2,048 hit masks flip); to_world within 1e-6.  ~15 s alone.
"""
import dataclasses
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vulkanhybridrenderer_tpu import native_bridge as jnative
from vulkanhybridrenderer_tpu.ops import bvh as jbvh
from vulkanhybridrenderer_tpu.ops import bvh8 as jbvh8
from vulkanhybridrenderer_tpu.ops import filters as jfilters
from vulkanhybridrenderer_tpu.ops import geometry as jgeo
from vulkanhybridrenderer_tpu.ops import shadetab as jtab
from vulkanhybridrenderer_tpu.ops import traverse as jtrav
from vulkanhybridrenderer_tpu.runtime import renderer as jrenderer
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.ops import bvh8 as pbvh8
from vulkanhybridrenderer_tpu_torch.ops import filters as pfilters
from vulkanhybridrenderer_tpu_torch.ops import geometry as pgeo
from vulkanhybridrenderer_tpu_torch.ops import shadetab as ptab
from vulkanhybridrenderer_tpu_torch.ops import traverse as ptrav
from vulkanhybridrenderer_tpu_torch.runtime import renderer as prenderer
from vulkanhybridrenderer_tpu_torch.scene import procedural as pproc

torch.set_num_threads(2)


def _port_scene(js):
    return bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                   dataclasses.asdict(js.camera), dataclasses.asdict(js.light))


def _defaults(fn):
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()}


def test_profile_default_directory_and_return(monkeypatch, tmp_path):
    """profile() as the reference's: trace_dir defaults to /tmp/vhr_trace
    (the two signatures' defaults are equal) and a call without it returns
    the default directory with the Chrome trace inside.  The call is made
    with the default pointed at a temporary directory, so the test writes
    nothing outside it."""
    assert _defaults(prenderer.Renderer.profile) == _defaults(jrenderer.Renderer.profile)
    assert _defaults(prenderer.Renderer.profile)["trace_dir"] == "/tmp/vhr_trace"
    default = str(tmp_path / "vhr_trace")
    monkeypatch.setattr(prenderer.Renderer.profile, "__defaults__", (default, 3))
    r = prenderer.Renderer(pproc.cornell_box(), pcfg.RenderConfig(width=16, height=16),
                           device="cpu")
    assert r.profile(frames=1) == default
    trace = Path(default) / f"{r.path_name}_frame{r.frame_index}.json"
    assert trace.is_file() and trace.stat().st_size > 0


def _triangles(rng, n):
    v0 = rng.normal(size=(n, 3)).astype(np.float32)
    e1 = rng.normal(size=(n, 3)).astype(np.float32)
    e2 = rng.normal(size=(n, 3)).astype(np.float32)
    # a quarter nearly degenerate, so eps decides their det test
    e2[: n // 4] = e1[: n // 4] * 0.5 + rng.normal(scale=1e-4, size=(n // 4, 3))
    o = rng.normal(size=(n, 3)).astype(np.float32) * 3
    target = v0 + rng.uniform(0, 0.5, (n, 1)) * e1 + rng.uniform(0, 0.5, (n, 1)) * e2
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return [a.astype(np.float32) for a in (v0, v0 + e1, v0 + e2, o, d)]


@pytest.mark.parametrize("eps", [None, 1e-9, 1e-4])
def test_moller_trumbore_reference_call(eps):
    """moller_trumbore(v0, v1, v2, origin, direction[, eps]) on (..., 3)
    arrays, eps by position."""
    args = _triangles(np.random.default_rng(3), 2048)
    extra = () if eps is None else (eps,)
    with jax.disable_jit():
        jt, ju, jv, jok = (np.asarray(a) for a in jtrav.moller_trumbore(
            *map(jnp.asarray, args), *extra))
    pt, pu, pv, pok = (a.numpy() for a in ptrav.moller_trumbore(
        *map(torch.from_numpy, args), *extra))
    for p, j in ((pok, jok), (pt, jt), (pu, ju), (pv, jv)):
        np.testing.assert_array_equal(p, j)
    assert 0.2 < pok.mean() < 1.0
    if eps == 1e-4:  # eps changes the answer on the near-degenerate quarter
        loose = ptrav.moller_trumbore(*map(torch.from_numpy, args))[3].numpy()
        assert (loose != pok).any()


def test_moller_trumbore_stage_by_keyword():
    """stage stays available by keyword, after eps."""
    args = [torch.from_numpy(a) for a in _triangles(np.random.default_rng(4), 256)]
    t, u, v, ok, at = ptrav.moller_trumbore(*args, stage=True)
    assert torch.equal(ok, at == 3)


def _world_tris(js):
    return np.array(jbvh.world_triangles(jgeo.to_world(js.buffers).position,
                                         js.buffers.tri_vertex))


def test_bvh8_root_and_leaf_rows():
    tris = _world_tris(jproc.cornell_box())
    j = jbvh8.build_bvh8_host(jnative.build_sah_host(tris), jnp.asarray(tris), leaf_max=8)
    b = pbvh8.build_bvh8_sah_host(tris)
    assert b.root == j.root == 0
    np.testing.assert_array_equal(b.is_leaf_rows.numpy(), np.asarray(j.is_leaf_rows))
    assert b.is_leaf_rows.dtype == torch.bool and 0 < int(b.is_leaf_rows.sum()) < b.num_rows


@pytest.mark.parametrize("shape", [(512,), (16, 32)])
def test_ray_octants(shape):
    rng = np.random.default_rng(7)
    d = rng.normal(size=shape + (3,)).astype(np.float32)
    d.reshape(-1, 3)[:64] = np.array([0.0, -0.0, 1.0], np.float32)  # signed zeros
    j = np.asarray(jtrav.ray_octants(jnp.asarray(d)))
    p = ptrav.ray_octants(torch.from_numpy(d))
    assert p.dtype == torch.int32 and p.shape == shape
    np.testing.assert_array_equal(p.numpy(), j)
    assert set(np.unique(j)) == set(range(8))


def test_to_world_prim_normal_mat():
    """An explicit prim_normal_mat (and prim_transform) overrides the
    scene's, as in the reference."""
    js = jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8)
    pb = _port_scene(js).buffers.to("cpu")
    rng = np.random.default_rng(8)
    n_prim = np.asarray(js.buffers.prim_normal_mat).shape[0]
    nm = rng.normal(size=(n_prim, 4, 4)).astype(np.float32)
    m = np.asarray(js.buffers.prim_transform).copy()
    m[:, :3, 3] += rng.normal(size=(n_prim, 3)).astype(np.float32)
    for kw in (dict(prim_normal_mat=nm), dict(prim_transform=m, prim_normal_mat=nm)):
        j = jgeo.to_world(js.buffers, **{k: jnp.asarray(v) for k, v in kw.items()})
        p = pgeo.to_world(pb, **{k: torch.from_numpy(v) for k, v in kw.items()})
        for f in ("position", "normal", "tangent"):
            np.testing.assert_allclose(getattr(p, f).numpy(), np.asarray(getattr(j, f)),
                                       rtol=1e-6, atol=1e-6)
    base = pgeo.to_world(pb)
    assert not torch.allclose(p.normal, base.normal)


@pytest.mark.parametrize("scene", ["checker", "sponza"])
def test_make_alpha_hit_filter_from_scene(scene):
    """make_alpha_hit_filter(scene) builds its own shade tables; the filter
    takes the reference's four arguments (candidate ignored) or three."""
    js = (jproc.checker_quad(alpha_leaf=True) if scene == "checker"
          else jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8))
    pb = _port_scene(js).buffers.to("cpu")
    idx = np.asarray(js.buffers.alpha_tri_idx)
    rng = np.random.default_rng(9)
    tri = rng.choice(idx, 2048).astype(np.int32)
    b = rng.dirichlet(np.ones(3), 2048).astype(np.float32)
    u, v = b[:, 1], b[:, 2]
    cand = rng.uniform(size=2048) < 0.5
    ja = np.asarray(jtrav.make_alpha_hit_filter(js.buffers)(
        jnp.asarray(tri), jnp.asarray(u), jnp.asarray(v), jnp.asarray(cand)))
    pf = ptrav.make_alpha_hit_filter(pb)
    args = (torch.from_numpy(tri), torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_array_equal(pf(*args, torch.from_numpy(cand)).numpy(), ja)
    np.testing.assert_array_equal(pf(*args).numpy(), ja)
    np.testing.assert_array_equal(
        ptrav.make_alpha_hit_filter(pb, ptab.build_shade_tables(pb))(*args).numpy(), ja)
    assert 0.05 < ja.mean() < 0.95  # both outcomes exercised


def test_flat_gather():
    rng = np.random.default_rng(10)
    table = rng.normal(size=97).astype(np.float32)
    idx = rng.integers(0, 97, (5, 7, 3)).astype(np.int32)
    j = np.asarray(jfilters.flat_gather(jnp.asarray(table), jnp.asarray(idx)))
    p = pfilters.flat_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert p.shape == idx.shape
    np.testing.assert_array_equal(p.numpy(), j)
