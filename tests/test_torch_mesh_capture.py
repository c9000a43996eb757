"""The captured mesh frame's parts that the CPU can show (runtime/dispatch.py
over parallel/mesh.py): on CUDA a mesh frame is captured into CUDA graphs
spanning the mesh's cards, which needs a card; here a CapturedFrame is made
on a CPU mesh of 4 and its frame run eagerly (``run_segments``, the body a
capture records), fused and per_pass, against the renderer's eager mesh
frame: the hybrid path's, and the raytraced frame with test_alpha and the
forward frame at supersample 4, row-sharded as the hybrid's.  Checks: the temporal state's clone, copy (whole into Slabs, Slabs
into whole, Slabs into Slabs), save and restore, each slab on its own
device; the state taking the layout of the warm-up frame's (row-sharded);
``Mesh.moved`` and the launch counters re-added per replay from a
capture's deltas, equal to an eager frame's; which replicas a capture makes
inside its graph (the fixed inputs, forgotten before it) and which it reads
from the warm-up (the constants); ``precompile_passes`` on a CPU mesh.

Marked ``cuda`` (skipped here): captured frames over a virtual mesh of 4 on
one card, fused and per_pass, equal to the eager mesh frame and to one
card's over frames 0-3 with the camera moving; replayed frames' launches
and bytes equal the eager frame's.  No JAX; tolerance: none (every frame
equal bit for bit).
"""
import collections
import dataclasses
import functools

import pytest
import torch

from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.core.types import make_temporal_state
from vulkanhybridrenderer_tpu_torch.graph.render_graph import RENDER_OUTPUT, tensors_of
from vulkanhybridrenderer_tpu_torch.parallel import mesh as pmesh
from vulkanhybridrenderer_tpu_torch.runtime import dispatch
from vulkanhybridrenderer_tpu_torch.runtime.renderer import Renderer
from vulkanhybridrenderer_tpu_torch.scene import procedural as pproc

torch.set_num_threads(2)
W, H = 64, 48
CPU = torch.device("cpu")
FULL = pcfg.HybridSettings(
    shadow_mode=pcfg.ShadowMode.RAYTRACED, ao_mode=pcfg.AmbientOcclusionMode.RAYTRACED,
    reflection_mode=pcfg.ReflectionMode.RAYTRACED, denoise=True)


def _config(rt_scale=1, w=W, h=H):
    return pcfg.RenderConfig(width=w, height=h, alpha_raster="off", shadow_map_size=128,
                             hybrid=dataclasses.replace(FULL, rt_scale=rt_scale))


def _frame(r, per_pass: bool):
    """A CapturedFrame of renderer r's active key, as the renderer makes it."""
    state = r.path.uses_temporal_state
    return dispatch.CapturedFrame(
        "test", r.graph, RENDER_OUTPUT, (dispatch.TEMPORAL_OUT,) if state else (), per_pass,
        r.device, r._consts(), r.buffers.num_primitives, r.temporal_state if state else None,
        (r.config.height, r.config.width))


def _step(r, f):
    r.update_camera(0.05, keys={"w"} if f % 2 else {"d"})


def _random_state(h, w, seed=0):
    g = torch.Generator().manual_seed(seed)
    st = make_temporal_state(h, w, device=CPU)
    return dataclasses.replace(st, **{f.name: torch.rand(getattr(st, f.name).shape, generator=g)
                                      for f in dataclasses.fields(st)})


def _whole(x):
    return torch.cat(x.parts, dim=-2) if isinstance(x, pmesh.Slabs) else x


def _fields(st):
    return {f.name: _whole(getattr(st, f.name)) for f in dataclasses.fields(st)}


def test_state_clone_copy_save_restore_across_layouts():
    """clone_state and copy_into on a TemporalState, whole and row-sharded
    over a CPU mesh of 4: a clone is new buffers of the same values and
    layout; a copy fills the destination's own buffers, whatever the
    source's layout; the CapturedFrame's save_state / restore_state put the
    values back into the same buffers."""
    mesh = pmesh.make_mesh([CPU] * 4)
    whole = _random_state(24, 32, seed=1)
    slabs = dataclasses.replace(whole, **{f.name: mesh.split(getattr(whole, f.name))
                                          for f in dataclasses.fields(whole)})
    for st in (whole, slabs):
        c = dispatch.clone_state(st)
        assert dispatch._layout(c) == dispatch._layout(st)
        assert all(torch.equal(a, b) and a.data_ptr() != b.data_ptr()
                   for a, b in zip(tensors_of(c), tensors_of(st)))
    other = _random_state(24, 32, seed=2)
    for dst, src in ((slabs, other), (whole, dispatch.clone_state(slabs)),
                     (dispatch.clone_state(slabs), slabs)):
        dst = dispatch.clone_state(dst)
        ptrs = [t.data_ptr() for t in tensors_of(dst)]
        dispatch.copy_into(dst, src)
        assert [t.data_ptr() for t in tensors_of(dst)] == ptrs
        for k, v in _fields(src).items():
            assert torch.equal(_fields(dst)[k], v), k
    r = Renderer(pproc.cornell_box(), _config(), mesh=mesh)
    cf = _frame(r, per_pass=False)
    cf.state = dispatch.clone_state(slabs)
    saved = cf.save_state()
    ptrs = [t.data_ptr() for t in tensors_of(cf.state)]
    dispatch.copy_into(cf.state, other)
    cf.restore_state(saved)
    assert [t.data_ptr() for t in tensors_of(cf.state)] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(tensors_of(cf.state), tensors_of(slabs)))
    cf.restore_state(whole)  # a whole state into the row-sharded buffers
    assert all(torch.equal(a, b) for a, b in zip(_fields(cf.state).values(),
                                                 _fields(whole).values()))


@pytest.mark.parametrize("rt_scale", [1, 2])
@pytest.mark.parametrize("per_pass", [False, True], ids=["fused", "per_pass"])
def test_captured_frame_body_equals_eager_mesh_frame(per_pass, rt_scale):
    """A CapturedFrame over a CPU mesh of 4, its fixed inputs refilled every
    frame and its segments run eagerly (fused: one, per_pass: one a pass),
    gives the renderer's eager mesh frames over frames 0-3 with the camera
    moving, the temporal state carried in its own buffers: row-sharded from
    the warm-up frame on, refilled in place after."""
    mesh = pmesh.make_mesh([CPU] * 4)
    eager = Renderer(pproc.cornell_box(), _config(rt_scale), mesh=mesh)
    r = Renderer(pproc.cornell_box(), _config(rt_scale), mesh=pmesh.make_mesh([CPU] * 4))
    cf = _frame(r, per_pass)
    assert cf.others == [] and cf.n_graphs == (len(r.graph.find_execution_order())
                                               if per_pass else 1)
    ptrs = None
    for f in range(4):
        _step(eager, f)
        _step(r, f)
        want = eager.render_frame()
        cf.load(r._pack_pfd(), r.prim_transform, r.temporal_state)
        res = cf.run_segments(cf.inputs())
        r.temporal_state = cf.state
        r.frame_index += 1
        assert torch.equal(res[RENDER_OUTPUT], want), f
        assert res[RENDER_OUTPUT].device == CPU
        assert type(cf.state.shadow_ao_history) is pmesh.Slabs
        assert len(cf.state.shadow_ao_history.parts) == 4
        if ptrs is None:
            ptrs = [t.data_ptr() for t in tensors_of(cf.state)]
        assert [t.data_ptr() for t in tensors_of(cf.state)] == ptrs
        for k, v in _fields(eager.temporal_state).items():
            assert torch.equal(_fields(cf.state)[k], v), (f, k)


#: the other paths' row-sharded frames (no temporal state): (scene, config)
OTHER_PATHS = {
    "raytraced, test_alpha": (functools.partial(pproc.checker_quad, alpha_leaf=True),
                              pcfg.RenderConfig(width=W, height=H, raytraced=pcfg.RaytracedSettings(
                                  test_alpha=True)), "raytraced"),
    "forward, supersample 4": (pproc.cornell_box, pcfg.RenderConfig(
        width=W, height=H, shadow_map_size=128, forward=pcfg.ForwardSettings(
            msaa_samples=4, msaa_mode="supersample")), "forward"),
}


@pytest.mark.parametrize("case", list(OTHER_PATHS))
@pytest.mark.parametrize("per_pass", [False, True], ids=["fused", "per_pass"])
def test_captured_frame_body_other_paths(per_pass, case):
    """The raytraced frame with test_alpha (each shard tracing its slab)
    and the forward frame at supersample 4 (each shard shading its band):
    a CapturedFrame's segments over a CPU mesh of 4 give the renderer's
    eager mesh frames over frames 0-3 with the camera moving, and each
    frame moves the bytes an eager frame moves."""
    scene_fn, cfg, path = OTHER_PATHS[case]
    eager = Renderer(scene_fn(), cfg, path=path, mesh=pmesh.make_mesh([CPU] * 4))
    r = Renderer(scene_fn(), cfg, path=path, mesh=pmesh.make_mesh([CPU] * 4))
    cf = _frame(r, per_pass)
    assert cf.state is None and cf.n_graphs == (len(r.graph.find_execution_order())
                                                if per_pass else 1)
    for f in range(4):
        _step(eager, f)
        _step(r, f)
        before = collections.Counter(eager.mesh.moved)
        want = eager.render_frame()
        moved = collections.Counter(eager.mesh.moved) - before
        cf.load(r._pack_pfd(), r.prim_transform)
        before = collections.Counter(r.mesh.moved)
        res = cf.run_segments(cf.inputs())
        r.frame_index += 1
        assert torch.equal(res[RENDER_OUTPUT], want), f
        if f:  # frame 0 makes the constants' replicas
            assert collections.Counter(r.mesh.moved) - before == moved, f
    assert want[:3].std() > 0.01


def test_moved_readded_per_replay():
    """The mesh's counter a capture records with the launch counters (its
    moved bytes, by kind) is one frame's: re-added at each replay it grows
    by what an eager frame moves, halos and gathers among them."""
    mesh = pmesh.make_mesh([CPU] * 4)
    r = Renderer(pproc.cornell_box(), _config(), mesh=mesh)
    r.render_frame()
    counted = dispatch.counters(mesh)
    assert counted[-1] == (mesh, "moved")
    before = dispatch.snapshot(counted)
    r.render_frame()
    frame = dispatch.delta(before, dispatch.snapshot(counted))
    moved = frame[-1]
    assert isinstance(moved, collections.Counter)
    assert moved["halo"] > 0 and moved["gather"] > 0 and moved["output"] > 0
    start = collections.Counter(mesh.moved)
    for k in range(1, 4):
        dispatch.add(counted, frame)
        assert mesh.moved == start + collections.Counter(
            {kind: k * v for kind, v in moved.items()})
    before = dispatch.snapshot(counted)
    r.render_frame()
    assert dispatch.delta(before, dispatch.snapshot(counted))[-1] == moved


def test_capture_copies_the_fixed_inputs_and_reads_the_constants():
    """Which replicas a capture makes inside its graph: after the warm-up
    frame every object it replicated is cached; the capture forgets the
    fixed inputs (the per-frame arrays, the transforms, the state), so it
    copies them again, inside the graph, while the constants (the scene,
    its tables, the BVH8) keep the warm-up's replicas.  A frame run after
    forgetting moves what an eager frame moves."""
    mesh = pmesh.make_mesh([CPU] * 4)
    eager = Renderer(pproc.cornell_box(), _config(), mesh=pmesh.make_mesh([CPU] * 4))
    r = Renderer(pproc.cornell_box(), _config(), mesh=mesh)
    cf = _frame(r, per_pass=False)
    cf.load(r._pack_pfd(), r.prim_transform, r.temporal_state)
    cf.run_segments(cf.inputs())  # the warm-up
    consts = [cf.consts[k] for k in ("scene", "shade_tables", "bvh")]
    for x in (*consts, cf.prim):
        mesh.replicate(x)
    cached = set(mesh._replicas)
    assert {id(x) for x in consts} <= cached and id(cf.prim) in cached
    mesh.forget(cf.flat, cf.ints, cf.prim, cf.state)
    assert id(cf.prim) not in mesh._replicas
    assert {id(x) for x in consts} <= set(mesh._replicas)
    n = mesh.moved["replica"]
    mesh.replicate(consts[0])
    assert mesh.moved["replica"] == n
    mesh.replicate(cf.prim)
    assert mesh.moved["replica"] == n + cf.prim.numel() * 4 * 3
    # a frame after the forgetting moves an eager frame's bytes
    eager.render_frame()
    before = collections.Counter(eager.mesh.moved)
    eager.render_frame()
    want = collections.Counter(eager.mesh.moved) - before
    mesh.forget(cf.flat, cf.ints, cf.prim, cf.state)
    cf.load(r._pack_pfd(), r.prim_transform, r.temporal_state)
    before = collections.Counter(mesh.moved)
    cf.run_segments(cf.inputs())
    assert collections.Counter(mesh.moved) - before == want


def test_precompile_passes_on_a_cpu_mesh():
    """On a CPU mesh precompile_passes builds nothing: 0.0 for every pass
    and both dunder keys, nothing advanced; the per_pass mesh frames after
    it equal the fused ones."""
    sc = pproc.cornell_box()
    ra = Renderer(sc, _config(), mesh=pmesh.make_mesh([CPU] * 4), dispatch="per_pass")
    rb = Renderer(sc, _config(), mesh=pmesh.make_mesh([CPU] * 4))
    times = ra.precompile_passes()
    order = ra.graph.find_execution_order()
    assert set(times) == set(order) | {"__trace_s__", "__wall_s__"}
    assert all(v == 0.0 for v in times.values())
    assert ra.frame_index == 0 and ra._prev_view is None and ra._captured is None
    for _ in range(2):
        assert torch.equal(ra.render_frame(), rb.render_frame())


def _eager_cuda(r):
    """One eager mesh frame of r on the card (the mesh frame function, not
    the captured frame), advancing r as render_frame does."""
    res = r._frame_fn()(r._resources(r._make_pfd()))
    if r.path.uses_temporal_state:
        r.temporal_state = res["TemporalStateOut"]
    r.frame_index += 1
    return res[RENDER_OUTPUT]


@pytest.mark.cuda
@pytest.mark.parametrize("rt_scale", [1, 2])
def test_captured_virtual_mesh_equals_eager_on_the_card(rt_scale):
    """On a card: a virtual mesh of 4 (card 0 named four times), fused and
    per_pass, captured at frame 1 and replayed after, equals the eager mesh
    frame and one card's over frames 0-3 with the camera moving; the warm-up
    and the capture make no synchronizing call; a replayed frame's launches
    and bytes between shards equal the eager frame's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from vulkanhybridrenderer_tpu_torch.ops import rasterizer_tiled as rt
    from vulkanhybridrenderer_tpu_torch.ops import traverse

    dev = torch.device("cuda", 0)
    sc = pproc.cornell_box()
    cfg = _config(rt_scale, 320, 176)
    one = Renderer(sc, cfg, device=dev)
    eager = Renderer(sc, cfg, mesh=pmesh.make_mesh([dev] * 4))
    caps = {m: Renderer(sc, cfg, mesh=pmesh.make_mesh([dev] * 4), dispatch=m,
                        auto_precompile=False) for m in ("fused", "per_pass")}
    for r in caps.values():  # the set-up reads back (the host BVH build, check_binning)
        r._consts()
        prev = (r._prev_view, r._prev_proj)
        r.check_binning()
        r._prev_view, r._prev_proj = prev
        r._binning_checked = True
    counted = {m: dispatch.counters(r.mesh) for m, r in caps.items()}
    counted["eager"] = dispatch.counters(eager.mesh)
    for f in range(4):
        for r in (one, eager, *caps.values()):
            _step(r, f)
        want = one.render_frame()
        before = dispatch.snapshot(counted["eager"])
        got = {"eager": _eager_cuda(eager)}
        torch.cuda.synchronize()
        per = {"eager": dispatch.delta(before, dispatch.snapshot(counted["eager"]))}
        for m, r in caps.items():
            before = dispatch.snapshot(counted[m])
            if f < 2:
                torch.cuda.set_sync_debug_mode("error")
            try:
                got[m] = r.render_frame(sync=False)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            per[m] = dispatch.delta(before, dispatch.snapshot(counted[m]))
            assert r._captured.captured == (f >= 1)
            assert r._captured.n_graphs == (1 if m == "fused"
                                            else len(r.graph.find_execution_order()))
        for m, img in got.items():
            assert torch.equal(img, want), (f, m)
        if f >= 2:  # replayed frames count what an eager frame counts
            for m in caps:
                assert per[m] == per["eager"], (f, m, per[m], per["eager"])
    assert rt.raster_tiles.launches > 0 and sum(traverse.trace.launches.values()) > 0
