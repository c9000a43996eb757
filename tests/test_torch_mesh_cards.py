"""The frame over a mesh of every CUDA card (``make_mesh()``) against the
single-device frame, on a machine with two cards or more: the cross-card
route, each shard's K1a and K2 on its own card, every image pass of the
hybrid path a card over its row slab, the raster's bands, the halos and the
gathers moved between cards by device-to-device copies.

Marked ``cuda``: it skips where the machine has fewer than two cards (this
CPU-only build among them).  On a machine with several:

    python -m pytest tests/test_torch_mesh_cards.py -q -s --noconftest

(``--noconftest``: tests/conftest.py imports JAX for the other tests, and
the cards' machine need not have it.)

Checks: main path 8 (the flagship configuration on realglb at 1920x1080)
frames 1 and 2 equal (torch.equal) to one card's; every card of the mesh
launched its K1a shard and its K2 slabs; the temporal state's slabs lie on
their cards; after ``render_frame(sync=True)`` no card has queued work
left.  Cell 4's raster mode (rasterized shadows and the PCF, SSAO; then
with SSR) on realglb at 1920x1080: frames 1 and 2 equal to one card's.
Prints, for both, each pass's device ms on each card (CUDA events on the
card's stream, ``parallel/mesh.ShardClock``) beside one card's
``time_passes``, the bytes a frame moves between cards by kind, and
ms/frame of both renderers in turns (single, mesh, mesh, single; CUDA
events on the primary's stream, which waits for every card) with
nvidia-smi's name and power limit.  The mesh frame is captured into CUDA
graphs spanning every card (runtime/dispatch.py): paths 8 and 11 (the
animated pica, its refit BVH8 and rebuilt grid replicated to the cards
inside the graph), fused and per_pass, equal to the eager mesh frame and
one card's over frames 0-3 with the camera moving, the warm-up and the
capture making no synchronizing call and a replayed frame counting the
eager frame's launches and bytes.  No JAX.
"""
import collections
import dataclasses
import subprocess

import pytest
import torch

from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.graph.render_graph import RENDER_OUTPUT
from vulkanhybridrenderer_tpu_torch.ops import rasterizer_tiled, traverse
from vulkanhybridrenderer_tpu_torch.parallel import mesh as pmesh
from vulkanhybridrenderer_tpu_torch.runtime import app, dispatch
from vulkanhybridrenderer_tpu_torch.runtime.renderer import Renderer
from vulkanhybridrenderer_tpu_torch.scene import procedural

W, H = 1920, 1080


def _ms_per_frame(r, frames=10):
    """ms/frame of `frames` frames after 2 warm-up ones, by CUDA events on
    the primary's current stream."""
    for _ in range(2):
        r.render_frame()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(frames):
        r.render_frame(sync=False)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / frames


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def _report(label, one, meshed, mesh):
    """Print each pass's device ms on each card beside one card's
    time_passes, the bytes a frame moves between cards, and ms/frame of
    both renderers in turns."""
    res = meshed._resources(meshed._make_pfd())
    for _ in range(2):  # the second run timed
        clock = pmesh.ShardClock(mesh)
        pmesh.run_sharded(meshed.graph, mesh, res, H, W, clock=clock)
    per_card, single = clock.ms(), one.time_passes(iters=3)
    mesh.moved.clear()
    meshed.render_frame()
    moved = ", ".join(f"{k} {v / 1e6:.3f} MB" for k, v in sorted(mesh.moved.items()))
    ms = {"one": [], "mesh": []}
    for which in ("one", "mesh", "mesh", "one"):
        ms[which].append(_ms_per_frame(one if which == "one" else meshed))
    print(f"\n{label} over {mesh.devices.size} cards, ms/frame in turns (one, mesh, mesh, one): "
          f"one card {ms['one'][0]:.3f} / {ms['one'][1]:.3f}, mesh {ms['mesh'][0]:.3f} / "
          f"{ms['mesh'][1]:.3f}; bytes a frame between cards: {moved}")
    for name, cards in per_card.items():
        print(f"  {name}: device ms per card {' / '.join(f'{x:.3f}' for x in cards)}; one card "
              f"{single.get(name, float('nan')):.3f}")
    print(_smi())


def _mesh_or_skip():
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two CUDA cards or more; this machine has {n}")
    assert H % n == 0, f"{H} rows do not divide over {n} cards"
    return pmesh.make_mesh()


@pytest.mark.cuda
def test_flagship_over_every_card_equals_one_card(monkeypatch):
    mesh = _mesh_or_skip()
    n = mesh.devices.size
    cfg = pcfg.RenderConfig(width=W, height=H, alpha_raster="brute", hybrid=pcfg.HybridSettings(
        shadow_mode=pcfg.ShadowMode.RAYTRACED, ao_mode=pcfg.AmbientOcclusionMode.RAYTRACED,
        reflection_mode=pcfg.ReflectionMode.RAYTRACED, denoise=True))
    scene = app.load_any_scene("realglb")
    one = Renderer(scene, cfg, device="cuda:0")
    meshed = Renderer(scene, cfg, mesh=mesh)
    assert meshed.device == torch.device("cuda", 0)
    one.render_frame()
    meshed.render_frame()
    frames = [one.render_frame() for _ in range(2)]

    # each launch's card: K1a through rasterizer_tiled.launch, K2 through
    # traverse.trace, whose body counts into the module's `trace.launches`:
    # the stand-in carries the same Counter
    cards = collections.Counter()
    launch, trace = rasterizer_tiled.launch, traverse.trace

    def counted_launch(mode, planes, *args, **kwargs):
        cards[(mode, planes.device.index)] += 1
        return launch(mode, planes, *args, **kwargs)

    def counted_trace(bvh, tri_verts, origin, *args, **kwargs):
        cards[("K2", origin.device.index)] += 1
        return trace(bvh, tri_verts, origin, *args, **kwargs)

    counted_trace.launches = trace.launches

    monkeypatch.setattr(rasterizer_tiled, "launch", counted_launch)
    monkeypatch.setattr(traverse, "trace", counted_trace)
    mframes = [meshed.render_frame() for _ in range(2)]
    assert all(torch.cuda.current_stream(d).query() for d in mesh.distinct())
    monkeypatch.undo()
    for a, m in zip(frames, mframes):
        assert m.device == torch.device("cuda", 0)
        assert torch.equal(a, m), int((a != m).any(dim=0).sum())
    for i in range(n):
        # frame 1 is the capture, where the wrappers are called: a K1a shard
        # a frame, a K2 slab a wavefront (shadow, AO, reflection); frame 2
        # replays that graph, which calls no wrapper
        assert cards[("K1a", i)] == 1 and cards[("K2", i)] == 3, dict(cards)
    assert meshed._captured.captured and meshed._captured.n_graphs == 1
    # the temporal state stays on the cards, a slab each
    for f in ("shadow_ao_history", "moments_history", "prev_normal_oid"):
        parts = getattr(meshed.temporal_state, f).parts
        assert [p.device for p in parts] == list(mesh.devices), f
    print(f"\npath 8 frames 1-2 equal to one card's; launches by (kernel, card) {dict(cards)}")
    _report("path 8", one, meshed, mesh)


@pytest.mark.cuda
@pytest.mark.parametrize("ssr", [False, True], ids=["cell 4", "cell 4 with SSR"])
def test_raster_mode_over_every_card_equals_one_card(ssr):
    mesh = _mesh_or_skip()
    cfg = pcfg.RenderConfig(width=W, height=H, alpha_raster="off", hybrid=pcfg.HybridSettings(
        shadow_mode=pcfg.ShadowMode.RASTERIZED, ao_mode=pcfg.AmbientOcclusionMode.SSAO,
        reflection_mode=pcfg.ReflectionMode.SSR if ssr else pcfg.ReflectionMode.OFF))
    scene = app.load_any_scene("realglb")
    one = Renderer(scene, cfg, device="cuda:0")
    meshed = Renderer(scene, cfg, mesh=mesh)
    for i in range(3):
        a, m = one.render_frame(), meshed.render_frame()
        if i:
            assert m.device == torch.device("cuda", 0)
            assert torch.equal(a, m), int((a != m).any(dim=0).sum())
    _report("cell 4 with SSR" if ssr else "cell 4", one, meshed, mesh)


def _eager_frame(r):
    """One eager mesh frame of r (the mesh frame function, not the captured
    frame), advancing r as render_frame does."""
    res = r._frame_fn()(r._resources(r._make_pfd()))
    if r.path.uses_temporal_state:
        r.temporal_state = res["TemporalStateOut"]
    r.frame_index += 1
    return res[RENDER_OUTPUT]


def _full(**kw):
    return pcfg.RenderConfig(width=W, height=H, alpha_raster="brute", hybrid=pcfg.HybridSettings(
        shadow_mode=pcfg.ShadowMode.RAYTRACED, ao_mode=pcfg.AmbientOcclusionMode.RAYTRACED,
        reflection_mode=pcfg.ReflectionMode.RAYTRACED, denoise=True), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["path 8", "path 11"])
def test_captured_mesh_frame_over_every_card(case):
    """The mesh frame captured into CUDA graphs spanning every card, fused
    (one graph a frame) and per_pass (one a pass), against the eager mesh
    frame and one card's over frames 0-3, the camera moving between frames:
    path 8 (the flagship on realglb) and path 11 (pica_proxy animated a
    frame, its BVH8 refit and its shadow grid rebuilt in the frame, both
    replicated to the cards inside the graph).  The warm-up and the capture
    make no synchronizing call; a replayed frame's launches and bytes
    between cards equal the eager frame's; every frame after the capture is
    a replay."""
    mesh = _mesh_or_skip()
    if case == "path 8":
        scene, cfg, animate = app.load_any_scene("realglb"), _full(), None
    else:
        scene = procedural.pica_proxy()
        cfg = _full(shadow_accel="grid", animated=True)

        def animate(r, f):
            r.animate(procedural.animate_pica(r.scene, f / 60.0))
    one = Renderer(scene, cfg, device="cuda:0")
    eager = Renderer(scene, cfg, mesh=pmesh.make_mesh())
    caps = {m: Renderer(scene, cfg, mesh=pmesh.make_mesh(), dispatch=m, auto_precompile=False)
            for m in ("fused", "per_pass")}
    for r in (eager, *caps.values()):
        r._bvh = one._get_bvh()  # one host build, read in place on card 0
        prev = (r._prev_view, r._prev_proj)
        r.check_binning()  # reads its counts back: before the frames
        r._prev_view, r._prev_proj = prev
        r._binning_checked = True
        r._consts()
    counted = {m: dispatch.counters(r.mesh) for m, r in (("eager", eager), *caps.items())}
    for f in range(4):
        for r in (one, eager, *caps.values()):
            r.update_camera(1 / 30, keys={"w"} if f % 2 else {"a"})
            if animate is not None:
                animate(r, f)
        want = one.render_frame()
        got, per = {}, {}
        for m, r in (("eager", eager), *caps.items()):
            before = dispatch.snapshot(counted[m])
            if m != "eager" and f < 2:
                torch.cuda.set_sync_debug_mode("error")
            try:
                got[m] = _eager_frame(r) if m == "eager" else r.render_frame(sync=False)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            for d in mesh.distinct():
                torch.cuda.synchronize(d)
            per[m] = dispatch.delta(before, dispatch.snapshot(counted[m]))
        for m, img in got.items():
            assert img.device == torch.device("cuda", 0)
            assert torch.equal(img, want), (case, f, m, int((img != want).any(dim=0).sum()))
        for m, r in caps.items():
            cf = r._captured
            assert cf.captured == (f >= 1) and set(cf.others) == set(mesh.distinct()[1:])
            assert cf.n_graphs == (1 if m == "fused" else len(r.graph.find_execution_order()))
            if f >= 2:
                assert per[m] == per["eager"], (case, f, m, per[m], per["eager"])
    for m, r in caps.items():
        parts = r.temporal_state.shadow_ao_history.parts
        assert [p.device for p in parts] == list(mesh.devices), m
        print(f"\n{case} {m} over {mesh.devices.size} cards: frames 0-3 equal to the eager "
              f"mesh frame and one card's; capture s {r._captured.capture_s}; a replayed "
              f"frame moved {dict(per[m][-1])} | {_smi()}")


@pytest.mark.cuda
def test_key_switch_releases_every_card():
    """A renderer over every card holds one captured frame: switching its
    configuration (a viewer's slider, each value a config, captured per
    pass) releases the old frame's graphs and every card's pool, so the
    memory each card's caching allocator holds stays where the second
    value left it."""
    mesh = _mesh_or_skip()
    raster = pcfg.HybridSettings(shadow_mode=pcfg.ShadowMode.RASTERIZED,
                                 ao_mode=pcfg.AmbientOcclusionMode.SSAO)
    cfg = pcfg.RenderConfig(width=640, height=360, alpha_raster="off", hybrid=raster)
    r = Renderer(procedural.cornell_box(), cfg, mesh=mesh, dispatch="per_pass")
    reserved = []
    for i in range(6):
        ssao = dataclasses.replace(raster.ssao, radius=0.3 + 0.05 * i)
        r.set_config(dataclasses.replace(cfg, hybrid=dataclasses.replace(raster, ssao=ssao)))
        r.render_frame()
        assert r._captured.captured and len(r._captured.pools) == mesh.devices.size - 1
        reserved.append([torch.cuda.memory_reserved(d) for d in mesh.distinct()])
    for d, held in enumerate(zip(*reserved)):
        assert max(held[2:]) <= held[1], (d, held)
