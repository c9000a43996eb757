"""The port's frame over a CPU mesh (``Renderer(mesh=make_mesh([cpu] * N))``)
against its single-device frame: equal on every pixel.

The mesh row-shards every path's image passes (each shard computes its
slab, with the halo and gather exchanges each pass declares), splits the
raster (sort-last, K1a per shard) and computes each pixel, each ray, as the
single-device frame does, so the frames are exactly equal: the flagship
modes (RT shadows, AO and reflections, SVGF, the temporal state row-sharded
between frames) on cornell_box at 96x64 over 2, 4 and 8 shards, frames 0-2,
at rt_scale 1 and 2; the raster modes (the shadow-map prepass and the PCF,
SSAO and its blur, SSR) likewise; a height the shards do not divide (each
pass then runs on the primary and warns); the raytrace pass alone
(``hybrid_raytrace(mesh=)``) against ``mesh=None``, with K2 called once
per slab and wavefront; and the other paths and modes a mesh reaches (the
alpha peel on the small SponzaProxy, the forward path at one sample and
supersample, the rayquery path, the raytraced path with and without
test_alpha, an animated scene whose refit BVH8 each frame's slabs
trace).  Coverage MSAA on a mesh raises, as in the reference.  No JAX:
test_torch_mesh_jax.py and test_torch_mesh_jax_raster.py hold the mesh
frame against the JAX package's.
"""
import dataclasses
import functools
import gc

import pytest
import torch

from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.graph.render_graph import RENDER_OUTPUT
from vulkanhybridrenderer_tpu_torch.models import hybrid as hybrid_path
from vulkanhybridrenderer_tpu_torch.ops import bvh8, raygen, traverse
from vulkanhybridrenderer_tpu_torch.parallel import mesh as pmesh
from vulkanhybridrenderer_tpu_torch.runtime.renderer import Renderer
from vulkanhybridrenderer_tpu_torch.scene import procedural as pproc

torch.set_num_threads(2)
W, H = 96, 64
CPU = torch.device("cpu")
FULL = pcfg.HybridSettings(
    shadow_mode=pcfg.ShadowMode.RAYTRACED, ao_mode=pcfg.AmbientOcclusionMode.RAYTRACED,
    reflection_mode=pcfg.ReflectionMode.RAYTRACED, denoise=True)


def cpu_mesh(n=8):
    return pmesh.make_mesh([CPU] * n)


RASTER = pcfg.HybridSettings(
    shadow_mode=pcfg.ShadowMode.RASTERIZED, ao_mode=pcfg.AmbientOcclusionMode.SSAO,
    reflection_mode=pcfg.ReflectionMode.SSR)


@functools.cache
def single_frames(settings):
    """Frames 0-2 of `settings` on cornell_box on one device."""
    r = Renderer(pproc.cornell_box(), _config(settings), device="cpu")
    return [r.render_frame() for _ in range(3)]


def _config(settings):
    return pcfg.RenderConfig(width=W, height=H, alpha_raster="brute", alpha_peel_rounds=4,
                             shadow_map_size=128, hybrid=settings)


@functools.cache
def mesh_frames(settings, n):
    """Frames 0-2 over a CPU mesh of n shards, and the temporal state's
    type after each."""
    r = Renderer(pproc.cornell_box(), _config(settings), mesh=cpu_mesh(n))
    out = []
    for _ in range(3):
        out.append((r.render_frame(), type(r.temporal_state.shadow_ao_history)))
    return out


@pytest.mark.parametrize("frame", [0, 1, 2])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("rt_scale", [1, 2])
def test_flagship_mesh_frame_equals_single_device(rt_scale, n, frame):
    """The flagship modes: the temporal state row-sharded from frame 0 on,
    and each frame equal to one device's."""
    settings = dataclasses.replace(FULL, rt_scale=rt_scale)
    one = single_frames(settings)[frame]
    mesh, state = mesh_frames(settings, n)[frame]
    assert mesh.device == CPU and mesh.shape == (4, H, W)
    assert state is pmesh.Slabs
    assert torch.equal(one, mesh)
    assert one[:3].std() > 0.01  # a real image


@pytest.mark.parametrize("n", [2, 4, 8])
def test_raster_mode_mesh_frame_equals_single_device(n):
    """Rasterized shadows (the prepass and the PCF), SSAO and its blur, SSR:
    frames 0-2 equal to one device's."""
    for one, (mesh, _) in zip(single_frames(RASTER), mesh_frames(RASTER, n)):
        assert torch.equal(one, mesh)
    assert one[:3].std() > 0.01


def test_undivided_rows_warn_and_equal():
    """60 rows over 8 shards: every image pass runs on the primary alone and
    says so, and the frames equal one device's."""
    cfg = pcfg.RenderConfig(width=W, height=60, hybrid=FULL)
    one = Renderer(pproc.cornell_box(), cfg, device="cpu")
    meshed = Renderer(pproc.cornell_box(), cfg, mesh=cpu_mesh())
    for _ in range(2):
        with pytest.warns(UserWarning) as caught:
            got = meshed.render_frame()
        assert torch.equal(one.render_frame(), got)
    said = {str(w.message).split(":")[0] for w in caught if "do not divide" in str(w.message)}
    assert said == {"rasterize_for_path", "G-Buffer Pass", "Raytrace Pass", "SVGF Denoise Pass",
                    "Composition Pass"}


def _raytrace_case(rt_scale):
    """(config, hybrid_raytrace's positional arguments) of frame 1 of the
    flagship modes on cornell_box."""
    cfg = pcfg.RenderConfig(width=W, height=H, hybrid=dataclasses.replace(FULL, rt_scale=rt_scale))
    r = Renderer(pproc.cornell_box(), cfg, device="cpu")
    r.render_frame()
    depth_name, normals_name = ((hybrid_path.RT_DEPTH, hybrid_path.RT_NORMALS) if rt_scale > 1
                                else (hybrid_path.DEPTH, hybrid_path.NORMALS))
    res = r.fetch_resources("scene", "shade_tables", "TriRows", "BVH", "pfd", depth_name,
                            normals_name)
    return cfg, (res["scene"], res["shade_tables"], res["TriRows"], res["BVH"], None,
                 res["pfd"], res[depth_name], res[normals_name])


@pytest.mark.parametrize("rt_scale", [1, 2])
def test_hybrid_raytrace_slabs(rt_scale, monkeypatch):
    """hybrid_raytrace(mesh=) gives mesh=None's outputs exactly; K2 runs
    once per slab and wavefront, each slab 1/8 of the trace's rows (AO: its
    rows from both rays' blocks), slab after slab: each slab's shadow, AO
    and reflection rays are made, traced and shaded on its shard."""
    cfg, args = _raytrace_case(rt_scale)
    depth = args[6]
    want = raygen.hybrid_raytrace(*args, ao_rays=cfg.ao_rays, settings=cfg.hybrid)
    calls = []
    trace = traverse.trace

    def spy(bvh, tri_verts, origin, *a, **k):
        calls.append((origin.shape[0], k["anyhit"]))
        return trace(bvh, tri_verts, origin, *a, **k)

    spy.launches = trace.launches  # trace's body counts into `trace.launches`

    monkeypatch.setattr(traverse, "trace", spy)
    got = raygen.hybrid_raytrace(*args, ao_rays=cfg.ao_rays, settings=cfg.hybrid,
                                 mesh=cpu_mesh())
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    slab = depth.numel() // 8
    assert calls == [(slab, True), (2 * slab, True), (slab, False)] * 8


def test_hybrid_raytrace_undivided_rows_warns(monkeypatch):
    """Over 3 shards the 64 trace rows do not divide: as in the reference,
    each wavefront is traced whole on the primary, mesh=None's outputs, and
    the pass warns that it did so."""
    cfg, args = _raytrace_case(1)
    want = raygen.hybrid_raytrace(*args, ao_rays=cfg.ao_rays, settings=cfg.hybrid)
    calls = []
    trace = traverse.trace

    def spy(bvh, tri_verts, origin, *a, **k):
        calls.append(origin.shape[0])
        return trace(bvh, tri_verts, origin, *a, **k)

    spy.launches = trace.launches
    monkeypatch.setattr(traverse, "trace", spy)
    with pytest.warns(UserWarning, match="64 trace rows do not divide over the mesh's 3 shards"):
        got = raygen.hybrid_raytrace(*args, ao_rays=cfg.ao_rays, settings=cfg.hybrid,
                                     mesh=cpu_mesh(3))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert calls == [W * H, cfg.ao_rays * W * H, W * H]


def _frames(scene_fn, cfg, path="hybrid", frames=2, before=None):
    """`frames` frames from a single-device renderer and a mesh renderer;
    before(renderer, i) runs before frame i."""
    out = []
    for kwargs in ({"device": "cpu"}, {"mesh": cpu_mesh()}):
        r = Renderer(scene_fn(), cfg, path=path, **kwargs)
        imgs = []
        for i in range(frames):
            if before is not None:
                before(r, i)
            imgs.append(r.render_frame())
        out.append(imgs)
    return list(zip(*out))


SMALL_SPONZA = functools.partial(pproc.sponza_proxy, columns=3, segments=6, extra_boxes=12,
                                 grid_res=8)
MODES = {
    # the alpha-masked stream peeled after the sort-last composite
    "sponza full, alpha peeled": (SMALL_SPONZA, pcfg.RenderConfig(
        width=W, height=H, alpha_raster="brute", hybrid=FULL), "hybrid"),
    # the shadow-map prepass (128 rows over 8 shards) and the G-buffer sharded
    "cornell rasterized shadows, SSAO, SSR": (pproc.cornell_box, pcfg.RenderConfig(
        width=W, height=H, shadow_map_size=128, hybrid=pcfg.HybridSettings(
            shadow_mode=pcfg.ShadowMode.RASTERIZED, ao_mode=pcfg.AmbientOcclusionMode.SSAO,
            reflection_mode=pcfg.ReflectionMode.SSR)), "hybrid"),
    # supersample: the raster at 192x128, each shard's 16 raster rows box
    # filtered into its 8 output rows
    "sponza forward, supersample 4": (SMALL_SPONZA, pcfg.RenderConfig(
        width=W, height=H, shadow_map_size=128, forward=pcfg.ForwardSettings(
            msaa_samples=4, msaa_mode="supersample")), "forward"),
    "checker rayquery": (functools.partial(pproc.checker_quad, alpha_leaf=True),
                         pcfg.RenderConfig(width=W, height=H), "rayquery"),
    # each shard traces its slab's primary and shadow rays through the
    # alpha filter, on the masked materials' tables
    "sponza raytraced, test_alpha": (SMALL_SPONZA, pcfg.RenderConfig(
        width=W, height=H, raytraced=pcfg.RaytracedSettings(test_alpha=True)), "raytraced"),
    "cornell raytraced": (pproc.cornell_box, pcfg.RenderConfig(width=W, height=H),
                          "raytraced"),
    # the raster's bands shaded where they lie; the shadow map on the primary
    "sponza forward, one sample": (SMALL_SPONZA, pcfg.RenderConfig(
        width=W, height=H, shadow_map_size=128), "forward"),
    # 60 rows do not divide over 8 shards: the single-device raster and trace
    "cornell full, 60 rows": (pproc.cornell_box, pcfg.RenderConfig(
        width=W, height=60, hybrid=FULL), "hybrid"),
}


@pytest.mark.filterwarnings("error:.*a pass without steps reads the split images")
@pytest.mark.parametrize("mode", list(MODES))
def test_mesh_modes_equal_single_device(mode):
    """Frames 0-1 equal one device's; every pass that reads a split image
    has steps (the warning that one without read them is an error)."""
    scene_fn, cfg, path = MODES[mode]
    for one, mesh in _frames(scene_fn, cfg, path):
        assert torch.equal(one, mesh)


def test_animated_mesh_frame_equals_single_device():
    """pica_proxy animated (its BVH8 refit every frame, a new object whose
    replica each frame's slabs trace): frames 1-2 equal."""
    cfg = pcfg.RenderConfig(width=W, height=H, animated=True, hybrid=FULL)
    scene = pproc.pica_proxy()
    frames = _frames(lambda: scene, cfg, frames=3,
                     before=lambda r, i: r.animate(pproc.animate_pica(scene, i / 4)))
    for one, mesh in frames:
        assert torch.equal(one, mesh)
    assert not torch.equal(frames[1][0], frames[2][0])


def test_coverage_msaa_on_a_mesh_raises():
    """Coverage MSAA is single-device: the renderer refuses it on a mesh at
    construction, naming supersample, and so does the forward pass."""
    cfg = pcfg.RenderConfig(width=W, height=H, shadow_map_size=64,
                            forward=pcfg.ForwardSettings(msaa_samples=4, msaa_mode="coverage"))
    with pytest.raises(ValueError, match="supersample"):
        Renderer(pproc.cornell_box(), cfg, path="forward", mesh=cpu_mesh())
    r = Renderer(pproc.cornell_box(), cfg, path="forward", device="cpu")
    with pytest.raises(NotImplementedError, match="supersample"):
        r.graph.run({**r._resources(r._make_pfd()), "mesh": cpu_mesh()})
    # supersample is taken
    Renderer(pproc.cornell_box(), dataclasses.replace(
        cfg, forward=pcfg.ForwardSettings(msaa_samples=4, msaa_mode="supersample")),
        path="forward", mesh=cpu_mesh())


def test_renderer_device_and_frame_fn():
    """The renderer's device is the mesh's primary (another raises);
    make_sharded_frame_fn returns RENDER_OUTPUT (whole, on the primary) and
    the kept resources (the temporal state row-sharded), the frame equal to
    the graph run over the mesh; shard_image_resources splits each image
    into row slabs and leaves the rest."""
    mesh = cpu_mesh(4)
    cfg = pcfg.RenderConfig(width=W, height=H, hybrid=FULL)
    r = Renderer(pproc.cornell_box(), cfg, mesh=mesh)
    assert r.device == mesh.primary == CPU and r.mesh is mesh
    assert Renderer(pproc.cornell_box(), cfg, mesh=mesh, device="cpu").device == CPU
    with pytest.raises(ValueError, match="primary"):
        Renderer(pproc.cornell_box(), cfg, mesh=pmesh.make_mesh(["meta", CPU]), device="cpu")
    resources = r._resources(r._make_pfd())
    fn = pmesh.make_sharded_frame_fn(r.graph, mesh, H, W, RENDER_OUTPUT,
                                     keep=("TemporalStateOut",))
    out = fn(resources)
    assert set(out) == {RENDER_OUTPUT, "TemporalStateOut"}
    assert out[RENDER_OUTPUT].device == CPU and out[RENDER_OUTPUT].shape == (4, H, W)
    assert isinstance(out["TemporalStateOut"].shadow_ao_history, pmesh.Slabs)
    assert torch.equal(out[RENDER_OUTPUT], r.graph.run(resources)[RENDER_OUTPUT])
    img = torch.arange(4 * H * W, dtype=torch.float32).reshape(4, H, W)
    placed = pmesh.shard_image_resources({"img": img, "n": 3}, mesh, H, W)
    assert isinstance(placed["img"], pmesh.Slabs) and placed["n"] == 3
    assert [p.device for p in placed["img"].parts] == [CPU] * 4
    assert [torch.equal(p, img[:, i * H // 4:(i + 1) * H // 4])
            for i, p in enumerate(placed["img"].parts)] == [True] * 4


def test_replicate_copies_once_per_object_and_device():
    """Mesh.replicate: the object itself where it lies, one copy per other
    device shared by the shards there, the same copies on the next call, and
    the entry gone with the object (an animated scene's refit BVH8 is a new
    object each frame)."""
    mesh = pmesh.make_mesh([CPU, "meta", CPU, "meta"])
    b = bvh8.BVH8(rows=torch.zeros(4, 128), depth=3)
    reps = mesh.replicate(b)
    assert reps[0] is b and reps[2] is b and reps[1] is reps[3]
    assert reps[1].rows.device.type == "meta" and reps[1].depth == 3
    assert all(x is y for x, y in zip(mesh.replicate(b), reps))
    assert len(mesh._replicas) == 1
    del b, reps
    gc.collect()
    assert not mesh._replicas
