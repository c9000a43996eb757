"""The forward, raytraced and rayquery paths over a CPU mesh of 8 shards
(``Renderer(mesh=make_mesh([cpu] * 8))``), instrumented: each path's image
passes are Steps, so each shard rasters its band (sort-last), traces its
slab's rays and shades its slab on its own device, as the reference's
GSPMD partitions its row-sharded frame.

Checks, at 96x64: ``primary_rays(rows=)`` equal to those rows of the whole
image's rays bit for bit; every pass of every path that reads a frame image
registered as Steps; each shard's ``traverse.trace`` calls carrying its
slab's W * H / 8 rays (raytraced: the primary closest-hit and the shadow
any-hit wavefronts, rayquery: its shadow rays), frames equal to one
device's; the raytraced and rayquery frames moving no halo or gather bytes
(``Mesh.moved``); the forward frame making no replica of the Shadow Map
and returning its output as 8 slabs of H / 8 rows, at supersample 4 from
bands of 2 H / 8 raster rows; 60 rows over 8 shards warning and equal to
one device.  No JAX (test_torch_mesh_jax_paths.py holds the raytraced and
rayquery mesh frames against the JAX package's); tolerance: none.
"""
import functools

import pytest
import torch

from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.graph.render_graph import RENDER_OUTPUT, pass_steps
from vulkanhybridrenderer_tpu_torch.models import raytraced as raytraced_path
from vulkanhybridrenderer_tpu_torch.ops import screen, traverse
from vulkanhybridrenderer_tpu_torch.parallel import mesh as pmesh
from vulkanhybridrenderer_tpu_torch.runtime.renderer import Renderer
from vulkanhybridrenderer_tpu_torch.scene import procedural as pproc

torch.set_num_threads(2)
W, H = 96, 64
N = 8
CPU = torch.device("cpu")
SMALL_SPONZA = functools.partial(pproc.sponza_proxy, columns=3, segments=6, extra_boxes=12,
                                 grid_res=8)
FULL = pcfg.HybridSettings(
    shadow_mode=pcfg.ShadowMode.RAYTRACED, ao_mode=pcfg.AmbientOcclusionMode.RAYTRACED,
    reflection_mode=pcfg.ReflectionMode.RAYTRACED, denoise=True)
SS4 = pcfg.ForwardSettings(msaa_samples=4, msaa_mode="supersample")
PATHS = {
    "raytraced, test_alpha": (SMALL_SPONZA, dict(
        raytraced=pcfg.RaytracedSettings(test_alpha=True)), "raytraced"),
    "rayquery": (functools.partial(pproc.checker_quad, alpha_leaf=True), {}, "rayquery"),
    "forward": (SMALL_SPONZA, dict(shadow_map_size=128), "forward"),
    "forward, supersample 4": (SMALL_SPONZA, dict(shadow_map_size=128, forward=SS4),
                               "forward"),
    "hybrid": (pproc.cornell_box, dict(alpha_raster="off", hybrid=FULL), "hybrid"),
}
#: passes that read no frame image: they run once, on the primary
STEPLESS = {"Geometry", "BVH", "BVH Refit", "Depth Prepass", "Shadow Grid Build"}


def _renderer(case, height=H, **kwargs):
    scene_fn, cfg_kw, path = PATHS[case]
    cfg = pcfg.RenderConfig(width=W, height=height, **cfg_kw)
    return Renderer(scene_fn(), cfg, path=path, **kwargs)


def _pair(case, height=H):
    return (_renderer(case, height, device="cpu"),
            _renderer(case, height, mesh=pmesh.make_mesh([CPU] * N)))


def test_primary_rays_of_rows_equal_the_whole_images_rows():
    """primary_rays(rows=) is bit for bit those rows of the whole image's
    rays: each of 8 slabs, an odd stretch, and a single row."""
    r = _renderer("raytraced, test_alpha", device="cpu")
    pfd = r._make_pfd()
    o, d = raytraced_path.primary_rays(pfd, H, W)
    assert o.shape == d.shape == (H * W, 3)
    spans = [(i * H // N, (i + 1) * H // N) for i in range(N)] + [(3, 40), (63, 64)]
    for a, b in spans:
        so, sd = raytraced_path.primary_rays(pfd, H, W, screen.Rows(a, b, H))
        assert torch.equal(so, o[a * W:b * W]) and torch.equal(sd, d[a * W:b * W]), (a, b)


@pytest.mark.parametrize("case", list(PATHS))
def test_image_passes_are_steps(case):
    """Every pass that reads a frame image is registered as Steps; the
    passes without them read none (coverage MSAA, single-device, aside)."""
    g = _renderer(case, device="cpu").graph
    order = g.find_execution_order()
    assert [n for n in order if not pass_steps(g.passes[n])] == [n for n in order
                                                                 if n in STEPLESS]
    assert set(order) - STEPLESS


@pytest.mark.parametrize("case, want", [
    ("raytraced, test_alpha", [(W * H // N, False), (W * H // N, True)] * N),
    ("rayquery", [(W * H // N, True)] * N),
])
def test_each_shard_traces_its_slab(case, want, monkeypatch):
    """Frame 1 over the mesh: K2 is called once per slab and wavefront,
    slab after slab, with the slab's W * H / 8 rays; the frame equals one
    device's and reads only its own rows: it moves no halo and no gather
    bytes between shards, only its raster's bands (rayquery), the replicas
    and the output."""
    one, meshed = _pair(case)
    one.render_frame()
    meshed.render_frame()
    calls = []
    trace = traverse.trace

    def spy(bvh, tri_verts, origin, *a, **k):
        calls.append((origin.shape[0], k.get("anyhit", False)))
        return trace(bvh, tri_verts, origin, *a, **k)

    spy.launches = trace.launches  # trace's body counts into `trace.launches`
    monkeypatch.setattr(traverse, "trace", spy)
    before = dict(meshed.mesh.moved)
    got = meshed.render_frame()
    moved = {k: v - before.get(k, 0) for k, v in meshed.mesh.moved.items()}
    assert calls == want
    assert torch.equal(one.render_frame(), got)
    assert moved.get("halo", 0) == 0 and moved.get("gather", 0) == 0, moved
    assert moved["output"] == 4 * H * W * 4 * (N - 1) // N
    assert (moved.get("raster", 0) > 0) == (case == "rayquery")


@pytest.mark.parametrize("case, band", [("forward", H // N),
                                        ("forward, supersample 4", 2 * H // N)])
def test_forward_slabs_without_a_shadow_map_replica(case, band, monkeypatch):
    """The forward frame over the mesh (run_sharded): no shard gets a
    replica of the Shadow Map, which forward_shade(shadow=None) does not
    read; the frame raster's bands are `band` rows (2 H / 8 at supersample
    4; the Depth Prepass's sort-last map is gathered whole) and the output
    is 8 slabs of H / 8 rows, equal to one device's frame."""
    one, meshed = _pair(case)
    mesh = meshed.mesh
    want = one.render_frame()
    replicated = []
    real = pmesh.Mesh.replicate

    def spy(self, obj):
        replicated.append(obj)
        return real(self, obj)

    monkeypatch.setattr(pmesh.Mesh, "replicate", spy)
    res = pmesh.run_sharded(meshed.graph, mesh, meshed._resources(meshed._make_pfd()), H, W)
    sm = res["Shadow Map"]
    assert tuple(sm.shape) == (128, 128)
    assert not any(x is sm for x in replicated)
    assert all(not isinstance(x, torch.Tensor) or x.shape != sm.shape for x in replicated)
    out = res[RENDER_OUTPUT]
    assert isinstance(out, pmesh.Slabs)
    assert [tuple(p.shape) for p in out.parts] == [(4, H // N, W)] * N
    assert torch.equal(mesh.whole(out), want)
    bands = []
    real_band = pmesh.rasterize_scene_bands

    def bands_spy(scene, clip, width, height, *a, **k):
        got = real_band(scene, clip, width, height, *a, **k)
        bands.append((width, [v.tri_id.shape[0] for v in got]))
        return got

    monkeypatch.setattr(pmesh, "rasterize_scene_bands", bands_spy)
    pmesh.run_sharded(meshed.graph, mesh, meshed._resources(meshed._make_pfd()), H, W)
    # the Depth Prepass's 128 x 128 map, then the frame's raster
    assert bands == [(128, [128 // N] * N), (W * band * N // H, [band] * N)]


@pytest.mark.parametrize("case, passes", [
    ("raytraced, test_alpha", {"Raytrace Pass", "Composition"}),
    ("rayquery", {"rasterize_for_path", "Rayquery Pass"}),
    ("forward", {"rasterize_for_path", "Forward Pass"}),
])
def test_undivided_rows_warn_and_equal(case, passes):
    """60 rows over 8 shards: each image pass runs on the primary alone and
    says so, and the frames equal one device's."""
    one, meshed = _pair(case, height=60)
    for _ in range(2):
        with pytest.warns(UserWarning) as caught:
            got = meshed.render_frame()
        assert torch.equal(one.render_frame(), got)
    said = {str(w.message).split(":")[0] for w in caught if "do not divide" in str(w.message)}
    assert said == passes
