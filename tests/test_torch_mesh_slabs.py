"""The mesh's row slabs (``parallel/mesh.py``), port against port, no JAX.

The halo fetch and the gather against plain slicing of the whole image, at
N = 2, 4, 8 shards, H = 64 and 32 rows and halos of 0, 1, 6, 16 and 32 rows
(a halo may pass several slabs and is clipped at the image's edges), with
the bytes they move between shards.  Then an instrumented frame of the
flagship modes and of the raster modes over ``make_mesh([cpu] * 4)`` at
96x64: every image op (resolve, SVGF's temporal stage and a-trous
iterations, SSAO and its blur, SSR, the joint bilateral upsample,
composition, the raytrace pass's body) runs once per shard and computes
H/N rows of its image (H/(N s) at rt_scale s), never H; a halo read is
exactly the declared number of rows; the temporal state stays row-sharded
between frames, and the frame, ``fetch_resource`` and ``time_passes`` come
back whole on the primary.
"""
import dataclasses

import pytest
import torch

from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.graph.render_graph import (
    RENDER_OUTPUT,
    ROWS,
    WHOLE,
    RenderGraph,
    Step,
    halo,
)
from vulkanhybridrenderer_tpu_torch.ops import (
    composition,
    gbuffer,
    raygen,
    ssao,
    ssr,
    svgf,
    upsample,
)
from vulkanhybridrenderer_tpu_torch.ops.screen import Rows
from vulkanhybridrenderer_tpu_torch.parallel import mesh as pmesh
from vulkanhybridrenderer_tpu_torch.runtime.renderer import Renderer
from vulkanhybridrenderer_tpu_torch.scene import procedural as pproc

torch.set_num_threads(2)
CPU = torch.device("cpu")
W, H = 96, 64


def _image(h, c=3, w=5):
    return torch.arange(c * h * w, dtype=torch.float32).reshape(c, h, w)


@pytest.mark.parametrize("r", [0, 1, 6, 16, 32])
@pytest.mark.parametrize("h", [64, 32])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_halo_and_gather_against_slicing(n, h, r):
    mesh = pmesh.make_mesh([CPU] * n)
    img = _image(h)
    slabs = mesh.split(img)
    per = h // n
    assert [p.shape[-2] for p in slabs.parts] == [per] * n and slabs.height == h
    row_bytes = img[..., :1, :].numel() * 4
    for i in range(n):
        a, b = max(0, i * per - r), min(h, (i + 1) * per + r)
        assert mesh.rows(i, h).window(r) == (a, b)
        before = mesh.moved["halo"]
        got = mesh.fetch_halo(slabs, i, r)
        assert torch.equal(got, img[..., a:b, :])
        # only the rows other shards hold cross between shards
        assert mesh.moved["halo"] - before == (b - a - per) * row_bytes
        # the reads of Slabs and of the whole image agree
        for how, want in ((ROWS, img[..., i * per:(i + 1) * per, :]),
                          (halo(r), img[..., a:b, :]), (WHOLE, img)):
            assert torch.equal(mesh.read(slabs, how, i), want)
            assert torch.equal(mesh.read(img, how, i), want)
    before = mesh.moved["gather"]
    assert torch.equal(mesh.gather(slabs, "gather", to=n - 1), img)
    assert mesh.moved["gather"] - before == (h - per) * row_bytes


def test_rows_and_combine():
    """Rows' count and window; per-shard outputs become Slabs, a dataclass
    of them a dataclass of Slabs, and ``whole`` puts them back together
    (an object without Slabs is returned as it is)."""
    r = Rows(8, 16, 64)
    assert r.count == 8 and r.window(3) == (5, 19) and r.window(20) == (0, 36)
    assert Rows.whole(64) == Rows(0, 64, 64)
    mesh = pmesh.make_mesh([CPU] * 4)
    img = _image(64)
    assert pmesh._combine([None] * 4) is None
    parts = [dataclasses.replace(_state(16), shadow_ao_history=img[:2, 16 * i:16 * (i + 1)])
             for i in range(4)]
    combined = pmesh._combine(parts)
    assert isinstance(combined.moments_history, pmesh.Slabs)
    whole = mesh.whole(combined)
    assert torch.equal(whole.shadow_ao_history, img[:2])
    plain = _state(64)
    assert mesh.whole(plain) is plain


def _state(h):
    from vulkanhybridrenderer_tpu_torch.core.types import make_temporal_state

    return make_temporal_state(h, 5)


FULL = pcfg.HybridSettings(
    shadow_mode=pcfg.ShadowMode.RAYTRACED, ao_mode=pcfg.AmbientOcclusionMode.RAYTRACED,
    reflection_mode=pcfg.ReflectionMode.RAYTRACED, denoise=True)
RASTER = pcfg.HybridSettings(
    shadow_mode=pcfg.ShadowMode.RASTERIZED, ao_mode=pcfg.AmbientOcclusionMode.SSAO,
    reflection_mode=pcfg.ReflectionMode.SSR)
MODES = {"full": FULL, "full rt_scale 2": dataclasses.replace(FULL, rt_scale=2),
         "raster": RASTER}

# op -> (module, output rows of a call's result, the halo'd argument:
# (position, its halo in rows given the call) or None)
OPS = {
    "resolve_gbuffer": (gbuffer, lambda out: out.depth.shape[0], None),
    "raytrace_rows": (raygen, lambda out: out[0].shape[1], None),
    "temporal": (svgf, lambda out: out[0].shape[1], None),
    "atrous_iteration": (svgf, lambda out: out.shape[1], (0, lambda a, k: 2 * a[2])),
    "ssao": (ssao, lambda out: out.shape[0], None),
    "ssao_blur": (ssao, lambda out: out.shape[0], (0, lambda a, k: ssao.BLUR_RADIUS)),
    "ssr": (ssr, lambda out: out.shape[1], None),
    "joint_bilateral_upsample": (upsample, lambda out: out.shape[1], (0, None)),
    "compose": (composition, lambda out: out.shape[1], None),
}


def _instrument(monkeypatch):
    """Every call of the image ops: (op, rows, output rows, the halo'd
    argument's rows, the rows that argument should have)."""
    calls = []
    for name, (mod, out_rows, halo_arg) in OPS.items():
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, _out=out_rows, _halo=halo_arg, **k):
            out = _real(*a, **k)
            rows = k.get("rows")
            got = want = None
            if _halo is not None and rows is not None:
                pos, reach = _halo
                got = a[pos].shape[-2]
                if reach is None:  # the upsample: one low-resolution row past its slab's
                    s = a[1]
                    lo = Rows(rows.start // s, rows.stop // s, -(-rows.height // s))
                    first, last = lo.window(1)
                else:
                    first, last = rows.window(reach(a, k))
                want = last - first
            calls.append((_name, rows, _out(out), got, want))
            return out

        monkeypatch.setattr(mod, name, spy)
    return calls


@pytest.mark.parametrize("mode", list(MODES))
def test_every_image_op_runs_per_shard(mode, monkeypatch):
    n = 4
    settings = MODES[mode]
    cfg = pcfg.RenderConfig(width=W, height=H, shadow_map_size=128, alpha_raster="brute",
                            hybrid=settings)
    mesh = pmesh.make_mesh([CPU] * n)
    r = Renderer(pproc.cornell_box(), cfg, mesh=mesh)
    calls = _instrument(monkeypatch)
    frame = r.render_frame()
    assert frame.device == CPU and frame.shape == (4, H, W)
    trace_h = H // max(1, settings.rt_scale)
    trace_ops = {"raytrace_rows", "temporal", "atrous_iteration"}
    seen = {}
    for op, rows, out_rows, got, want in calls:
        grid = trace_h if op in trace_ops else H
        assert rows is not None and rows.height == grid, (op, rows)
        assert out_rows == rows.count == grid // n, (op, rows, out_rows)
        assert got == want, (op, rows, got, want)
        seen.setdefault(op, []).append(rows.start)
    # each op once a shard, in shard order; each a-trous iteration over every
    # shard before the next; the upsample twice a shard (shadows / AO, then
    # reflections)
    for op, starts in seen.items():
        per = (trace_h if op in trace_ops else H) // n
        shards = [i * per for i in range(n)]
        want = {"atrous_iteration": shards * 5,
                "joint_bilateral_upsample": [x for x in shards for _ in range(2)]}
        assert starts == want.get(op, shards), op
    if settings is RASTER:
        assert set(seen) == {"resolve_gbuffer", "ssao", "ssao_blur", "ssr", "compose"}
        assert mesh.moved["halo"] > 0 and mesh.moved["gather"] > 0
        return
    assert set(seen) == ({"resolve_gbuffer", "raytrace_rows", "temporal", "atrous_iteration",
                          "compose"} | ({"joint_bilateral_upsample"}
                                        if settings.rt_scale > 1 else set()))
    # the temporal state stays on the shards, its rows the trace slabs'
    state = r.temporal_state
    for f in dataclasses.fields(state):
        slabs = getattr(state, f.name)
        assert isinstance(slabs, pmesh.Slabs), f.name
        assert [p.shape[-2] for p in slabs.parts] == [trace_h // n] * n
    # frame 1 reads the previous state whole on every shard
    calls.clear()
    r.render_frame()
    assert [c[1].start for c in calls if c[0] == "temporal"] == [
        i * trace_h // n for i in range(n)]


def test_fetch_and_time_passes_whole_on_the_primary():
    """fetch_resource over a mesh returns whole images on the primary,
    equal to the single-device renderer's; time_passes times every pass of
    the mesh frame."""
    cfg = pcfg.RenderConfig(width=W, height=H, hybrid=FULL)
    one = Renderer(pproc.cornell_box(), cfg, device="cpu")
    meshed = Renderer(pproc.cornell_box(), cfg, mesh=pmesh.make_mesh([CPU] * 4))
    names = ("Depth", "Denoised Raytraced Shadows and Ambient Occlusion", "TemporalStateOut")
    a, b = one.fetch_resource(*names), meshed.fetch_resource(*names)
    for x, y in zip(a[:2], b[:2]):
        assert y.device == CPU and torch.equal(x, y)
    for f in dataclasses.fields(a[2]):
        assert torch.equal(getattr(a[2], f.name), getattr(b[2], f.name))
    timings = meshed.time_passes(iters=1)
    assert set(timings) == set(meshed.graph.find_execution_order())
    assert all(t > 0.0 for t in timings.values())


def test_shard_clock_times_each_pass_on_each_shard():
    """run_sharded with a ShardClock: each image pass's time on each shard
    (the host clock on the CPU)."""
    mesh = pmesh.make_mesh([CPU] * 4)
    cfg = pcfg.RenderConfig(width=W, height=H, hybrid=FULL)
    r = Renderer(pproc.cornell_box(), cfg, mesh=mesh)
    clock = pmesh.ShardClock(mesh)
    res = pmesh.run_sharded(r.graph, mesh, r._resources(r._make_pfd()), H, W, clock=clock)
    ms = clock.ms()
    assert set(ms) == {"G-Buffer Pass", "Raytrace Pass", "SVGF Denoise Pass",
                       "Composition Pass"}
    assert all(len(v) == 4 and min(v) > 0.0 for v in ms.values())
    assert isinstance(res["RENDER_OUTPUT"], pmesh.Slabs)


def _two_image_graph(step_fn=None):
    """A graph over the images "a" and "b": one pass of one step that reads
    "a" by rows (step_fn(res) -> its output), or without steps."""
    g = RenderGraph()
    if step_fn is None:
        g.add_pass("P", lambda res: {RENDER_OUTPUT: res["a"] + res["b"]}, inputs=("a", "b"),
                   outputs=(RENDER_OUTPUT,))
    else:
        g.add_pass("P", (Step(lambda res: {RENDER_OUTPUT: step_fn(res)}, {"a": ROWS}),),
                   inputs=("a", "b"), outputs=(RENDER_OUTPUT,))
    return g


def test_undeclared_image_read_raises_through_get():
    """A step that reads an image it does not declare raises, whether it
    reads it by [] or by .get (which takes a KeyError for a missing key); a
    name missing from the resources is still None through .get, and a
    resource that is not an image is the shard's replica."""
    mesh = pmesh.make_mesh([CPU] * 2)
    res = {"a": _image(H, w=W), "b": _image(H, w=W) + 1, "n": torch.ones(3)}
    for read in (lambda r: r.get("b"), lambda r: r["b"]):
        g = _two_image_graph(read)
        with pytest.raises(pmesh.UndeclaredRead, match="'b'"):
            pmesh.run_sharded(g, mesh, res, H, W)
    seen = []
    g = _two_image_graph(lambda r: seen.append((r.get("missing"), r["n"])) or r["a"])
    out = pmesh.run_sharded(g, mesh, res, H, W)
    assert seen == [(None, res["n"])] * 2
    assert torch.equal(mesh.whole(out[RENDER_OUTPUT]), res["a"])


def test_pass_without_steps_warns_where_it_gathers():
    """Over a mesh a pass registered as a function runs on the primary; where
    it reads a split image it warns and reads it gathered, and its frame
    equals the one-device run."""
    mesh = pmesh.make_mesh([CPU] * 4)
    res = {"a": _image(H, w=W), "b": _image(H, w=W) + 1}
    g = _two_image_graph()
    with pytest.warns(UserWarning, match="without steps reads the split images"):
        out = pmesh.run_sharded(g, mesh, res, H, W)
    assert torch.equal(out[RENDER_OUTPUT], g.run(res)[RENDER_OUTPUT])
