"""Which BVH8 table the renderer traces: the port's Renderer._get_bvh
against the JAX renderer's (runtime/renderer.py:204-232), and a flagship
frame on bf16 rows against the JAX frame.

Both renderers get the same scene arrays (bridge.scene_from_numpy) and
build their host SAH trees natively, or, on the no-native route, their
LBVHs.  The table-size threshold is patched at run time on both modules
(the reference's VMEM_TABLE_BUDGET_BYTES, the port's TABLE_BUDGET_BYTES;
no file changes) to reach every branch on small scenes: the f32 leaf-8
table that fits; bf16 rows when the f32 table is past the budget and the
bf16 one is not, and when bvh_dtype is "bf16"; the leaf-12 table when both
leaf-8 tables are past it and it is not (cornell_box, whose leaf-12 table
is under half the leaf-8 one's rows), and the leaf-8 table when none fits;
build_bvh8_auto for bvh_dtype "f32" and for animated scenes (whose budget
is the one bound at definition, in both packages); an explicit leaf width,
in f32 or bf16.  Each case: the same kind (dtype, leaf width), the same
rows bit for bit (bf16 as uint16 patterns) and the same depth bound.

The frame: the full hybrid configuration (RT shadows, AO, reflections,
SVGF, alpha_raster="brute" with 4 peel rounds, 2 AO rays) of the small
SponzaProxy at 96x64 with bvh_dtype="bf16" on both packages, frames 0 and
1.  Tolerance: test_torch_hybrid_full.py's, 1e-4 on >= 99.9% of pixels
(measured: every pixel within 1e-5).  ~40 s alone, most of it the
reference's compile.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanhybridrenderer_tpu import native_bridge as jnative
from vulkanhybridrenderer_tpu.core import config as jcfg
from vulkanhybridrenderer_tpu.ops import bvh8 as jbvh8
from vulkanhybridrenderer_tpu.runtime import renderer as jrenderer
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch import native_bridge as pnative
from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.ops import bvh8 as pbvh8
from vulkanhybridrenderer_tpu_torch.runtime import renderer as prenderer

torch.set_num_threads(2)
W, H = 96, 64


def _jax_scene(name):
    if name == "cornell":
        return jproc.cornell_box()
    return jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8)


def _port_scene(js):
    return bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                   dataclasses.asdict(js.camera), dataclasses.asdict(js.light))


@pytest.fixture(scope="module")
def rows8():
    """scene -> (leaf-8 rows, leaf-12 rows) of its SAH tree."""
    out = {}
    for name in ("cornell", "sponza"):
        r = prenderer.Renderer(_port_scene(_jax_scene(name)), pcfg.RenderConfig(
            width=W, height=H, bvh_dtype="f32", bvh_leaf_max=8), device="cpu")
        r12 = prenderer.Renderer(_port_scene(_jax_scene(name)), pcfg.RenderConfig(
            width=W, height=H, bvh_dtype="f32", bvh_leaf_max=12), device="cpu")
        out[name] = (r._get_bvh().num_rows, r12._get_bvh().num_rows)
    return out


def _budget(which, n8, n12):
    """A table budget for the branch `which`."""
    return {"default": None,
            "f32 past, bf16 in": n8 * 512 - 1,
            "leaf-12 in": n12 * 512,
            "none in": min(n12 * 512, n8 * 256) - 1}[which]


#: (scene, bvh_dtype, bvh_leaf_max, animated, budget, the kind picked)
CASES = [
    ("sponza", "auto", 0, False, "default", ("f32", 8)),
    ("sponza", "auto", 0, False, "f32 past, bf16 in", ("bf16", 8)),
    ("cornell", "auto", 0, False, "f32 past, bf16 in", ("bf16", 8)),
    ("cornell", "auto", 0, False, "leaf-12 in", ("f32", 12)),
    ("sponza", "auto", 0, False, "none in", ("f32", 8)),
    ("cornell", "auto", 0, False, "none in", ("f32", 8)),
    ("sponza", "bf16", 0, False, "default", ("bf16", 8)),
    ("sponza", "f32", 0, False, "f32 past, bf16 in", ("f32", 8)),
    ("sponza", "auto", 0, True, "f32 past, bf16 in", ("f32", 8)),
    ("sponza", "auto", 8, False, "f32 past, bf16 in", ("f32", 8)),
    ("sponza", "f32", 12, False, "default", ("f32", 12)),
    ("sponza", "auto", 12, True, "default", ("f32", 12)),
    ("sponza", "bf16", 8, False, "default", ("bf16", 8)),
]


def _kind(rows):
    return "bf16" if str(rows.dtype).endswith("bfloat16") else "f32"


def _bits(p, j):
    """The port's and the reference's rows as comparable numpy arrays."""
    if p.rows.dtype == torch.bfloat16:
        return p.rows.view(torch.int16).numpy().view(np.uint16), np.asarray(j.rows).view(np.uint16)
    return p.rows.numpy(), np.asarray(j.rows)


def _both_bvh8(monkeypatch, name, dtype, leaf_max, animated, budget):
    if budget is not None:
        monkeypatch.setattr(jbvh8, "VMEM_TABLE_BUDGET_BYTES", budget)
        monkeypatch.setattr(pbvh8, "TABLE_BUDGET_BYTES", budget)
    js = _jax_scene(name)
    kw = dict(width=W, height=H, bvh_dtype=dtype, bvh_leaf_max=leaf_max, animated=animated)
    j = jrenderer.Renderer(js, jcfg.RenderConfig(**kw), path="hybrid")._get_bvh()
    p = prenderer.Renderer(_port_scene(js), pcfg.RenderConfig(**kw), device="cpu")._get_bvh()
    return j, p


@pytest.mark.parametrize("name, dtype, leaf_max, animated, which, want", CASES)
def test_get_bvh_picks_reference_table(monkeypatch, rows8, name, dtype, leaf_max, animated,
                                       which, want):
    j, p = _both_bvh8(monkeypatch, name, dtype, leaf_max, animated,
                      _budget(which, *rows8[name]))
    assert (_kind(p.rows), p.leaf_max) == (_kind(j.rows), j.leaf_max) == want
    got, ref = _bits(p, j)
    assert np.array_equal(got, ref)
    assert p.depth == j.depth


def test_get_bvh_no_native_route_bf16(monkeypatch, rows8):
    """Without the native build both renderers collapse their LBVH; past
    the patched budget both re-encode it in bf16, to the same rows."""
    monkeypatch.setattr(jnative, "native_available", lambda: False)
    monkeypatch.setattr(pnative, "native_available", lambda: False)
    j, p = _both_bvh8(monkeypatch, "sponza", "auto", 0, False, None)
    assert _kind(p.rows) == _kind(j.rows) == "f32"
    j, p = _both_bvh8(monkeypatch, "sponza", "auto", 0, False, p.num_rows * 512 - 1)
    assert _kind(p.rows) == _kind(j.rows) == "bf16"
    got, ref = _bits(p, j)
    assert np.array_equal(got, ref) and p.depth == j.depth


def _full(m):
    return m.HybridSettings(
        shadow_mode=m.ShadowMode.RAYTRACED, ao_mode=m.AmbientOcclusionMode.RAYTRACED,
        reflection_mode=m.ReflectionMode.RAYTRACED, denoise=True)


@pytest.fixture(scope="module")
def bf16_frames():
    js = _jax_scene("sponza")
    kw = dict(width=W, height=H, bvh_dtype="bf16", shadow_map_size=128, alpha_raster="brute",
              alpha_peel_rounds=4, ao_rays=2)
    jr = jrenderer.Renderer(js, jcfg.RenderConfig(hybrid=_full(jcfg), **kw), path="hybrid")
    # no pass reads the blue-noise stack; generating it takes minutes on a CPU
    jr._blue_noise = jnp.zeros((4, 128, 128, 4), jnp.float32)
    pr = prenderer.Renderer(_port_scene(js), pcfg.RenderConfig(hybrid=_full(pcfg), **kw),
                            device="cpu")
    assert pr._get_bvh().rows.dtype == torch.bfloat16
    return [(np.asarray(jr.render_frame()), pr.render_frame().numpy()) for _ in range(2)]


@pytest.mark.parametrize("frame", [0, 1])
def test_bf16_flagship_frame_matches_jax(bf16_frames, frame):
    j, p = bf16_frames[frame]
    assert p.shape == j.shape == (4, H, W)
    assert np.isfinite(p).all()
    close = np.abs(p - j).max(axis=0) <= 1e-4
    assert close.mean() >= 0.999, (close.mean(), np.abs(p - j).max())
    assert p[:3].std() > 0.01  # a real image, not a constant
