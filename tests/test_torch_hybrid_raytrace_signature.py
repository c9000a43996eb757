"""``ops/raygen.hybrid_raytrace`` called as the reference's is:
``(scene, tables, tri_rows, bvh, tri_verts, pfd, depth, normal_oid)`` by
position, with ``settings`` left at None, which traces shadows, AO and
reflections (the reference's ``ops/raygen.py:243-251``).

Inputs: cornell_box at 32x32, frame 1 (frame 0's RNG seed is degenerate),
the port's G-buffer depth and normals fed to both packages, both packages'
BVH8 of the native SAH tree (rows equal).  Tolerance: that of
``test_torch_hybrid.py``, 1e-4 on >= 99.9% of pixels; the reference runs
eagerly here.  ~20 s alone, most of it the reference's walks.
"""
import dataclasses

import numpy as np
import torch
import jax.numpy as jnp

from vulkanhybridrenderer_tpu import native_bridge as jnative
from vulkanhybridrenderer_tpu.core import types as jtypes
from vulkanhybridrenderer_tpu.ops import bvh as jbvh
from vulkanhybridrenderer_tpu.ops import bvh8 as jbvh8
from vulkanhybridrenderer_tpu.ops import geometry as jgeo
from vulkanhybridrenderer_tpu.ops import raygen as jraygen
from vulkanhybridrenderer_tpu.ops import shadetab as jtab
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.core import config as pcfg
from vulkanhybridrenderer_tpu_torch.core import types as ptypes
from vulkanhybridrenderer_tpu_torch.models import hybrid as phybrid
from vulkanhybridrenderer_tpu_torch.ops import bvh8 as pbvh8
from vulkanhybridrenderer_tpu_torch.ops import geometry as pgeo
from vulkanhybridrenderer_tpu_torch.ops import raygen as praygen
from vulkanhybridrenderer_tpu_torch.ops import shadetab as ptab
from vulkanhybridrenderer_tpu_torch.runtime import renderer as prenderer

torch.set_num_threads(2)
W = H = 32


def _close(p, j):
    close = np.abs(p - j) <= 1e-4
    assert close.mean() >= 0.999, (close.mean(), np.abs(p - j).max())


def test_settings_none_traces_every_kind_as_reference():
    js = jproc.cornell_box()
    ps = bridge.scene_from_numpy(js.name, dataclasses.asdict(js.buffers),
                                 dataclasses.asdict(js.camera), dataclasses.asdict(js.light))
    pr = prenderer.Renderer(ps, pcfg.RenderConfig(width=W, height=H, alpha_raster="off"),
                            device="cpu")
    pr.frame_index = 1
    gbuf = pr.fetch_resources(phybrid.DEPTH, phybrid.NORMALS)
    depth, normals = gbuf[phybrid.DEPTH], gbuf[phybrid.NORMALS]
    assert (depth.numpy() > 0).mean() > 0.9  # the box fills the view

    view, proj = js.camera.view(), js.camera.projection(W / H)
    clip_m = (proj @ view).astype(np.float32)
    jworld = jgeo.to_world(js.buffers)
    jtris = jbvh.world_triangles(jworld.position, js.buffers.tri_vertex)
    jtabs = jtab.build_shade_tables(js.buffers)
    jrows = jtab.make_tri_rows(jtabs, js.buffers, jworld.position,
                               jgeo.to_clip(jworld.position, jnp.asarray(clip_m)))
    jb = jbvh8.build_bvh8_host(jnative.build_sah_host(np.asarray(jtris)), jtris, leaf_max=8)
    jpfd = jtypes.make_per_frame_data(view, proj, js.light, W, H, 1)
    j_ao, j_refl = jraygen.hybrid_raytrace(
        js.buffers, jtabs, jrows, jb, jtris, jpfd, jnp.asarray(depth.numpy()),
        jnp.asarray(normals.numpy()))

    pb = ps.buffers.to("cpu")
    pworld = pgeo.to_world(pb)
    ptris = torch.from_numpy(np.array(jtris))
    ptabs = ptab.build_shade_tables(pb)
    prows = ptab.make_tri_rows(ptabs, pb, pworld.position,
                               pgeo.to_clip(pworld.position, torch.from_numpy(clip_m)))
    pbvh = pbvh8.build_bvh8_sah_host(ptris.numpy())
    assert np.array_equal(pbvh.rows.numpy(), np.asarray(jb.rows))
    ppfd = ptypes.make_per_frame_data(view, proj, ps.light, W, H, 1)
    p_ao, p_refl = praygen.hybrid_raytrace(pb, ptabs, prows, pbvh, ptris, ppfd, depth, normals)

    j_ao, j_refl = np.asarray(j_ao), np.asarray(j_refl)
    p_ao, p_refl = p_ao.numpy(), p_refl.numpy()
    assert p_ao.shape == p_refl.shape == (4, H, W)
    _close(p_ao, j_ao)
    _close(p_refl, j_refl)
    # every kind was traced: some shadow and AO rays hit, some reflections shade
    lit = depth.numpy() > 0
    assert (p_ao[0][lit] < 1).any() and (p_ao[1][lit] < 1).any()
    assert (p_refl[:3] > 0).any()
    # given settings, the kinds no mode reads are not traced (the default
    # HybridSettings has AO off)
    off = pcfg.HybridSettings(denoise=False)
    p_off, _ = praygen.hybrid_raytrace(pb, ptabs, prows, pbvh, ptris, ppfd, depth, normals,
                                       settings=off)
    assert (p_off[1] == 1).all()  # AO not traced
