"""The lane-major tables K2 walks for bf16 and f32 leaf-12 BVH8s
(ops/traverse.pack_rows, csrc/bvh8_trace.cu's bvh8_trace_packed), read back
word by word as the kernel reads them and held against the reference's
``_decode_row`` of the same rows.

Tables: the host SAH BVH8s of cornell_box() and of the small SponzaProxy
(tests/test_hybrid_path.py's size) in both kinds, the bf16 one the
reference's table_to_bf16 of the f32 leaf-8 rows (its uint16 patterns
carried over by bridge.bvh8_from_numpy), the leaf-12 one the port's
(test_torch_bvh_leaf12.py holds it equal to the reference's).  For every
row, each lane's region holds: an internal row's slab planes at its two
slots (bit for bit), the first child row and the offset map as the
reference decodes them; a leaf row's vertex coordinates, after the
kernel's own arithmetic (a bf16 value plus the summed centroid, f32),
equal to _decode_row's, and its triangle ids; the flag word.  Then
kernel_table: one copy per table, kept while the rows are not written.
~10 s alone.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vulkanhybridrenderer_tpu.ops import bvh8 as jbvh8
from vulkanhybridrenderer_tpu.ops import geometry as jgeo
from vulkanhybridrenderer_tpu.ops import traverse as jtrav
from vulkanhybridrenderer_tpu.ops.bvh import world_triangles
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.ops import bvh8 as pbvh8
from vulkanhybridrenderer_tpu_torch.ops import traverse as ptrav

torch.set_num_threads(2)
SCENES = ("cornell", "sponza")
KINDS = ("bf16-8", "f32-12")


def _jax_scene(name):
    if name == "cornell":
        return jproc.cornell_box()
    return jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8)


@pytest.fixture(scope="module")
def tables():
    """(scene, kind) -> the port's BVH8 of that kind, its rows as the
    reference's jnp array."""
    out = {}
    for name in SCENES:
        js = _jax_scene(name)
        tris = np.asarray(world_triangles(jgeo.to_world(js.buffers).position,
                                          js.buffers.tri_vertex))
        p32 = pbvh8.build_bvh8_sah_host(tris)
        j32 = jbvh8.BVH8(rows=jnp.asarray(p32.rows.numpy()), child8=p32.child8.numpy(),
                         valid8=p32.valid8.numpy(), tri8=p32.tri8.numpy(), depth=p32.depth,
                         leaf_max=8)
        j16 = jbvh8.table_to_bf16(j32).rows
        p16 = bridge.bvh8_from_numpy(np.asarray(j16).view(np.uint16), p32.depth, 8)
        out[name, "bf16-8"] = (p16, j16)
        p12 = pbvh8.build_bvh8_sah_host(tris, leaf_max=12)
        out[name, "f32-12"] = (p12, jnp.asarray(p12.rows.numpy()))
    return out


def _f32(words):
    return words.contiguous().view(torch.float32)


def _region_reads(packed, kind):
    """What the kernel reads from each region c of each row: (internal
    planes (N, 8 slots, 6), base, offset map, flag word, leaf vertices
    (N, slots, 9), leaf ids (N, slots)), slots in the row's order (region
    c: internal slots 2c, 2c + 1; leaf slots 2c, 2c + 1 or c, c + 4, c + 8)."""
    n = packed.shape[0]
    w = ptrav.PACKED_WORDS[kind]
    reg = packed.reshape(n, w // 4, 4, 4).transpose(1, 2).reshape(n, 4, w)
    lo = lambda x: _f32(x << 16)  # noqa: E731  the bf16 in a word's low half
    hi = lambda x: _f32(x & -65536)  # noqa: E731
    inner = _f32(reg[:, :, 0:12]).reshape(n, 4, 6, 2).transpose(2, 3).reshape(n, 8, 6)
    base, offmap = reg[:, 0, 12], reg[:, 0, 13]
    same = (reg[:, :, 12:14] == reg[:, :1, 12:14]).all(dim=2).all(dim=1)
    if kind == "bf16-8":
        cen = _f32(reg[:, :, 11:14])  # (N, 4, 3)
        verts = torch.stack([torch.stack([f(reg[:, :, k]) + cen[:, :, k % 3]
                                          for k in range(9)], -1) for f in (lo, hi)],
                            dim=2).reshape(n, 8, 9)
        ids = reg[:, :, 9:11].reshape(n, 8)
    else:
        logical = torch.cat([reg[:, :, 0:15], reg[:, :, 16:31]], dim=2)  # skip w15
        # region c's slot j is c + 4j
        verts = _f32(logical[:, :, 0:27]).reshape(n, 4, 3, 9).transpose(1, 2).reshape(n, 12, 9)
        ids = logical[:, :, 27:30].transpose(1, 2).reshape(n, 12)
    flags = reg[:, :, 15]
    assert bool((flags == flags[:, :1]).all())
    # every lane of an internal row reads the same child base and offset map
    assert bool(same[flags[:, 0] == 0].all())
    return inner, base, offmap, flags[:, 0], verts, ids


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("scene", SCENES)
def test_packed_rows_read_as_reference_decodes(tables, scene, kind):
    p, jrows = tables[scene, kind]
    lm = p.leaf_max
    packed = ptrav.pack_rows(p.rows, lm)
    w = ptrav.PACKED_WORDS[kind]
    assert packed.dtype == torch.int32 and tuple(packed.shape) == (p.num_rows, 4 * w)
    assert packed.numel() * 4 == p.table_bytes  # the bytes of the table it copies
    rf, base, offmap, tri = (torch.from_numpy(np.array(a)) for a in jtrav._decode_row(jrows, lm))
    leaf = rf[:, 127] > 0.5
    inner, pbase, offmap_w, flag, verts, ids = _region_reads(packed, kind)
    assert torch.equal(flag, leaf.to(torch.int32))
    # internal rows: slab planes bit for bit, base, offset map
    i = ~leaf
    planes = torch.stack([rf[:, 8 * k:8 * k + 8] for k in range(6)], dim=-1)
    assert torch.equal(inner[i].view(torch.int32), planes[i].view(torch.int32))
    assert torch.equal(pbase[i], base[i])
    assert torch.equal(offmap_w[i], offmap[i])
    # leaf rows: the vertices as the kernel computes them, the ids
    vplanes = torch.stack([rf[:, lm * k:lm * k + lm] for k in range(9)], dim=-1)
    assert torch.equal(verts[leaf].view(torch.int32), vplanes[leaf].view(torch.int32))
    assert torch.equal(ids[leaf], tri[leaf])
    assert bool((ids[leaf] < 0).any())  # empty slots are -1


def test_kernel_table_cached_per_table(tables):
    p16, _ = tables["sponza", "bf16-8"]
    p12, _ = tables["sponza", "f32-12"]
    b16 = dataclasses.replace(p16, rows=p16.rows.clone())
    first = ptrav.kernel_table(b16)
    assert ptrav.kernel_table(b16) is first
    assert ptrav.kernel_table(dataclasses.replace(b16, depth=b16.depth + 1)) is first
    assert torch.equal(first, ptrav.pack_rows(b16.rows))
    # a write to the rows packs them anew
    b16.rows[0, 0] = b16.rows[0, 0]
    again = ptrav.kernel_table(b16)
    assert again is not first and torch.equal(again, first)
    assert torch.equal(ptrav.kernel_table(p12), ptrav.pack_rows(p12.rows, 12))
    # f32 leaf-8 rows are walked in place
    f8 = pbvh8.build_bvh8_sah_host(np.random.default_rng(0).random((40, 3, 3), np.float32))
    assert ptrav.kernel_table(f8) is f8.rows
    # the copy goes with its rows
    key = id(b16.rows)
    del b16
    assert key not in ptrav._PACKED
