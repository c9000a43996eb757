"""The statically sized passes read nothing back from their tensors.

A frame on one device is one CUDA graph, so no pass may size its work from
a value on the device.  On the CPU that shows as an operation whose result
is a host value or whose output's size depends on the data: this file runs
the brute raster (with and without the alpha fragment mask), the brute
shadow-map prepass and the shadow grid's rebuild at a given resolution
under a TorchDispatchMode that raises on such operations.  No JAX: only the
port's own functions run here.  What the mode cannot see: a read that does
not dispatch an operation (``Tensor.tolist`` on a CPU tensor).
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vulkanhybridrenderer_tpu_torch.ops import bvh, gbuffer, geometry, rasterizer, shadowgrid
from vulkanhybridrenderer_tpu_torch.ops import shadowmap
from vulkanhybridrenderer_tpu_torch.scene import procedural

torch.set_num_threads(2)
W, H = 64, 48
aten = torch.ops.aten
#: a host value out, or an output sized by the data
HOST_READS = {aten._local_scalar_dense, aten.nonzero, aten.masked_select, aten.equal,
              aten.is_nonzero, aten.bincount, aten._unique, aten._unique2, aten.unique_dim,
              aten.unique_consecutive, aten.histc}
#: sized by the data when an index is a mask
MASK_INDEXED = {aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_}


class HostRead(AssertionError):
    pass


class NoHostReads(TorchDispatchMode):
    """Raises HostRead at the first operation that reads the device back."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = func.overloadpacket
        masked = op in MASK_INDEXED and any(
            isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
            for i in (args[1] if len(args) > 1 else ()) if i is not None)
        sized = op is aten.repeat_interleave and kwargs.get("output_size") is None
        if op in HOST_READS or masked or sized:
            raise HostRead(f"{func} reads the device back")
        return func(*args, **kwargs)


def _clip(scene, light=False, prim_transform=None):
    world = geometry.to_world(scene.buffers.to("cpu"), prim_transform)
    vp = (scene.light.projview if light
          else scene.camera.projection(aspect=W / H) @ scene.camera.view())
    return world, geometry.to_clip(world.position,
                                   torch.tensor(np.asarray(vp, np.float32)))


GUARD_CASES = {
    "mask index": lambda t: t[t > 1],
    "item": lambda t: int(t[0]),
    "bool": lambda t: bool((t > 1).any()),
    "nonzero": lambda t: torch.nonzero(t),
    "bincount": lambda t: torch.bincount(t.long()),
    "repeat_interleave": lambda t: torch.repeat_interleave(t.long()),
}


@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_guard_catches(case):
    t = torch.arange(6, dtype=torch.float32)
    with pytest.raises(HostRead), NoHostReads():
        GUARD_CASES[case](t)
    with NoHostReads():  # and lets sized work through
        torch.repeat_interleave(t.long(), 2, output_size=12)
        torch.sort(t, stable=True)
        torch.searchsorted(t, t)


@pytest.mark.parametrize("cull", [True, False], ids=["cull", "no-cull"])
def test_brute_raster(cull):
    scene = procedural.cornell_box()
    _, clip = _clip(scene)
    setup = rasterizer.triangle_setup(clip, scene.buffers.to("cpu").tri_vertex, W, H)
    with NoHostReads():
        vis = rasterizer.rasterize(setup, W, H, chunk=16, cull_backface=cull)
    assert bool((vis.tri_id >= 0).any())


def test_brute_raster_with_alpha_mask():
    scene = procedural.checker_quad(alpha_leaf=True)
    _, clip = _clip(scene)
    setup = rasterizer.triangle_setup(clip, scene.buffers.to("cpu").tri_vertex, W, H)
    mask = gbuffer.make_alpha_frag_mask(scene.buffers.to("cpu"))  # the tables: load time
    with NoHostReads():
        vis = rasterizer.rasterize(setup, W, H, chunk=3, frag_mask_fn=mask)
    assert bool((vis.tri_id >= 0).any())


def test_brute_shadow_map():
    scene = procedural.cornell_box()
    _, clip = _clip(scene, light=True)
    with NoHostReads():
        depth = shadowmap.render_shadow_map(clip, scene.buffers.to("cpu").tri_vertex, 96,
                                            chunk=256)
    assert bool((depth > 0).any())


def test_shadow_grid_rebuild():
    """The in-frame rebuild: pica_proxy's moved triangles at the load-time
    resolution, the light direction a device tensor."""
    scene = procedural.pica_proxy()
    light = torch.tensor(np.asarray(scene.light.direction[:3], np.float32))
    world, _ = _clip(scene)
    grid = shadowgrid.build_shadow_grid(
        bvh.world_triangles(world.position, scene.buffers.to("cpu").tri_vertex), light).grid
    for t in (0.25, 0.5):
        moved, _ = _clip(scene, prim_transform=torch.from_numpy(
            procedural.animate_pica(scene, t)))
        tris = bvh.world_triangles(moved.position, scene.buffers.to("cpu").tri_vertex)
        with NoHostReads():
            sg = shadowgrid.build_shadow_grid(tris, light, grid=grid)
        assert int(sg.offsets[-1]) > 0 and int(sg.overflow) == 0
