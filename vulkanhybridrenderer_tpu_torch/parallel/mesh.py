"""One frame over several devices (port of ``parallel/mesh.py``).

The reference shards a frame's pixel rows across a JAX device mesh: GSPMD
partitions the image passes, and two passes distribute their own work.
PyTorch has no GSPMD, so here the image passes run on the mesh's primary
device (its first) and the two passes that opt in, through ``res["mesh"]``,
split their work across the devices:

- ``rasterize_scene_sharded``, sort-last raster: each shard bins and
  rasters (K1a) 1/N of the triangles over the whole frame on its device,
  the partial frames are regrouped by row band (the reference's all_to_all,
  here device-to-device copies) and each band is depth-composited on its
  device with the single-device tie-break, then gathered on the primary.
- ``ops/raygen.hybrid_raytrace``, the raytrace pass's wavefronts one row
  slab per device (K2, ``ops/traverse.trace_rows``), the BVH8 replicated
  (``Mesh.replicate``), no exchange but the gather of the hits.

Where the shard count does not divide the rows, both passes run on the
primary alone and warn, as the reference's mesh falls back silently.

A mesh may name one device more than once: ``[torch.device("cpu")] * 8``
(the tests, as the reference's tests use 8 virtual CPU devices) or
``[torch.device("cuda", 0)] * 4``, a virtual mesh on one card.  Every shard
then runs on that device, one after another, and computes what a real mesh
computes.  Binning sizes its buffers by the true entry count, a host read,
so the shards' launches are issued one shard at a time even on distinct
cards.
"""
from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from vulkanhybridrenderer_tpu_torch.graph.render_graph import RENDER_OUTPUT
from vulkanhybridrenderer_tpu_torch.ops import rasterizer_tiled, shadetab
from vulkanhybridrenderer_tpu_torch.ops.rasterizer import (
    TriangleSetup,
    VisibilityBuffer,
    triangle_setup,
)

ROW_AXIS = "sp"  # image rows (the "sequence/pixel" axis of the reference)


def canonical_device(d) -> torch.device:
    """torch.device(d), a CUDA device without an index given the current
    one, so that it compares equal to its tensors' devices."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A device mesh of one axis (ROW_AXIS).  `devices` is a numpy object
    array of torch.device (``devices.size`` shards, as the reference reads
    ``mesh.devices.size``); a device may repeat.  The first is the primary:
    the frame's resources live there."""

    def __init__(self, devices):
        devs = [canonical_device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty(len(devs), dtype=object)
        for i, d in enumerate(devs):
            self.devices[i] = d
        #: id(obj) -> {device: obj's copy there}, for the objects replicate()
        #: has copied; an entry goes when its object does
        self._replicas: dict[int, dict] = {}

    @property
    def primary(self) -> torch.device:
        return self.devices[0]

    def distinct(self) -> list[torch.device]:
        """The mesh's devices without repeats, in mesh order."""
        return list(dict.fromkeys(self.devices.tolist()))

    def replicate(self, obj) -> list:
        """`obj` (anything with ``.to(device)`` whose tensors share one
        device) on each shard's device, in mesh order.  Each device gets one
        copy per object, kept while the object lives, so a static BVH8 is
        copied once and an animated scene's refit BVH8, a new object every
        frame, is copied again.  Where obj already lies it is obj itself."""
        own = canonical_device(next(t for t in _tensors(obj)).device)
        copies = self._replicas.get(id(obj))
        if copies is None:
            copies = {d: obj.to(d) for d in self.distinct() if d != own}
            self._replicas[id(obj)] = copies
            weakref.finalize(obj, self._replicas.pop, id(obj), None)
        return [obj if d == own else copies[d] for d in self.devices]


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def make_mesh(devices=None) -> Mesh:
    """A mesh over `devices`, by default every CUDA device.  Without a CUDA
    device there is no default: pass the devices (``[torch.device("cpu")]
    * 8`` for a CPU mesh)."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device (torch.cuda.device_count() is 0); "
                "pass the devices, e.g. make_mesh([torch.device('cpu')] * 8)"
            )
        devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh(devices)


def shard_image_resources(resources: dict, mesh: Mesh, height: int, width: int) -> dict:
    """The resources with every full-resolution image (a tensor whose last
    two dims are (height, width)) on the mesh's primary, where the image
    passes run.  The reference row-shards them (GSPMD); here only the
    raster and the raytrace pass distribute their work."""
    def place(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 2 and tuple(x.shape[-2:]) == (height, width):
            return x.to(mesh.primary)
        return x

    return {k: place(v) for k, v in resources.items()}


def make_sharded_frame_fn(graph, mesh: Mesh, height: int, width: int,
                          target: str = RENDER_OUTPUT, keep: tuple = ()):
    """The frame function of `graph` over `mesh`: runs every pass feeding
    `target` with ``res["mesh"] = mesh`` (the passes that opt in split
    their work across the mesh) and returns `target` and `keep`."""
    wanted = (target,) + tuple(keep)

    def frame_fn(resources: dict) -> dict:
        res = shard_image_resources(resources, mesh, height, width)
        res["mesh"] = mesh
        out = graph.run(res, target)
        return {k: out[k] for k in wanted}

    return frame_fn


# ---------------------------------------------------------------------------
# Triangle-sharded ("sort-last") rasterization
# ---------------------------------------------------------------------------
def _pad_setup(setup: TriangleSetup, pad: int) -> TriangleSetup:
    """`pad` rows of zeros (valid False) after the setup's triangles."""
    return TriangleSetup(**{
        f.name: torch.cat([getattr(setup, f.name), getattr(setup, f.name).new_zeros(
            (pad,) + tuple(getattr(setup, f.name).shape[1:]))])
        for f in dataclasses.fields(TriangleSetup)
    })


def rasterize_scene_sharded(scene, clip, width: int, height: int, mesh: Mesh,
                            alpha: bool = True, cull_backface: bool = True,
                            tables=None) -> VisibilityBuffer:
    """The binned raster over the mesh, sort-last: equal on every pixel to
    ``rasterizer_tiled.rasterize_scene`` with its default peel (below).

    The triangle setup runs once on the primary, its triangle dim padded
    to a multiple of the N shards (padding rows invalid).  Shard i bins its
    T/N triangles on its device (without the alpha-masked ones when they
    are peeled) and rasters them over the whole frame (K1a); its local ids
    become global (+ i * T/N).  Band j (rows j*H/N to (j+1)*H/N) of every
    partial frame goes to device j, which composites them in shard order:
    a partial takes a pixel where it has a triangle and is nearer (reverse-Z
    greater), or as near with a larger id, the single-device kernel's
    (z, id) maximum.  The bands are gathered on the primary.

    With alpha (and masked triangles in the scene) the masked stream is
    peeled once on the primary over the whole setup and merged, as in the
    reference, which calls its peel with the default 4 rounds and back-face
    culling whatever the configuration says; so does this.  As the
    reference's, each shard bins with the static cap of its own triangle
    count, and the composited depth is NaN-poisoned when any shard's binning
    overflowed (the sum of their overflows), the masked stream's after its
    merge."""
    n = mesh.devices.size
    if height % n:
        raise ValueError(f"rasterize_scene_sharded: {height} rows do not divide into "
                         f"{n} bands")
    setup = triangle_setup(clip, scene.tri_vertex, width, height)
    t = setup.planes.shape[0]
    opaque, use_alpha = rasterizer_tiled.opaque_include(scene, alpha)
    if opaque is None:
        opaque = torch.ones(t, dtype=torch.bool, device=setup.planes.device)
    pad = (-t) % n
    if pad:
        setup = _pad_setup(setup, pad)
        opaque = torch.cat([opaque, opaque.new_ones(pad)])
    per = (t + pad) // n

    partials = []
    overflow = torch.zeros(1, dtype=torch.int32, device=mesh.primary)
    for i, dev in enumerate(mesh.devices):
        rows = slice(i * per, (i + 1) * per)
        sub = TriangleSetup(**{f.name: getattr(setup, f.name)[rows].to(dev)
                               for f in dataclasses.fields(TriangleSetup)})
        bins = rasterizer_tiled.bin_triangles(sub, width, height, cull_backface=cull_backface,
                                              include=opaque[rows].to(dev))
        vis = rasterizer_tiled.raster_tiles(sub.planes, bins, width, height)
        overflow = overflow + bins.overflow.to(mesh.primary)
        tri = torch.where(vis.tri_id >= 0, vis.tri_id + i * per, -1)
        partials.append((vis.depth, tri, vis.bary))

    band = height // n
    bands = []
    for j, dev in enumerate(mesh.devices):
        rows = slice(j * band, (j + 1) * band)
        z, tri, bary = (a[rows].to(dev) for a in partials[0])
        for d_i, t_i, b_i in partials[1:]:
            d_i, t_i, b_i = d_i[rows].to(dev), t_i[rows].to(dev), b_i[rows].to(dev)
            take = (t_i >= 0) & ((d_i > z) | ((d_i == z) & (t_i > tri)))
            z = torch.where(take, d_i, z)
            tri = torch.where(take, t_i, tri)
            bary = torch.where(take[..., None], b_i, bary)
        bands.append((z, tri, bary))
    primary = mesh.primary
    vis = rasterizer_tiled.poison(VisibilityBuffer(
        tri_id=torch.cat([b[1].to(primary) for b in bands]),
        depth=torch.cat([b[0].to(primary) for b in bands]),
        bary=torch.cat([b[2].to(primary) for b in bands]),
    ), overflow)
    if use_alpha:
        if tables is None:
            tables = shadetab.build_shade_tables(scene)
        vis_m, overflow_m = rasterizer_tiled.rasterize_alpha_peeled(scene, setup, width,
                                                                    height, tables)
        vis = rasterizer_tiled.poison(rasterizer_tiled.merge_visibility(vis, vis_m),
                                      overflow_m)
    return vis
