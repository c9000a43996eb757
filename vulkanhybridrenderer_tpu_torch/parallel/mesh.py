"""One frame over several devices (port of ``parallel/mesh.py``).

The reference shards a frame's pixel rows across a JAX device mesh: every
image-shaped intermediate is row-sharded after every pass, and GSPMD
partitions the passes, inserting the exchanges they need.  PyTorch has no
GSPMD, so here the exchanges are explicit.  An image over the mesh is
``Slabs``: row slab i (rows i*H/N to (i+1)*H/N) on the mesh's device i.
Every pass of every path that reads a frame image is registered as a
sequence of steps (``graph.render_graph.Step``); over a mesh each runs
once per shard on the shard's device over its slab (``Rows``), reading
each image one of three ways, as the step declares, the explicit form of
what GSPMD inserts:

- ``ROWS``: the shard's own rows, no exchange (the hybrid path's resolve,
  raygen and hit shading, RT downsample and composition; the rayquery
  and forward paths' resolve and shading of their raster's bands; the
  raytraced path's blit);
- ``halo(r)``: its rows and the r rows above and below them, fetched from
  whichever shards hold them and clipped at the image's edges (SVGF's
  a-trous, 2 s rows at step s; the SSAO blur, 6; the joint bilateral
  upsample, 1 low-resolution row);
- ``WHOLE``: the whole image gathered on the shard (SSAO's depth, SSR's
  images, SVGF's previous state).

A step may read no image (the raytraced path's Raytrace Pass makes, traces
and shades its slab's primary and shadow rays from the replicas alone).
Every other resource a step reads (the scene, its tables, the BVH8, the
shadow map, the per-frame data) is the shard's replica (``Mesh.replicate``:
one copy a device for as long as the object lives), made only when the
step reads it.  A step whose slabs do not divide, or do not line up
across the two resolutions of ``rt_scale``, runs once on the primary over
whole images, with a warning, as the reference's mesh falls back.  The
passes without steps read no frame image (the geometry, the BVH or its
refit, the shadow grid, the shadow-map prepass; coverage MSAA, which is
single-device) and run on the primary; a pass without steps that did read
a split image would run over it gathered, with a warning.  The passes that
opt in through ``res["mesh"]`` split their own work:

- ``rasterize_scene_bands``, sort-last raster: each shard bins and rasters
  (K1a) 1/N of the triangles over the whole frame on its device, the
  partial frames are regrouped by row band (the reference's all_to_all,
  here device-to-device copies) and each band is depth-composited on its
  device with the single-device tie-break.  The hybrid G-Buffer Pass, the
  Rayquery Pass and the Forward Pass (``models/passes.raster_steps``)
  resolve each band where it lies; at supersample ss the forward raster's
  bands are ss*H/N rows, which box-filter into the shard's H/N output
  rows.  ``rasterize_scene_sharded`` gathers them for the shadow-map
  prepass.

The temporal state stays row-sharded between frames.  The frame reads
nothing back to the host: the copies are stream-ordered device-to-device
copies, and every decision depends on shapes alone, so on CUDA the
renderer captures it whole, every card's work in one graph
(runtime/dispatch.py).  ``Mesh.moved`` counts the bytes each kind of
exchange moves between shards, as a mesh of N distinct devices moves them.

A mesh may name one device more than once: ``[torch.device("cpu")] * 8``
(the tests, as the reference's tests use 8 virtual CPU devices) or
``[torch.device("cuda", 0)] * 4``, a virtual mesh on one card.  Every shard
then runs on that device, one after another, and computes what a real mesh
computes.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
import warnings
import weakref

import numpy as np
import torch

from vulkanhybridrenderer_tpu_torch.graph.render_graph import (
    RENDER_OUTPUT,
    Read,
    Step,
    pass_steps,
)
from vulkanhybridrenderer_tpu_torch.ops import rasterizer_tiled, shadetab
from vulkanhybridrenderer_tpu_torch.ops.rasterizer import (
    TriangleSetup,
    VisibilityBuffer,
    triangle_setup,
)
from vulkanhybridrenderer_tpu_torch.ops.screen import Rows

ROW_AXIS = "sp"  # image rows (the "sequence/pixel" axis of the reference)


def canonical_device(d) -> torch.device:
    """torch.device(d), a CUDA device without an index given the current
    one, so that it compares equal to its tensors' devices."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True)
class Slabs:
    """An image (..., H, W) over a mesh: parts[i], on the mesh's device i,
    holds its rows i*H/N to (i+1)*H/N."""

    parts: tuple

    @property
    def height(self) -> int:
        return sum(p.shape[-2] for p in self.parts)


class Mesh:
    """A device mesh of one axis (ROW_AXIS).  `devices` is a numpy object
    array of torch.device (``devices.size`` shards, as the reference reads
    ``mesh.devices.size``); a device may repeat.  The first is the primary:
    the frame's resources and its output live there."""

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
        #: bytes moved between shards, by kind ("halo", "gather", "slab",
        #: "raster", "replica", "output"): what N distinct devices move
        self.moved: collections.Counter = collections.Counter()

    @property
    def primary(self) -> torch.device:
        return self.devices[0]

    def distinct(self) -> list[torch.device]:
        """The mesh's devices without repeats, in mesh order."""
        return list(dict.fromkeys(self.devices.tolist()))

    def replicate(self, obj) -> list:
        """`obj` (a tensor, or a dataclass of them, whose tensors share one
        device) on each shard's device, in mesh order.  Each device gets one
        copy per object, kept while the object lives, so a static BVH8 is
        copied once and an animated scene's refit BVH8, a new object every
        frame, is copied again.  Where obj already lies it is obj itself;
        an object without tensors is itself everywhere."""
        first = next(_tensors(obj), None)
        if first is None:
            return [obj] * self.devices.size
        own = canonical_device(first.device)
        copies = self._replicas.get(id(obj))
        if copies is None:
            copies = {d: _to(obj, d) for d in self.distinct() if d != own}
            self._replicas[id(obj)] = copies
            weakref.finalize(obj, self._replicas.pop, id(obj), None)
            self.moved["replica"] += _nbytes(obj) * (self.devices.size - 1)
        return [obj if d == own else copies[d] for d in self.devices]

    def forget(self, *objs) -> None:
        """Drop the replicas of `objs`, so that the next replicate copies
        them again.  A captured frame forgets its fixed inputs (refilled in
        place every frame) before its capture: the capture then copies
        them inside its graph, where a replica the warm-up frame made would
        be a copy no replay refreshes.  Constants keep theirs."""
        for obj in objs:
            self._replicas.pop(id(obj), None)

    def rows(self, i: int, height: int) -> Rows:
        """Shard i's rows of an image `height` rows tall."""
        per = height // self.devices.size
        return Rows(i * per, (i + 1) * per, height)

    def _move(self, t, i: int, j: int, kind: str):
        """Tensor t of shard i on shard j's device (a stream-ordered copy)."""
        if i != j:
            self.moved[kind] += t.numel() * t.element_size()
        return t.to(self.devices[j], non_blocking=True)

    def slab(self, img, i: int):
        """Shard i's rows of a whole image (on the primary), on its device."""
        r = self.rows(i, img.shape[-2])
        return self._move(img[..., r.start:r.stop, :], 0, i, "slab")

    def split(self, img) -> Slabs:
        """A whole image (on the primary) as Slabs."""
        return Slabs(tuple(self.slab(img, i) for i in range(self.devices.size)))

    def gather(self, slabs, kind: str = "output", to: int = 0):
        """The whole image of `slabs` (Slabs or their parts) on shard `to`'s
        device (the primary's by default)."""
        parts = slabs.parts if isinstance(slabs, Slabs) else slabs
        return torch.cat([self._move(p, j, to, kind) for j, p in enumerate(parts)], dim=-2)

    def fetch_halo(self, slabs: Slabs, i: int, r: int):
        """Shard i's rows of `slabs` and the r rows above and below them,
        clipped at the image's edges, on shard i's device: the pieces come
        from every shard that holds one (r may pass several slabs)."""
        if r == 0:
            return slabs.parts[i]
        h = slabs.height
        a, b = self.rows(i, h).window(r)
        pieces = []
        for j, part in enumerate(slabs.parts):
            rj = self.rows(j, h)
            lo, hi = max(a, rj.start), min(b, rj.stop)
            if lo < hi:
                pieces.append(self._move(part[..., lo - rj.start:hi - rj.start, :], j, i,
                                         "halo"))
        return torch.cat(pieces, dim=-2)

    def read(self, x, how: Read, i: int):
        """Image x (Slabs, a whole tensor on the primary, or a dataclass of
        either) as shard i reads it."""
        if x is None:
            return None
        if dataclasses.is_dataclass(x) and not isinstance(x, Slabs):
            return dataclasses.replace(x, **{f.name: self.read(getattr(x, f.name), how, i)
                                             for f in dataclasses.fields(x) if f.init})
        if not isinstance(x, Slabs):
            if how.kind == "whole":
                return self._move(x, 0, i, "gather")
            a, b = self.rows(i, x.shape[-2]).window(how.halo)
            return self._move(x[..., a:b, :], 0, i, "slab")
        if how.kind == "rows":
            return x.parts[i]
        if how.kind == "halo":
            return self.fetch_halo(x, i, how.halo)
        return self.gather(x, "gather", to=i)

    def whole(self, x, kind: str = "output"):
        """x with every Slabs in it gathered onto the primary (x itself when
        it holds none)."""
        if isinstance(x, Slabs):
            return self.gather(x, kind)
        if not any(isinstance(v, Slabs) for v in _leaves(x)):
            return x
        return dataclasses.replace(x, **{f.name: self.whole(getattr(x, f.name), kind)
                                         for f in dataclasses.fields(x) if f.init})


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def _nbytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(obj))


def _to(obj, device):
    """obj with its tensors on `device` (stream-ordered copies)."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device, non_blocking=True)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _to(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def _combine(parts: list):
    """Per-shard outputs as one: tensors become Slabs, dataclasses of them
    dataclasses of Slabs."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return Slabs(tuple(parts))
    return dataclasses.replace(first, **{
        f.name: _combine([getattr(p, f.name) for p in parts])
        for f in dataclasses.fields(first) if f.init})


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
    two dims are (height, width), on the primary) split into Slabs over the
    mesh, as the reference row-shards them, where the shard count divides
    the rows; the rest as they are."""
    if height % mesh.devices.size:
        return dict(resources)

    def place(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 2 and tuple(x.shape[-2:]) == (height, width):
            return mesh.split(x)
        return x

    return {k: place(v) for k, v in resources.items()}


class UndeclaredRead(ValueError):
    """A step read an image of the mesh frame that its reads do not name
    (a ValueError, so that Mapping.get does not take it for a missing
    key)."""


class _ShardRes(collections.abc.Mapping):
    """What a step's fn reads on shard i: its images read as the step
    declares, "rows", and for every other name the shard's replica (made on
    first read).  An image it does not declare raises UndeclaredRead."""

    def __init__(self, src: dict, step: Step, mesh: Mesh, i: int, rows: Rows):
        self._src, self._step, self._mesh, self._i = src, step, mesh, i
        self._got = {"rows": rows}

    def __getitem__(self, k):
        if k not in self._got:
            x = self._src[k]
            if k in self._step.reads:
                self._got[k] = self._mesh.read(x, self._step.reads[k], self._i)
            elif any(isinstance(v, Slabs) for v in _leaves(x)):
                raise UndeclaredRead(f"a step reads the image {k!r} without declaring how")
            else:
                self._got[k] = self._mesh.replicate(x)[self._i]
        return self._got[k]

    def __iter__(self):
        return iter({**self._src, "rows": None})

    def __len__(self):
        return len(self._src) + 1


def _leaves(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, (type, Slabs)):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name))
    else:
        yield x


class ShardClock:
    """Device time of each pass on each shard: events on the shard's
    stream around its share of the pass (its reads and its calls), the
    host clock on the CPU.  ``ms()`` waits for them: {pass: [ms a shard]}."""

    def __init__(self, mesh: Mesh):
        self._mesh = mesh
        self._spans: dict = collections.defaultdict(list)  # (pass, shard) -> [() -> ms]

    @contextlib.contextmanager
    def shard(self, name: str, i: int):
        dev = self._mesh.devices[i]
        if dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record(stream)
            yield
            end.record(stream)
            self._spans[(name, i)].append(lambda: start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            yield
            ms = (time.perf_counter() - t0) * 1e3
            self._spans[(name, i)].append(lambda: ms)

    def ms(self) -> dict:
        for d in self._mesh.distinct():
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        out: dict = {}
        for (name, i), spans in self._spans.items():
            out.setdefault(name, [0.0] * self._mesh.devices.size)[i] = sum(f() for f in spans)
        return out


def _run_step(step: Step, src: dict, mesh: Mesh, height: int, name: str,
              clock: ShardClock | None) -> tuple[dict, bool]:
    """One step of pass `name` over the mesh (Step's docstring): its
    outputs, and whether it ran whole on the primary because its slabs do
    not divide or line up."""
    if step.reads is None:
        return step.fn(src), False
    n = mesh.devices.size
    if height % n or (height // n) % step.scale:
        whole = {**src, "rows": None}
        whole.update({k: mesh.whole(src[k], "gather") for k in step.reads})
        return step.fn(whole), True
    grid = -(-height // (step.out_scale or step.scale))
    outs = []
    for i in range(n):
        with clock.shard(name, i) if clock is not None else contextlib.nullcontext():
            outs.append(step.fn(_ShardRes(src, step, mesh, i, mesh.rows(i, grid))))
    return {k: _combine([o[k] for o in outs]) for k in outs[0]}, False


def run_pass_sharded(graph, name: str, res: dict, mesh: Mesh, height: int,
                     clock: ShardClock | None = None) -> dict:
    """Pass `name`'s outputs over the mesh: its steps, or a pass without
    steps on the primary over whole images.  No pass of the paths reads a
    split image without steps; one that did would read it gathered, with
    a warning."""
    p = graph.passes[name]
    steps = pass_steps(p)
    if not steps:
        split = [k for k in p.inputs if k in res
                 and any(isinstance(v, Slabs) for v in _leaves(res[k]))]
        if split:
            warnings.warn(f"{name}: a pass without steps reads the split images {split}; it "
                          f"runs on {mesh.primary} over them gathered")
        return p.fn({**res, **{k: mesh.whole(res[k], "gather") for k in split}})
    local, alone = dict(res), False
    for step in steps:
        out, whole = _run_step(step, local, mesh, height, name, clock)
        local.update(out)
        alone |= whole
    if alone:
        warnings.warn(f"{name}: {height} rows do not divide into the mesh's {mesh.devices.size} "
                      f"shards (at rt_scale s, into slabs of a multiple of s rows); it runs on "
                      f"{mesh.primary} alone, as the reference's mesh does")
    return {k: local[k] for k in p.outputs}


def mesh_resources(resources: dict, mesh: Mesh, height: int, width: int) -> dict:
    """A frame's resources as the mesh frame reads them: its full-resolution
    images split (shard_image_resources) and the mesh itself."""
    return {**shard_image_resources(resources, mesh, height, width), "mesh": mesh}


def run_sharded(graph, mesh: Mesh, resources: dict, height: int, width: int,
                target: str = RENDER_OUTPUT, clock: ShardClock | None = None) -> dict:
    """graph.run over the mesh: every pass feeding `target`, each as its
    steps say (module docstring); returns all resources, the images among
    them Slabs where they were split."""
    graph.validate(set(resources), target)
    res = mesh_resources(resources, mesh, height, width)
    for name in graph.find_execution_order(target):
        res.update(run_pass_sharded(graph, name, res, mesh, height, clock))
    return res


def make_sharded_frame_fn(graph, mesh: Mesh, height: int, width: int,
                          target: str = RENDER_OUTPUT, keep: tuple = ()):
    """The frame function of `graph` over `mesh` (run_sharded): returns
    `target` whole on the primary and the `keep` resources as they are
    (a temporal state stays row-sharded for the next frame)."""

    def frame_fn(resources: dict) -> dict:
        res = run_sharded(graph, mesh, resources, height, width, target)
        return {target: mesh.whole(res[target]), **{k: res[k] for k in keep}}

    return frame_fn


def time_passes_sharded(graph, mesh: Mesh, resources: dict, height: int, width: int,
                        target: str = RENDER_OUTPUT, iters: int = 5) -> dict[str, float]:
    """RenderGraph.time_passes over the mesh: each pass as in the mesh
    frame, its CUDA events on the primary's stream, which every other
    device's stream joins at both ends."""
    return graph._time_passes(
        mesh_resources(resources, mesh, height, width), target, iters,
        run_pass=lambda name, res: run_pass_sharded(graph, name, res, mesh, height),
        devices=[d for d in mesh.distinct() if d.type == "cuda"])


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


def rasterize_scene_bands(scene, clip, width: int, height: int, mesh: Mesh,
                          alpha: bool = True, cull_backface: bool = True,
                          tables=None) -> list[VisibilityBuffer]:
    """The binned raster over the mesh, sort-last: band j (rows j*H/N to
    (j+1)*H/N) on the mesh's device j, equal on every pixel to those rows of
    ``rasterizer_tiled.rasterize_scene`` with its default peel (below).

    The triangle setup runs once on the primary, its triangle dim padded
    to a multiple of the N shards (padding rows invalid).  Shard i bins its
    T/N triangles on its device (without the alpha-masked ones when they
    are peeled) and rasters them over the whole frame (K1a); its local ids
    become global (+ i * T/N).  Band j of every partial frame goes to
    device j, which composites them in shard order: a partial takes a pixel
    where it has a triangle and is nearer (reverse-Z greater), or as near
    with a larger id, the single-device kernel's (z, id) maximum.

    With alpha (and masked triangles in the scene) the masked stream is
    peeled once on the primary over the whole setup, as in the reference,
    which calls its peel with the default 4 rounds and back-face culling
    whatever the configuration says; so does this.  Its rows go to each
    band's device and merge there.  As the reference's, each shard bins
    with the static cap of its own triangle count, and every band's depth
    is NaN-poisoned when any shard's binning overflowed (the sum of their
    overflows), the masked stream's after its merge."""
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
    for i in range(n):
        rows = slice(i * per, (i + 1) * per)
        sub = TriangleSetup(**{f.name: mesh._move(getattr(setup, f.name)[rows], 0, i, "raster")
                               for f in dataclasses.fields(TriangleSetup)})
        bins = rasterizer_tiled.bin_triangles(sub, width, height, cull_backface=cull_backface,
                                              include=mesh._move(opaque[rows], 0, i, "raster"))
        vis = rasterizer_tiled.raster_tiles(sub.planes, bins, width, height)
        overflow = overflow + mesh._move(bins.overflow, i, 0, "raster")
        tri = torch.where(vis.tri_id >= 0, vis.tri_id + i * per, -1)
        partials.append((vis.depth, tri, vis.bary))

    masked = None
    if use_alpha:
        if tables is None:
            tables = shadetab.build_shade_tables(scene)
        masked = rasterizer_tiled.rasterize_alpha_peeled(scene, setup, width, height, tables)

    bands = []
    for j in range(n):
        rows = mesh.rows(j, height)
        z, tri, bary = None, None, None
        for i, part in enumerate(partials):
            d_i, t_i, b_i = (mesh._move(a[rows.start:rows.stop], i, j, "raster") for a in part)
            if z is None:
                z, tri, bary = d_i, t_i, b_i
                continue
            take = (t_i >= 0) & ((d_i > z) | ((d_i == z) & (t_i > tri)))
            z = torch.where(take, d_i, z)
            tri = torch.where(take, t_i, tri)
            bary = torch.where(take[..., None], b_i, bary)
        vis = rasterizer_tiled.poison(VisibilityBuffer(tri_id=tri, depth=z, bary=bary),
                                      mesh._move(overflow, 0, j, "raster"))
        if masked is not None:
            vis_m, overflow_m = masked
            vis_m = VisibilityBuffer(**{
                f.name: mesh._move(getattr(vis_m, f.name)[rows.start:rows.stop], 0, j, "raster")
                for f in dataclasses.fields(VisibilityBuffer)})
            vis = rasterizer_tiled.poison(rasterizer_tiled.merge_visibility(vis, vis_m),
                                          mesh._move(overflow_m, 0, j, "raster"))
        bands.append(vis)
    return bands


def rasterize_scene_sharded(scene, clip, width: int, height: int, mesh: Mesh,
                            alpha: bool = True, cull_backface: bool = True,
                            tables=None) -> VisibilityBuffer:
    """rasterize_scene_bands' bands gathered on the primary: equal on every
    pixel to ``rasterizer_tiled.rasterize_scene`` with its default peel."""
    return gather_bands(rasterize_scene_bands(scene, clip, width, height, mesh, alpha,
                                              cull_backface, tables), mesh)


def gather_bands(bands: list[VisibilityBuffer], mesh: Mesh) -> VisibilityBuffer:
    """Row bands (band j on the mesh's device j) as one VisibilityBuffer on
    the primary."""
    return VisibilityBuffer(**{
        f.name: torch.cat([mesh._move(getattr(b, f.name), j, 0, "raster")
                           for j, b in enumerate(bands)])
        for f in dataclasses.fields(VisibilityBuffer)})
