"""Frame dispatch on a GPU: a (path, config)'s frame as CUDA graphs (the
port's counterpart of the reference's ``Renderer._get_frame_fn``,
``_run_per_pass`` and ``precompile_passes``).

The reference compiles its frame once per (path, config): dispatch="fused"
into one XLA program, "per_pass" into one program a pass, its inputs traced
arrays, so frame advance does not recompile.  Here the graph's frame
function is captured into ``torch.cuda.CUDAGraph``s that read fixed input
buffers: the per-frame data (``core/types.pack_per_frame_data``'s two
arrays, the frame index among them), the primitive transforms and the SVGF
temporal state.  Every frame refills them on its stream and replays.

- "fused": one graph a frame.  Every pass sizes its work from shapes
  alone (the brute raster's chunks, the shadow grid's tables, the binning's
  entry cap), as the reference's static shapes do, so nothing in a frame
  waits for the host.
- "per_pass": one graph per pass, sharing the key's memory pool, so pass
  k's outputs are pass k + 1's fixed inputs.

Over a mesh (parallel/mesh.py) each graph spans the mesh's cards, as the
reference compiles its sharded frame into one program over the mesh: the
capture begins on the primary's side stream, and every other card's side
stream is forked from it by an event, is that card's current stream while
the capture lasts (the mesh's copies and the kernel wrappers queue on the
current stream of their tensors' device) and is joined back by an event
before it ends.  Each other card's allocations in the capture go into a
memory pool of its own (``torch.cuda.MemPool``), held with the graphs; the
cross-card copies become the graph's copy nodes.  The temporal state stays
row-sharded (``Slabs``), each slab copied on its own card; the fixed
inputs' replicas on the other cards are made inside the graph
(``Mesh.forget``); a virtual mesh (one card named N times) is captured as
one card is.

The temporal state is carried as the reference donates it: the captured
pass that makes "TemporalStateOut" ends by copying it into the state it
read.  A capture that fails, or syncs, raises and names its key: nothing
runs eagerly in its place.  Kernel wrappers count their launches when
Python calls them, and the mesh its bytes between shards (``Mesh.moved``),
which a replay does not; each graph records the counts its capture added
and adds them again at every replay, so the counters stay per frame.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
import warnings

import torch

from vulkanhybridrenderer_tpu_torch.core.types import PER_FRAME_FLOATS, per_frame_data_from_flat
from vulkanhybridrenderer_tpu_torch.graph.render_graph import tensors_of
from vulkanhybridrenderer_tpu_torch.parallel import mesh as pmesh

TEMPORAL_OUT = "TemporalStateOut"


def launch_counters() -> list:
    """The kernel wrappers whose ``launches`` count their launches (an int,
    or a Counter by mode)."""
    from vulkanhybridrenderer_tpu_torch.ops import rasterizer_tiled as rt
    from vulkanhybridrenderer_tpu_torch.ops import shadowgrid, traverse
    from vulkanhybridrenderer_tpu_torch.utils import build

    return [rt.raster_tiles, rt.raster_tiles_peel, rt.raster_tiles_compact,
            rt.raster_tiles_msaa, traverse.trace, traverse.trace_flat,
            shadowgrid.trace_shadow, build.toy_scale]


def counters(mesh=None) -> list:
    """(object, attribute) of every per-frame counter: the kernel wrappers'
    ``launches``, and over a mesh its ``moved``."""
    out = [(f, "launches") for f in launch_counters()]
    return out + ([(mesh, "moved")] if mesh is not None else [])


def snapshot(counted: list) -> list:
    return [collections.Counter(v) if isinstance(v, collections.Counter) else v
            for v in (getattr(o, a) for o, a in counted)]


def delta(before: list, after: list) -> list:
    return [a - b for a, b in zip(after, before)]


def add(counted: list, d: list) -> None:
    """The counts `d` (a delta) added to the counters again."""
    for (o, a), x in zip(counted, d):
        if isinstance(x, collections.Counter):
            getattr(o, a).update(x)
        else:
            setattr(o, a, getattr(o, a) + x)


def clone_state(x):
    """A copy of a resource of tensors (a tensor, Slabs, a dataclass of
    either), each tensor cloned on its own device."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, pmesh.Slabs):
        return pmesh.Slabs(tuple(p.clone() for p in x.parts))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: clone_state(getattr(x, f.name))
                                         for f in dataclasses.fields(x) if f.init})
    return x


def _parts(x) -> list:
    return list(x.parts) if isinstance(x, pmesh.Slabs) else [x]


def copy_into(dst, src) -> None:
    """src's values into dst's buffers, field by field.  An image may be
    whole on one side and Slabs on the other: each slab of dst gets its rows
    from the part of src that holds them, a copy on the slab's card."""
    if isinstance(dst, pmesh.Slabs) or isinstance(src, pmesh.Slabs):
        s_at = 0
        spans = []
        for p in _parts(src):
            spans.append((s_at, p))
            s_at += p.shape[-2]
        d_at = 0
        for d in _parts(dst):
            a, b = d_at, d_at + d.shape[-2]
            for s0, p in spans:
                lo, hi = max(a, s0), min(b, s0 + p.shape[-2])
                if lo < hi:
                    d[..., lo - a:hi - a, :].copy_(p[..., lo - s0:hi - s0, :])
            d_at = b
    elif isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            copy_into(getattr(dst, f.name), getattr(src, f.name))


def _layout(x) -> list:
    return [(t.shape, t.dtype, t.device) for t in tensors_of(x)]


class CapturedFrame:
    """One (path, config)'s frame on one CUDA device, or over a mesh of
    several (``consts["mesh"]``, the frame ``size`` (H, W) then given), as
    CUDA graphs over fixed input buffers.  `key` names it in errors;
    `consts` are the resources that are not refilled (scene, BVH8, shade
    tables, shadow grid): the graphs read them where they lie, so the
    renderer makes a new CapturedFrame when one of them is replaced.  On
    the CPU it can be made and its state handled, not warmed or captured."""

    def __init__(self, key, graph, target: str, keep: tuple, per_pass: bool, device,
                 consts: dict, n_prims: int, temporal_state=None, size=None):
        self.key = key
        self.graph = graph
        self.target, self.keep = target, tuple(keep)
        self.device = device
        self.consts = dict(consts)
        self.mesh = self.consts.get("mesh")
        self.size = size
        order = graph.find_execution_order(target)
        #: the passes of each graph, in order: one graph a pass or a frame
        self.segments = [[name] for name in order] if per_pass else [order]
        self.graphs: list = [None] * len(self.segments)
        self.deltas: list = [None] * len(self.segments)
        self.counted = counters(self.mesh)
        self.capture_s: dict[str, float] = {}
        #: the mesh's cards other than this one, each with a side stream and
        #: a memory pool for its share of the capture (none on one card or a
        #: virtual mesh)
        self.others = ([] if self.mesh is None
                       else [d for d in self.mesh.distinct() if d != device])
        cuda = torch.device(device).type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        self.stream = torch.cuda.Stream(device) if cuda else None
        self.side = {d: torch.cuda.Stream(d) for d in self.others}
        self.pools = {}
        for d in self.others:
            with torch.cuda.device(d):
                self.pools[d] = torch.cuda.MemPool()
        # the fixed inputs, refilled every frame by load()
        self.flat = torch.zeros(PER_FRAME_FLOATS, dtype=torch.float32, device=device)
        self.ints = torch.zeros(2, dtype=torch.int64, device=device)
        self.prim = torch.zeros((n_prims, 4, 4), dtype=torch.float32, device=device)
        self.state = None if temporal_state is None else clone_state(temporal_state)
        self.res: dict | None = None  # the inputs and every output, once captured
        self.warmed = False
        self._capturing = False
        self._warm: dict | None = None

    @property
    def captured(self) -> bool:
        return self.res is not None

    @property
    def n_graphs(self) -> int:
        return len(self.segments)

    def matches(self, consts: dict) -> bool:
        return consts.keys() == self.consts.keys() and all(
            consts[k] is self.consts[k] for k in consts)

    def _main(self):
        return torch.cuda.current_stream(self.device)

    def load(self, packed, prim_transform, temporal_state=None) -> None:
        """Refill the fixed inputs on the current stream: the per-frame
        arrays through pinned memory (queued, no wait; the pinned blocks are
        not reused before their copies finish), the transforms and, unless
        it is already this frame's own, the temporal state (slab by slab
        over a mesh, whatever its layout)."""
        for dst, src in zip((self.flat, self.ints), packed):
            src = torch.from_numpy(src)
            dst.copy_(src.pin_memory() if dst.is_cuda else src, non_blocking=True)
        self.prim.copy_(prim_transform)
        if self.state is not None and temporal_state is not None \
                and temporal_state is not self.state:
            copy_into(self.state, temporal_state)

    def save_state(self):
        """A copy of the temporal state (None without state)."""
        return None if self.state is None else clone_state(self.state)

    def restore_state(self, saved) -> None:
        if saved is not None:
            copy_into(self.state, saved)

    def inputs(self) -> dict:
        res = dict(self.consts, pfd=per_frame_data_from_flat(self.flat, self.ints),
                   prim_transform=self.prim)
        if self.state is not None:
            res["temporal_state"] = self.state
        return res

    def _keep_state(self, p, produced) -> None:
        """The reference's donation: the state a pass makes copied into the
        state the frame read.  The warm-up frame sets its layout: over a
        mesh the frame leaves the state row-sharded, so the state becomes a
        copy of the one it made, which every later frame refills."""
        if TEMPORAL_OUT in p.outputs and TEMPORAL_OUT in self.keep:
            out = produced[TEMPORAL_OUT]
            if _layout(out) == _layout(self.state):
                copy_into(self.state, out)
            elif not self._capturing:
                self.state = clone_state(out)
            else:
                raise RuntimeError(f"{self.key}: the captured frame's temporal state has "
                                   "another layout than its warm-up frame's")

    def _run_passes(self, i: int, res) -> None:
        """Segment i's passes over res; over a mesh each pass runs as in the
        mesh frame, the first segment also splits the frame's images and the
        last gathers the target onto the primary."""
        mesh = self.mesh
        if mesh is not None and i == 0:
            res.update(pmesh.mesh_resources(res, mesh, *self.size))
        for name in self.segments[i]:
            p = self.graph.passes[name]
            produced = (p.fn(res) if mesh is None
                        else pmesh.run_pass_sharded(self.graph, name, res, mesh, self.size[0]))
            res.update({k: produced[k] for k in p.outputs})
            self._keep_state(p, produced)
        if mesh is not None and i == len(self.segments) - 1:
            res[self.target] = mesh.whole(res[self.target])

    def run_segments(self, res: dict) -> dict:
        """Every graph's passes over res, eagerly on the current streams:
        the warm-up frame's body, and on the CPU the frame its graphs
        capture."""
        self.graph.validate(set(res), self.target)
        for i in range(len(self.segments)):
            self._run_passes(i, res)
        return res

    @contextlib.contextmanager
    def _cards(self, pools: bool):
        """The other cards' side streams current, with `pools` their
        allocations routed into their pools; the primary the current
        device.  Entered around a capture, outside it."""
        with contextlib.ExitStack() as stack:
            for d in self.others:
                stack.enter_context(torch.cuda.stream(self.side[d]))
                if pools:
                    stack.enter_context(torch.cuda.use_mem_pool(self.pools[d], d))
            stack.enter_context(torch.cuda.device(self.device))
            yield

    @contextlib.contextmanager
    def _forked(self):
        """The other cards' side streams forked from the primary's current
        stream by an event, and joined back to it by one each at the end:
        inside a capture, the edges of the graph across the cards."""
        if not self.others:
            yield
            return
        fork = torch.cuda.Event()
        fork.record(self._main())
        for d in self.others:
            self.side[d].wait_event(fork)
        yield
        for d in self.others:
            self._main().wait_event(self.side[d].record_event())

    def _wait_for_cards(self, stream) -> None:
        """`stream` after the work queued so far on the other cards'
        current streams (a state slab refilled there)."""
        for d in self.others:
            stream.wait_stream(torch.cuda.current_stream(d))

    def _cards_wait_for(self, stream) -> None:
        """The other cards' current streams after `stream`'s work so far, so
        that what they queue next (a read of a state slab) sees the frame."""
        for d in self.others:
            torch.cuda.current_stream(d).wait_stream(stream)

    def warm(self) -> dict:
        """The first frame: the graph run eagerly on the side streams, over
        the fixed inputs (it builds the kernels, fills the tables' caches,
        makes every device constant and every replica of a constant a
        capture will read, and sets the temporal state's layout)."""
        main = self._main()
        self.stream.wait_stream(main)
        self._wait_for_cards(self.stream)
        res = self.inputs()
        self.warmed = True
        with torch.cuda.stream(self.stream), self._cards(pools=False), self._forked():
            self.run_segments(res)
        main.wait_stream(self.stream)
        self._cards_wait_for(main)
        self._warm = res  # kept until the capture's device-wide sync
        return res

    def capture(self) -> dict[str, float]:
        """Capture every graph of the frame in order on the side stream,
        replaying each right after its capture, so this runs the frame once.
        Returns the capture seconds of each graph, keyed by its first
        pass."""
        for d in [self.device, *self.others]:
            torch.cuda.synchronize(d)
        self._warm = None
        res = self.inputs()
        if self.mesh is not None:
            self.mesh.forget(self.flat, self.ints, self.prim, self.state)
        self.graph.validate(set(res), self.target)
        main = self._main()
        self._capturing = True
        try:
            with torch.cuda.stream(self.stream):
                for i, seg in enumerate(self.segments):
                    g = torch.cuda.CUDAGraph()
                    before = snapshot(self.counted)
                    t0 = time.perf_counter()
                    try:
                        with warnings.catch_warnings():
                            # a pass that only hands on an input (the static
                            # BVH) captures no work: its graph is empty, and
                            # that is fine
                            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                            with self._cards(pools=True), \
                                    torch.cuda.graph(g, pool=self.pool, stream=self.stream), \
                                    self._forked():
                                self._run_passes(i, res)
                    except Exception as e:
                        raise RuntimeError(
                            f"CUDA graph capture of {self.key} failed in pass(es) {seg}: {e}"
                        ) from e
                    self.capture_s[seg[0]] = time.perf_counter() - t0
                    self.deltas[i] = delta(before, snapshot(self.counted))
                    self.graphs[i] = g
                    g.replay()
        finally:
            self._capturing = False
        main.wait_stream(self.stream)
        self._cards_wait_for(main)
        self.res = res
        return dict(self.capture_s)

    def release(self) -> None:
        """Give back the device memory this frame holds, once the work queued
        on it has finished: its graphs, their pools (the other cards' too),
        the fixed inputs and every buffer of the frame.  The pools' blocks
        go back to the devices (torch.cuda.empty_cache), since a graph's
        private pool is not reused by later captures.  The temporal state
        (made outside the pools) is left to whoever still holds it."""
        for d in [self.device, *self.others]:
            torch.cuda.synchronize(d)
        for g in self.graphs:
            if g is not None:
                g.reset()
        self.graphs = [None] * len(self.segments)
        self.res = self._warm = None
        self.flat = self.ints = self.prim = None
        self.consts = {}
        self.pools = {}
        torch.cuda.empty_cache()

    def replay(self) -> dict:
        """Run the captured frame on the current stream, after what the
        other cards' current streams hold, and theirs after it."""
        main = self._main()
        self._wait_for_cards(main)
        for g, d in zip(self.graphs, self.deltas):
            g.replay()
            add(self.counted, d)
        self._cards_wait_for(main)
        return self.res
