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

A frame over a mesh queues work on several devices' streams, which one
capture cannot hold: the renderer runs the mesh frame's function eagerly
under both dispatches (runtime/renderer.py).

The temporal state is carried as the reference donates it: the captured
pass that makes "TemporalStateOut" ends by copying it into the state it
read.  A capture that fails, or syncs, raises and names its key: nothing
runs eagerly in its place.  Kernel wrappers count their launches when
Python calls them, which a replay does not; each graph records the counts
its capture added and adds them again at every replay, so the counters stay
launches per frame.
"""
from __future__ import annotations

import collections
import dataclasses
import time
import warnings

import torch

from vulkanhybridrenderer_tpu_torch.core.types import PER_FRAME_FLOATS, per_frame_data_from_flat
from vulkanhybridrenderer_tpu_torch.graph.render_graph import tensors_of

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


def _snapshot() -> list:
    return [collections.Counter(f.launches) if isinstance(f.launches, collections.Counter)
            else f.launches for f in launch_counters()]


def _delta(before: list, after: list) -> list:
    return [a - b for a, b in zip(after, before)]


def _add(delta: list) -> None:
    for f, d in zip(launch_counters(), delta):
        if isinstance(f.launches, collections.Counter):
            f.launches.update(d)
        else:
            f.launches += d


def _copy_into(dst, src) -> None:
    for d, s in zip(tensors_of(dst), tensors_of(src)):
        d.copy_(s)


class CapturedFrame:
    """One (path, config)'s frame on one CUDA device, as CUDA graphs over
    fixed input buffers.  `key` names it in errors; `consts` are the
    resources that are not refilled (scene, BVH8, shade tables, shadow
    grid): the graphs read them where they lie, so the renderer makes a new
    CapturedFrame when one of them is replaced."""

    def __init__(self, key, graph, target: str, keep: tuple, per_pass: bool, device,
                 consts: dict, n_prims: int, temporal_state=None):
        self.key = key
        self.graph = graph
        self.target, self.keep = target, tuple(keep)
        self.device = device
        self.consts = dict(consts)
        order = graph.find_execution_order(target)
        #: the passes of each graph, in order: one graph a pass or a frame
        self.segments = [[name] for name in order] if per_pass else [order]
        self.graphs: list = [None] * len(self.segments)
        self.deltas: list = [None] * len(self.segments)
        self.capture_s: dict[str, float] = {}
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        # the fixed inputs, refilled every frame by load()
        self.flat = torch.zeros(PER_FRAME_FLOATS, dtype=torch.float32, device=device)
        self.ints = torch.zeros(2, dtype=torch.int64, device=device)
        self.prim = torch.zeros((n_prims, 4, 4), dtype=torch.float32, device=device)
        self.state = (None if temporal_state is None
                      else dataclasses.replace(temporal_state, **{
                          f.name: getattr(temporal_state, f.name).clone()
                          for f in dataclasses.fields(temporal_state)}))
        self.res: dict | None = None  # the inputs and every output, once captured
        self.warmed = False
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

    def load(self, packed, prim_transform, temporal_state=None) -> None:
        """Refill the fixed inputs on the current stream: the per-frame
        arrays through pinned memory (queued, no wait; the pinned blocks are
        not reused before their copies finish), the transforms and, unless
        it is already this frame's own, the temporal state."""
        flat, ints = packed
        self.flat.copy_(torch.from_numpy(flat).pin_memory(), non_blocking=True)
        self.ints.copy_(torch.from_numpy(ints).pin_memory(), non_blocking=True)
        self.prim.copy_(prim_transform)
        if self.state is not None and temporal_state is not None \
                and temporal_state is not self.state:
            _copy_into(self.state, temporal_state)

    def save_state(self):
        """A copy of the temporal state buffers (None without state)."""
        return None if self.state is None else [t.clone() for t in tensors_of(self.state)]

    def restore_state(self, saved) -> None:
        if saved is not None:
            for d, t in zip(tensors_of(self.state), saved):
                d.copy_(t)

    def inputs(self) -> dict:
        res = dict(self.consts, pfd=per_frame_data_from_flat(self.flat, self.ints),
                   prim_transform=self.prim)
        if self.state is not None:
            res["temporal_state"] = self.state
        return res

    def _keep_state(self, p, produced) -> None:
        """The reference's donation: the state a pass makes copied into the
        state the frame read."""
        if TEMPORAL_OUT in p.outputs and TEMPORAL_OUT in self.keep:
            _copy_into(self.state, produced[TEMPORAL_OUT])

    def _run_passes(self, seg, res) -> None:
        for name in seg:
            p = self.graph.passes[name]
            produced = p.fn(res)
            res.update({k: produced[k] for k in p.outputs})
            self._keep_state(p, produced)

    def warm(self) -> dict:
        """The first frame: the graph run eagerly on the side stream, over
        the fixed inputs (it builds the kernels, fills the tables' caches
        and makes every device constant a capture will read)."""
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        res = self.inputs()
        self.warmed = True
        with torch.cuda.stream(self.stream):
            self.graph.validate(set(res), self.target)
            for seg in self.segments:
                self._run_passes(seg, res)
        main.wait_stream(self.stream)
        self._warm = res  # kept until the capture's device-wide sync
        return res

    def capture(self) -> dict[str, float]:
        """Capture every graph of the frame in order on the side stream,
        replaying each right after its capture, so this runs the frame once.
        Returns the capture seconds of each graph, keyed by its first
        pass."""
        torch.cuda.synchronize(self.device)
        self._warm = None
        res = self.inputs()
        self.graph.validate(set(res), self.target)
        main = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            for i, seg in enumerate(self.segments):
                g = torch.cuda.CUDAGraph()
                before = _snapshot()
                t0 = time.perf_counter()
                try:
                    with warnings.catch_warnings():
                        # a pass that only hands on an input (the static BVH)
                        # captures no work: its graph is empty, and that is fine
                        warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                        with torch.cuda.graph(g, pool=self.pool, stream=self.stream):
                            self._run_passes(seg, res)
                except Exception as e:
                    raise RuntimeError(
                        f"CUDA graph capture of {self.key} failed in pass(es) {seg}: {e}"
                    ) from e
                self.capture_s[seg[0]] = time.perf_counter() - t0
                self.deltas[i] = _delta(before, _snapshot())
                self.graphs[i] = g
                g.replay()
        main.wait_stream(self.stream)
        self.res = res
        return dict(self.capture_s)

    def release(self) -> None:
        """Give back the device memory this frame holds, once the work queued
        on it has finished: its graphs, their pool, the fixed inputs and
        every buffer of the frame.  The pool's blocks go back to the device
        (torch.cuda.empty_cache), since a graph's private pool is not
        reused by later captures.  The temporal state (made outside the
        pool) is left to whoever still holds it."""
        torch.cuda.synchronize(self.device)
        for g in self.graphs:
            if g is not None:
                g.reset()
        self.graphs = [None] * len(self.segments)
        self.res = self._warm = None
        self.flat = self.ints = self.prim = None
        self.consts = {}
        torch.cuda.empty_cache()

    def replay(self) -> dict:
        """Run the captured frame on the current stream."""
        for g, delta in zip(self.graphs, self.deltas):
            g.replay()
            _add(delta)
        return self.res
