"""Pass graph (port of ``graph/render_graph.py``), run eagerly.

Passes are functions over named resources; dependencies are data flow.  The
execution order is the reference's FindExecutionOrder: a backward walk from
the unique writer of RENDER_OUTPUT, so passes that feed nothing are pruned.
There is no jit: ``run`` calls the passes in order and PyTorch queues their
work on the device; ``make_frame_fn`` closes over ``run`` as the reference's
does, and the renderer captures it into CUDA graphs (runtime/dispatch.py):
every pass sizes its work from shapes alone, as the reference's static
shapes do, so a frame on one device is one graph.

A pass is a function, or a sequence of ``Step``s: stages that each declare
how they read the images they use (``ROWS``, ``halo(r)`` or ``WHOLE``).  On
one device the steps run in order over the resources with ``rows`` None
(every row); over a device mesh (parallel/mesh.py) each runs once per row
slab, its reads exchanged between the shards as declared.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

RENDER_OUTPUT = "RENDER_OUTPUT"


class GraphError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class Read:
    """How a step's shard reads an image over a mesh: "rows" (its own),
    "halo" (its own and `halo` rows above and below, clipped at the image's
    edges) or "whole"."""

    kind: str
    halo: int = 0


ROWS = Read("rows")
WHOLE = Read("whole")


def halo(rows: int) -> Read:
    return Read("halo", rows)


@dataclasses.dataclass(frozen=True)
class Step:
    """One stage of a pass: fn(res) -> a dict of what it produces.

    On one device res holds every resource and what the steps before it
    produced, and res["rows"] is None.  Over a mesh (parallel/mesh.py),
    reads None: fn runs once, on the primary, with the mesh in res["mesh"]
    (a stage that splits its own work, the sort-last raster); its outputs
    may be Slabs.  Else fn runs once per shard on the shard's device: res
    holds each image of `reads` read as its Read says, res["rows"] the Rows
    its outputs cover, and for every other name the shard's replica; its
    outputs (tensors, or dataclasses of them) become Slabs.  Its rows are
    those of an image of ceil(H / out_scale) rows (`out_scale` defaults to
    `scale`); `scale` is the trace scale of the step's images, whose slabs
    line up with the frame's only where (H / N) % scale == 0."""

    fn: Callable
    reads: dict | None
    scale: int = 1
    out_scale: int | None = None


def run_steps(steps, res: dict) -> dict:
    """`steps` on one device: each over `res`, with every row (res["rows"]
    None), and what the steps before it produced; returns `res` and all
    they produced."""
    local = {**res, "rows": None}
    for step in steps:
        local.update(step.fn(local))
    return local


@dataclasses.dataclass(frozen=True)
class Pass:
    name: str
    fn: Callable[[dict], dict]
    inputs: tuple[str, ...]
    outputs: tuple[str, ...]


class _StepsFn:
    """The fn of a pass registered as Steps: on one device it runs them
    (run_steps) and returns the pass's outputs."""

    def __init__(self, steps: tuple, outputs: tuple):
        self.steps, self.outputs = steps, outputs

    def __call__(self, res: dict) -> dict:
        produced = run_steps(self.steps, res)
        return {k: produced[k] for k in self.outputs}


def pass_steps(p: Pass) -> tuple:
    """The Steps pass p was registered as; () for a pass given as a function."""
    return p.fn.steps if isinstance(p.fn, _StepsFn) else ()


def tensors_of(obj) -> list:
    """Every tensor in a resource (a tensor, or the fields and items of
    dataclasses, dicts, lists and tuples), in a fixed order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [t for f in dataclasses.fields(obj) for t in tensors_of(getattr(obj, f.name))]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in tensors_of(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in tensors_of(v)]
    return []


class RenderGraph:
    def __init__(self):
        self._passes: dict[str, Pass] = {}

    @property
    def passes(self) -> dict[str, Pass]:
        return self._passes

    def add_pass(self, name: str, fn, inputs, outputs):
        """Register a pass: `fn(res: dict) -> dict` returns exactly its
        declared outputs; or `fn` a sequence of Steps, which produce them
        (run_steps; over a mesh, a shard at a time)."""
        if name in self._passes:
            raise GraphError(f"duplicate pass {name!r}")
        if not callable(fn):
            fn = _StepsFn(tuple(fn), tuple(outputs))
        self._passes[name] = Pass(name, fn, tuple(inputs), tuple(outputs))
        return self

    def writers(self) -> dict[str, str]:
        """resource -> its unique producing pass."""
        w: dict[str, str] = {}
        for p in self._passes.values():
            for out in p.outputs:
                if out in w:
                    raise GraphError(
                        f"resource {out!r} written by both {w[out]!r} and {p.name!r}"
                    )
                w[out] = p.name
        return w

    def find_execution_order(self, target: str = RENDER_OUTPUT) -> list[str]:
        """Passes feeding `target`, dependencies first; others are pruned."""
        w = self.writers()
        if target not in w:
            raise GraphError(f"no pass writes {target!r}")
        order: list[str] = []
        done: set[str] = set()
        visiting: set[str] = set()

        def visit(name: str):
            if name in done:
                return
            if name in visiting:
                raise GraphError(f"cycle detected in pass graph at {name!r}")
            visiting.add(name)
            for dep in self._passes[name].inputs:
                if dep in w:
                    visit(w[dep])
            visiting.discard(name)
            done.add(name)
            order.append(name)

        visit(w[target])
        return order

    def validate(self, external: set[str], target: str = RENDER_OUTPUT):
        """Every input is produced by a pass or provided externally."""
        w = self.writers()
        for name in self.find_execution_order(target):
            for dep in self._passes[name].inputs:
                if dep not in w and dep not in external:
                    raise GraphError(
                        f"pass {name!r} reads {dep!r}: not written by any pass nor external"
                    )

    def run(self, resources: dict, target: str = RENDER_OUTPUT) -> dict:
        """Execute every pass feeding `target`; returns all resources."""
        self.validate(set(resources), target)
        res = dict(resources)
        for name in self.find_execution_order(target):
            p = self._passes[name]
            produced = p.fn(res)
            missing = set(p.outputs) - set(produced)
            if missing:
                raise GraphError(f"pass {name!r} did not produce {missing}")
            res.update({k: produced[k] for k in p.outputs})
        return res

    def make_frame_fn(self, target: str = RENDER_OUTPUT, keep: tuple[str, ...] = ()):
        """The reference's frame function: frame_fn(resources) -> a dict of
        `target` and the `keep` resources only, a plain function over run."""
        wanted = (target,) + tuple(keep)

        def frame_fn(resources: dict) -> dict:
            res = self.run(resources, target)
            return {k: res[k] for k in wanted}

        return frame_fn

    def time_passes(self, resources: dict, target: str = RENDER_OUTPUT,
                    iters: int = 5) -> dict[str, float]:
        """Per-pass milliseconds: each pass runs once to warm up, then `iters`
        times between device synchronizations (CUDA events where the
        resources' tensors lie on a GPU, the host clock on the CPU)."""
        return self._time_passes(resources, target, iters)

    def _time_passes(self, resources: dict, target: str, iters: int, run_pass=None,
                     devices=None) -> dict[str, float]:
        """time_passes, each pass run by `run_pass(name, res)` (by default
        its fn over res); the events go on the current stream of the first
        of the CUDA `devices` (by default the current device), which every
        other one's stream joins at both ends (a frame over a mesh,
        parallel/mesh.py)."""
        self.validate(set(resources), target)
        res = dict(resources)
        if run_pass is None:
            def run_pass(name, r):
                return self._passes[name].fn(r)
        cuda = any(t.is_cuda for t in tensors_of(resources))
        devs = list(devices or [torch.cuda.current_device()]) if cuda else []
        timings: dict[str, float] = {}
        for name in self.find_execution_order(target):
            p = self._passes[name]
            produced = run_pass(name, res)
            if cuda:
                for d in devs:
                    torch.cuda.synchronize(d)
                stream = torch.cuda.current_stream(devs[0])
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(stream)
                for d in devs[1:]:
                    torch.cuda.current_stream(d).wait_event(start)
                for _ in range(iters):
                    produced = run_pass(name, res)
                for d in devs[1:]:
                    stream.wait_event(torch.cuda.current_stream(d).record_event())
                end.record(stream)
                torch.cuda.synchronize(devs[0])
                timings[name] = start.elapsed_time(end) / iters
            else:
                t0 = time.perf_counter()
                for _ in range(iters):
                    produced = run_pass(name, res)
                timings[name] = (time.perf_counter() - t0) * 1e3 / iters
            res.update({k: produced[k] for k in p.outputs})
        return timings


class PassStats:
    """EMA-smoothed per-pass timings (reference render_graph.cpp:199:
    t = 0.95 * old + 0.05 * new) and an FPS counter."""

    ALPHA = 0.05

    def __init__(self):
        self.timings: dict[str, float] = {}
        self.frame_ms: float | None = None

    def update(self, new_timings: dict[str, float]):
        for k, v in new_timings.items():
            old = self.timings.get(k)
            self.timings[k] = v if old is None else (1 - self.ALPHA) * old + self.ALPHA * v

    def update_frame(self, ms: float):
        old = self.frame_ms
        self.frame_ms = ms if old is None else (1 - self.ALPHA) * old + self.ALPHA * ms

    @property
    def fps(self) -> float:
        return 1e3 / self.frame_ms if self.frame_ms else 0.0

    def table(self) -> str:
        lines = [f"{'pass':<40} {'ms':>8}"]
        for k, v in self.timings.items():
            lines.append(f"{k:<40} {v:>8.3f}")
        if self.frame_ms is not None:
            lines.append(f"{'[frame]':<40} {self.frame_ms:>8.3f}  ({self.fps:.1f} FPS)")
        return "\n".join(lines)
