"""Pass graph (port of ``graph/render_graph.py``), run eagerly.

Passes are functions over named resources; dependencies are data flow.  The
execution order is the reference's FindExecutionOrder: a backward walk from
the unique writer of RENDER_OUTPUT, so passes that feed nothing are pruned.
There is no jit: ``run`` calls the passes in order and PyTorch queues their
work on the device.
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
class Pass:
    name: str
    fn: Callable[[dict], dict]
    inputs: tuple[str, ...]
    outputs: tuple[str, ...]


class RenderGraph:
    def __init__(self):
        self._passes: dict[str, Pass] = {}

    def add_pass(self, name: str, fn, inputs, outputs):
        """Register a pass: `fn(res: dict) -> dict` returns exactly its
        declared outputs."""
        if name in self._passes:
            raise GraphError(f"duplicate pass {name!r}")
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

    def time_passes(self, resources: dict, device, target: str = RENDER_OUTPUT,
                    iters: int = 5) -> dict[str, float]:
        """Per-pass milliseconds: each pass runs once to warm up, then `iters`
        times between device synchronizations (CUDA events on a GPU, the
        host clock on the CPU)."""
        self.validate(set(resources), target)
        res = dict(resources)
        cuda = torch.device(device).type == "cuda"
        timings: dict[str, float] = {}
        for name in self.find_execution_order(target):
            p = self._passes[name]
            produced = p.fn(res)
            if cuda:
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    produced = p.fn(res)
                end.record()
                torch.cuda.synchronize()
                timings[name] = start.elapsed_time(end) / iters
            else:
                t0 = time.perf_counter()
                for _ in range(iters):
                    produced = p.fn(res)
                timings[name] = (time.perf_counter() - t0) * 1e3 / iters
            res.update({k: produced[k] for k in p.outputs})
        return timings
