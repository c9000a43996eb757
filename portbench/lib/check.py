"""What decides ``correct``: the port's frames against the reference's.

Inside the window the loop keeps ``check.frames`` consecutive frames as
``render_frame`` returned them (linear RENDER_OUTPUT), the first drawn from
the seed.  Once the window has closed, the port is freed and the reference
(``reference/``, the benchmark's own renderer, independent of the port's
code) renders the same frames on the first card: the same scene, poses,
frame indices and previous views.  On a path that carries a temporal state
(SVGF's history) the reference renders every frame from the port's first,
from an empty history, carrying its own state; on the others only the
compared frames.

Two numbers are compared, each the worst over the frames:

- ``off_share``: the share of pixels whose output differs from the
  reference's, in any channel, by more than ``ATOL + RTOL * |reference|``
  (a pixel that is not finite differs);
- ``rel_err``: the mean absolute difference over the frame, over the mean
  absolute reference value.

Each has its limit in the cell's file (``check.limits``), set from the port's
readings on a dozen seeds and the control's (``PERF.md``).
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

ATOL = 1e-3
RTOL = 1e-3


def frame_numbers(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """off_share and rel_err of one (4, H, W) frame against its reference."""
    out = out.to(torch.float64)
    ref = ref.to(device=out.device, dtype=torch.float64)
    diff = (out - ref).abs()
    ok = diff <= ATOL + RTOL * ref.abs()  # False where out is NaN
    off = (~ok.all(dim=0)).double().mean()
    scale = ref.abs().mean().clamp_min(1e-12)
    err = torch.where(torch.isfinite(diff), diff, torch.full_like(diff, float("inf")))
    return {"off_share": float(off), "rel_err": float(err.mean() / scale)}


def compare(outs: list, refs: list) -> list[dict]:
    if len(outs) != len(refs):
        raise ValueError(f"{len(outs)} frames against {len(refs)} reference frames")
    return [frame_numbers(o, r) for o, r in zip(outs, refs)]


def worst(per_frame: list[dict]) -> dict:
    return {k: max(f[k] for f in per_frame) for k in per_frame[0]}


def verdict(per_frame: list[dict], limits: dict) -> dict:
    """correct, the frames that failed, and each number beside its limit."""
    failed = sum(any(f[k] > limits[k] for k in limits) for f in per_frame)
    w = worst(per_frame)
    numbers = {k: {"value": w[k], "limit": limits[k]} for k in limits}
    return {"correct": failed == 0, "failed": failed, "numbers": numbers}


@dataclasses.dataclass
class Sample:
    """The frames a check compares: `frames` frames of a loop, from its
    `at`-th (run.loop fills it)."""

    at: int
    frames: int
    first: int | None = None  # the renderer's index of the first
    outs: list = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.outs) >= self.frames


def sample_at(seed: int, lo: int, hi: int) -> int:
    """The loop position of the first compared frame, drawn from the seed
    in [lo, hi]."""
    return int(np.random.default_rng([int(seed), 7]).integers(lo, hi + 1))


def sampled(run, sample: Sample):
    """(first frame index, the outputs on the CPU) of a filled sample."""
    if not sample.done:
        raise RuntimeError("the loop ended before the check's frames")
    return sample.first, [o.detach().to("cpu") for o in sample.outs]


def release(run) -> None:
    """Free the port's renderer and every buffer it holds."""
    run.renderer = None
    run.mesh = None
    gc.collect()
    if torch.cuda.is_available():
        for d in range(torch.cuda.device_count()):
            with torch.cuda.device(d):
                torch.cuda.empty_cache()


def make_reference(run, device):
    """The reference renderer of a run's scene and cell on `device`."""
    from portbench.lib import scenes
    from portbench.reference import render

    cfg, cell = run.config_dict, run.cell
    return render.Reference(scenes.reference_scene(run.made), cell.workload["render_config"],
                            cell.workload["path"], cfg["width"], cfg["height"], device)


def reference_frames(ref, fly, first: int, frames: int, lowp: bool = False):
    """The reference's frames first .. first + frames - 1 of the traffic
    `fly`, on the CPU: on a stateful path rendered from frame 0 with an
    empty history (frame 0's previous view its own), else from `first`."""
    start = 0 if ref.stateful else first
    outs, state = [], None
    for i in range(start, first + frames):
        out, state = ref.frame(fly.pose(i), fly.pose(max(i - 1, 0)), i, state, lowp=lowp)
        if i >= first:
            outs.append(out.detach().to("cpu"))
    return outs


def check(run, sample: Sample, device) -> dict:
    """The whole check of one run whose loop filled `sample` (the port is
    freed on the way)."""
    first, outs = sampled(run, sample)
    sample.outs = []
    release(run)
    t0 = time.perf_counter()
    refs = reference_frames(make_reference(run, device), run.fly, first, len(outs))
    v = verdict(compare(outs, refs), run.cell.workload["check"]["limits"])
    return {**v, "first": first, "reference_s": time.perf_counter() - t0}
