"""The benchmark's tests: on the CPU at a tiny size, except those marked
``cuda``, which need the card and skip without one (decided in a fixture).

    python -m pytest portbench/tests -q
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: a tiny stand-in for each cell: the frame size, the scene's entries and
#: the render settings put in place of the cell's (a 4096^2 shadow map's
#: static bins do not hold a tiny scene's few large triangles)
TINY = {
    "realglb-hybrid-fly": dict(size=(96, 56), scene={"scale": 0.05}),
    "sponza-raster-fly": dict(size=(96, 56), scene={"args": {
        "columns": 2, "segments": 8, "extra_boxes": 10, "grid_res": 16}},
        settings={"shadow_map_size": 256}),
    "realglb-raytraced-fly": dict(size=(96, 56), scene={"scale": 0.05}),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs CUDA cards on the machine; skips where it has too few")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny_run(name: str, seed: int, workdir, fault=None, root=ROOT):
    """A Run of cell `name` on the CPU at its tiny size, warmed up."""
    from portbench.lib import harness, spec

    cell = spec.load_cell(name, root)
    run = harness.Run(cell, seed, 0, Path(workdir), fault=fault, **TINY[name])
    run.warm_up(1)
    return run


def checked(run, frames: int = 6, at: int = 2) -> dict:
    """Loop `frames` frames, the check's frames from the `at`-th, and check
    them on the CPU."""
    import torch

    from portbench.lib import check

    sample = check.Sample(at=at, frames=int(run.cell.workload["check"]["frames"]))
    run.loop(frames=frames, sample=sample)
    return check.check(run, sample, torch.device("cpu"))
