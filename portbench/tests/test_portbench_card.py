"""On the card: a whole run of a cell prints a correct line, and the
control, at the cell's own size, is not correct.  Both skip without a
card (the ``cuda_card`` fixture decides)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
KEYS = {"correct", "attempted", "failed", "metrics", "device", "check"}


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_prints_a_correct_line(cuda_card, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "realglb-raytraced-fly",
         "--seed", str(2**31 + 101), "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(line) - {"breakdown"} == KEYS
    assert list(line)[-1] == "check"
    assert line["correct"], line["check"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    names = set(line["metrics"])
    if trace:
        assert {"device.idle_share", "kernels.k2_ms", "passes.plain_ms"} <= names
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    else:
        assert names == {"frame_ms", "frame_ms_p95", "setup_s"}


@pytest.mark.cuda
def test_the_control_at_the_cells_size_is_not_correct(cuda_card, tmp_path):
    from portbench.lib import check, harness, spec

    cell = spec.load_cell("realglb-raytraced-fly", ROOT)
    run = harness.Run(cell, 2**31 + 103, torch.cuda.device_count(), tmp_path)
    run.warm_up(1)
    sample = check.Sample(at=2, frames=int(cell.workload["check"]["frames"]))
    run.loop(frames=6, sample=sample)
    first, outs = check.sampled(run, sample)
    check.release(run)
    ref = check.make_reference(run, cuda_card)
    refs = check.reference_frames(ref, run.fly, first, len(outs))
    low = check.reference_frames(ref, run.fly, first, len(outs), lowp=True)
    limits = cell.workload["check"]["limits"]
    assert check.verdict(check.compare(outs, refs), limits)["correct"]
    assert not check.verdict(check.compare(low, refs), limits)["correct"]
