"""The harness over a mesh (``mesh_shards`` in a configuration): a cell of
the flagship's settings row-sharded over 4 CPU shards runs, and its check
holds the gathered frame to the reference and fails the gather left out.  The cell is made in a copy,
as a later four-card cell would be added (new files, no edit)."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = """
import sys, tempfile, torch
from pathlib import Path
copy, repo, fault = Path(sys.argv[1]), Path(sys.argv[2]), sys.argv[3]
sys.path[:0] = [str(copy), str(repo)]
from portbench.lib import check, harness, spec

def exchange_left_out(run, out):
    out = out.clone()
    out[:, run.renderer.mesh.rows(0, out.shape[1]).stop:, :] = 0.0
    return out

cell = spec.load_cell("mesh-cell", copy)
with tempfile.TemporaryDirectory() as d:
    run = harness.Run(cell, 2**31 + 5, 0, Path(d), size=(96, 56), scene={"scale": 0.05},
                      fault=exchange_left_out if fault == "exchange" else None)
    assert run.renderer.mesh is not None and run.renderer.mesh.devices.size == 4
    run.warm_up(1)
    sample = check.Sample(at=2, frames=3)
    run.loop(frames=6, sample=sample)
    print(check.check(run, sample, torch.device("cpu"))["correct"])
"""


@pytest.mark.parametrize("fault,correct", [("none", "True"), ("exchange", "False")])
def test_a_mesh_cell_checks_its_gathered_frame(fault, correct, tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "realglb-1080p.json").read_text())
    cfg.update(name="mesh-cfg", mesh_shards=4)
    (pb / "configs" / "mesh-cfg.json").write_text(json.dumps(cfg))
    shutil.copy(pb / "workloads" / "realglb-hybrid-fly.json", pb / "workloads" / "mesh-cell.json")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mesh-cfg", "source": "https://example.org/mesh",
                             "file": "portbench/configs/mesh-cfg.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "mesh-cell", "config": "mesh-cfg", "traffic": "fly",
                               "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path), str(ROOT), fault],
                         cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == correct
