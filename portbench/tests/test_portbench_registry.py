"""A new cell, configuration, traffic mix, scene generator and metric are
new files under portbench/ and entries in BENCHMARK.json: the harness of a
copy finds them all with no file of it edited."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

NEW_FILES = {
    "configs/tiny-cfg.json": json.dumps({
        "name": "tiny-cfg", "scene": {"generator": "tiny_glb", "scale": 0.05},
        "width": 64, "height": 32, "mesh_shards": 1, "bvh_row_bytes": 512}),
    "workloads/tiny-cell.json": json.dumps({
        "path": "raytraced", "render_config": {"raytraced": {"test_alpha": False}},
        "warm_frames": 1, "trace_frames": 2,
        "check": {"frames": 2, "within": 5, "limits": {"off_share": 0.001, "rel_err": 0.001}},
        "k2_wavefronts": []}),
    "traffic/hover.json": json.dumps({
        "in_flight": 2, "step_s": 0.01, "speed": 1.0, "walk_frames": 2,
        "yaw_amplitude": 0.0, "pitch_amplitude": 0.05, "period": 8}),
    "inputs/tiny_glb.py": (
        "from portbench.inputs import sponza_class_glb\n\n\n"
        "def make(params, workdir):\n"
        "    out = sponza_class_glb.make(params, workdir)\n"
        "    out['made_by'] = 'tiny_glb'\n"
        "    return out\n"),
    "metrics/frames.seen.py": (
        "def read(ctx):\n"
        "    return float(ctx.frames)\n"),
}

SCRIPT = """
import sys, tempfile, types, torch
from pathlib import Path
copy, repo = Path(sys.argv[1]), Path(sys.argv[2])
sys.path[:0] = [str(copy), str(repo)]
import portbench
assert Path(portbench.__file__).resolve().parent == (copy / "portbench").resolve()
from portbench.lib import check, harness, spec
cell = spec.load_cell("tiny-cell", copy)
assert cell.config["name"] == "tiny-cfg" and cell.traffic["period"] == 8
new = [m for m in cell.per_layer if m["name"] == "frames.seen"]
assert len(new) == 1
with tempfile.TemporaryDirectory() as d:
    run = harness.Run(cell, 9, 0, Path(d))
    assert run.made["made_by"] == "tiny_glb"
    run.warm_up(cell.workload["warm_frames"])
    ctx = types.SimpleNamespace(frames=3)
    print(harness.read_metrics(new, ctx))
    sample = check.Sample(at=1, frames=2)
    run.loop(frames=4, sample=sample)
    print(check.check(run, sample, torch.device("cpu"))["correct"])
"""


def test_new_files_are_found_without_an_edit(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    for rel, text in NEW_FILES.items():
        (tmp_path / "portbench" / rel).write_text(text)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-cfg", "source": "https://example.org/tiny",
                             "file": "portbench/configs/tiny-cfg.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "tiny-cell", "config": "tiny-cfg",
                               "traffic": "hover", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "frames.seen", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "frame driver",
                               "moves": "frame_ms", "workloads": ["tiny-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())  # nothing edited
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path), str(ROOT)],
                         cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "{'frames.seen': {'value': 3.0, 'unit': 'frames'}}"
    assert lines[-1] == "True"


def test_a_cell_whose_path_its_configuration_does_not_deploy_is_refused(tmp_path):
    from portbench.lib import spec

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "portbench/configs/realglb-1080p-raytraced.json").read_text())
    (tmp_path / "other.json").write_text(json.dumps({**cfg, "render_path": "hybrid"}))
    for c in bench["configs"]:
        if c["name"] == "realglb-1080p-raytraced":
            c["file"] = str(tmp_path / "other.json")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert spec.load_cell("realglb-raytraced-fly", ROOT).config["render_path"] == "raytraced"
    with pytest.raises(ValueError, match="deploys the hybrid path"):
        spec.load_cell("realglb-raytraced-fly", tmp_path)
