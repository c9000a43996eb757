"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port; names compared whole, by the part
before the first dot (the port's name begins with the JAX package's)."""
import subprocess
import sys
from pathlib import Path

from portbench.lib.harness import FORBIDDEN, forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["vulkanhybridrenderer_tpu_torch", "vulkanhybridrenderer_tpu_torch.ops",
                              "jaxtyping", "flaxen.x", "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "vulkanhybridrenderer_tpu.ops", "jaxlib"]) == [
        "jax", "jaxlib", "vulkanhybridrenderer_tpu"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "vulkanhybridrenderer_tpu"}


def _loaded(code: str) -> set:
    """The top-level names of the modules a fresh interpreter has loaded
    after running `code` (JAX_PLATFORMS and friends left as they are)."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(sorted({m.split('.', 1)[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


RUN = """
import sys, tempfile, torch
from pathlib import Path
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import checked, tiny_run
with tempfile.TemporaryDirectory() as d:
    v = checked(tiny_run({cell!r}, 5, d))
    assert v["correct"], v
"""


def test_a_run_and_its_check_load_no_jax():
    names = _loaded(RUN.format(root=str(ROOT), tests=str(Path(__file__).parent),
                               cell="realglb-hybrid-fly"))
    assert "vulkanhybridrenderer_tpu_torch" in names and "portbench" in names
    assert not names & set(FORBIDDEN)


def test_the_reference_and_the_inputs_load_nothing_of_the_port():
    code = f"""
import sys, tempfile, torch
sys.path.insert(0, {str(ROOT)!r})
from portbench.lib import fly, scenes, spec, window, trace, check
from portbench.inputs import procedural, sponza_class_glb
from portbench.reference import render
from pathlib import Path
with tempfile.TemporaryDirectory() as d:
    made = sponza_class_glb.make({{"scale": 0.05}}, d)
    cell = spec.load_cell("realglb-hybrid-fly", Path({str(ROOT)!r}))
    ref = render.Reference(scenes.reference_scene(made), cell.workload["render_config"],
                           "hybrid", 64, 32, "cpu")
    cam = ref.sc.camera
    f = fly.Fly(cell.traffic, 1, cam.position, cam.yaw, cam.pitch, fly.view_forward(cam.view()))
    outs = check.reference_frames(ref, f, 1, 2)
    assert len(outs) == 2 and bool(torch.isfinite(outs[1]).all())
    procedural.make({{"scene": "sponza_proxy", "args": {{"columns": 2, "segments": 8,
                     "extra_boxes": 4, "grid_res": 8}}}}, d)
"""
    names = _loaded(code)
    assert "portbench" in names
    assert not names & {*FORBIDDEN, "vulkanhybridrenderer_tpu_torch"}
