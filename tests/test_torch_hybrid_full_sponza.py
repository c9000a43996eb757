"""The port's full hybrid frame against the JAX renderer on the small Sponza
proxy (alpha-masked leaves, metallic clutter), frames 0, 1 and 2, with
test_torch_hybrid_full.py's tolerance.  A file of its own so that each file
stays within a minute on the CPU."""
import pytest

from vulkanhybridrenderer_tpu.scene import procedural as jproc
from test_torch_hybrid_full import FRAMES, check_frame, render_both


@pytest.fixture(scope="module")
def sponza_frames():
    return render_both(jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8))


@pytest.mark.parametrize("frame", range(FRAMES))
def test_full_frame_matches_jax_sponza(sponza_frames, frame):
    check_frame(sponza_frames, frame)
