"""The port's coverage-MSAA 4x forward frame of the small Sponza proxy
(alpha_raster="brute": each sample peels the alpha-masked leaves) against
the JAX Renderer(path="forward"), frames 0 and 1 at 96x64.

Tolerance: 1e-4 on >= 99.9% of pixels (measured 0.99967: two pixels, where
a sample's triangle id flips between the two setups' rounding and the
resolve takes the other fragment's color).
"""
import torch

from vulkanhybridrenderer_tpu.scene import procedural as jproc

from test_torch_forward import forward_frames

torch.set_num_threads(2)


def test_coverage_msaa_sponza_matches_jax():
    js = jproc.sponza_proxy(columns=3, segments=6, extra_boxes=12, grid_res=8)
    assert js.buffers.has_alpha_mask
    forward_frames(js, "coverage4x")
