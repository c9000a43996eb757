"""The full hybrid frame at rt_scale=2 (RT shadows, RT AO and RT
reflections traced at 48x32, SVGF at trace resolution, the RT Upsample Pass
back to 96x64), frames 0 and 1 with the temporal state carried, the port on
the CPU against the JAX renderer from the same scene arrays, on the small
SponzaProxy.  A file of its own: the JAX frame compiles for ~25 s.

Tolerance: 1e-4 on >= 99.9% of pixels, the full frame's gate of
test_torch_hybrid_full.py (measured: every pixel within 1e-5, max 3.9e-6).
"""
from test_torch_halfres import check_frames, render_both


def test_full_frame_matches_jax():
    out, pr = render_both(96, 64, full=True, n_frames=2)
    check_frames(out, pr, 64, 96)
