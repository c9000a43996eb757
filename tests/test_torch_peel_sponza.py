"""The port's alpha depth-peel against the JAX package on the small Sponza
proxy (its leaves and clutter), with test_torch_peel.py's tolerance.  A file
of its own so that each file stays within a minute on the CPU."""
from test_torch_peel import _case, check_peel_matches_jax


def test_peel_matches_jax_sponza():
    check_peel_matches_jax(_case("sponza"))
