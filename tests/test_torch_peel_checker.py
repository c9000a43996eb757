"""The port's alpha depth-peel against the JAX package on the checker quad
with one alpha-masked leaf, with test_torch_peel.py's tolerance.  A file of
its own so that each file stays within a minute on the CPU."""
from test_torch_peel import _case, check_peel_matches_jax


def test_peel_matches_jax_checker_leaf():
    check_peel_matches_jax(_case("checker_leaf"))
