"""20 implicit-viscosity DFSPH steps of the port against the JAX package's
under the slab-window engine: the scene and checks of
tests/test_torch_viscosity.py (split from it so that each file stays short on
one test worker)."""
from test_torch_viscosity import check_implicit_steps


def test_implicit_steps_match_jax_slab():
    check_implicit_steps(pair_backend="pallas")
