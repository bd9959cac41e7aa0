"""The hex20 (362) solid in implicit DYNAMIC and the quadratic solids
(352, 362) in EIGEN, the port against the JAX package on the CPU: the
decks and bars of ``test_torch_solids3d_dyn.py``, in a file of their
own because the JAX package's compile of each takes most of a minute."""

import pytest

from test_torch_solids3d_dyn import eigen, env, implicit_dynamics  # noqa


def test_hex20_implicit_dynamics_matches_jax(tmp_path, env):
    implicit_dynamics(tmp_path, 362)


@pytest.mark.parametrize("etype", (352, 362))
def test_quadratic_eigen_matches_jax(tmp_path, env, etype):
    eigen(tmp_path, etype)
