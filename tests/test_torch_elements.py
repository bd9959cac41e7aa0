"""Element tables, tet4 stiffness/strain kernels and nodal smoothing of
the port against the JAX package (float64, relative 1e-12)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from frontistr_tpu.elements import tables as jtables
from frontistr_tpu.fem import solid as jsolid
from frontistr_tpu.fem.material import D3, elastic_D
from frontistr_tpu.post import nodal as jnodal
from frontistr_tpu_torch.elements import tables
from frontistr_tpu_torch.fem import solid
from frontistr_tpu_torch.post import nodal

RTOL = 1e-12


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("etype", sorted(jtables.ETYPE_INFO))
def test_tables_match_jax(etype):
    want = jtables.get_table(etype)
    got = tables.get_table(etype)
    assert (got.dim, got.nn, got.nq) == (want.dim, want.nn, want.nq)
    for name in ("points", "weights", "N", "dN"):
        _close(getattr(got, name), getattr(want, name))


def _tets(E: int, seed: int):
    """Randomly distorted, positively oriented unit tets."""
    rng = np.random.default_rng(seed)
    base = np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    return base[None] + 0.15 * rng.standard_normal((E, 4, 3)) \
        + rng.standard_normal((E, 1, 3))


def test_stiffness_linear_tet4_matches_jax():
    coords = _tets(64, 0)
    D = np.broadcast_to(elastic_D(210e3, 0.3, D3), (64, 6, 6)).copy()
    want = jsolid.stiffness_linear(jtables.get_table(341),
                                   jnp.asarray(coords), jnp.asarray(D))
    got = solid.stiffness_linear(tables.get_table(341),
                                 torch.as_tensor(coords),
                                 torch.as_tensor(D))
    _close(got.numpy(), want)


def test_strains_at_gauss_tet4_matches_jax():
    coords = _tets(64, 1)
    u = np.random.default_rng(2).standard_normal((64, 4, 3)) * 1e-3
    want = jsolid.strains_at_gauss(jtables.get_table(341),
                                   jnp.asarray(coords), jnp.asarray(u))
    got = solid.strains_at_gauss(tables.get_table(341),
                                 torch.as_tensor(coords), torch.as_tensor(u))
    _close(got.numpy(), want)


@pytest.mark.parametrize("etype", [231, 232, 241, 242, 341, 342, 351, 352,
                                   361, 362])
def test_extrapolation_matrix_matches_jax(etype):
    _close(nodal.extrapolation_matrix(etype),
           jnodal.extrapolation_matrix(etype))


def test_smooth_matches_jax():
    rng = np.random.default_rng(3)
    n_node, E = 40, 60
    conn = rng.integers(0, n_node - 5, (E, 4))
    eps = rng.standard_normal((E, 1, 6))
    sig = rng.standard_normal((E, 1, 6)) * 100
    want = jnodal.smooth(n_node, [dict(etype=341, conn=conn,
                                       gauss_strain=eps,
                                       gauss_stress=sig)], 3)
    got = nodal.smooth(n_node, [dict(etype=341, conn=conn,
                                     gauss_strain=torch.as_tensor(eps),
                                     gauss_stress=torch.as_tensor(sig))], 3)
    for k in ("strain", "stress", "mises", "count"):
        _close(got[k], want[k])
    for k in ("estrain", "estress", "emises"):
        _close(got[k][0], want[k][0])
