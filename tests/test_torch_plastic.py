"""The elastoplastic update of the port (``fem/plastic.py``) against the
JAX package's, on the CPU: ``return_mapping`` and ``plastic_tangent``
for every yield function (MISES, DRUCKER-PRAGER, MOHR-COULOMB) and
hardening law (LINEAR, MULTILINEAR, SWIFT, RAMBERG-OSGOOD, KINEMATIC,
COMBINED), at random trial stresses and committed states made from a
numpy seed; float64, within 1e-12 relative to the largest value.  The
batch mixes yielding and elastic points, and holds a zero stress and a
uniaxial one (the degenerate Lode angles of the Mohr-Coulomb arm)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from frontistr_tpu.fem import plastic as jpl
from frontistr_tpu_torch import convert
from frontistr_tpu_torch.fem import plastic as pl

LAWS = ["LINEAR", "MULTILINEAR", "SWIFT", "RAMBERG-OSGOOD", "KINEMATIC",
        "COMBINED"]
YIELDS = ["MISES", "DRUCKER-PRAGER", "MOHR-COULOMB"]
MISES_CONSTS = {
    "LINEAR": [250.0, 1000.0],
    "MULTILINEAR": [[250.0, 0.0], [300.0, 0.01], [320.0, 0.05]],
    "SWIFT": [0.01, 600.0, 0.2],
    "RAMBERG-OSGOOD": [0.002, 250.0, 5.0],
    "KINEMATIC": [250.0, 2000.0],
    "COMBINED": [250.0, 800.0, 1200.0],
}


def _params(jax_mod, yf, law):
    consts = np.asarray(MISES_CONSTS[law] if yf == "MISES"
                        else [40.0, 30.0, 500.0], np.float64)
    table = consts.reshape(-1, 2) if law == "MULTILINEAR" and \
        yf == "MISES" else None
    return jax_mod.PlasticParams(210000.0, 0.3, law, consts.reshape(-1),
                                 table=table, yield_func=yf)


def _inputs(seed, kinematic):
    rng = np.random.default_rng(seed)
    shape = (7, 4)
    sig = 300.0 * rng.standard_normal(shape + (6,))
    sig[..., :3] -= 150.0 * rng.random(shape + (1,))     # some compression
    sig[0, 0] = 0.0
    sig[0, 1] = [400.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    sig[1] *= 0.05                                       # elastic points
    p = 0.02 * rng.random(shape)
    back = 30.0 * rng.standard_normal(shape + (6,)) if kinematic \
        else np.zeros(shape + (6,))
    return sig, p, back


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("law", LAWS)
@pytest.mark.parametrize("yf", YIELDS)
def test_return_mapping_matches_jax(yf, law):
    jp, pp = _params(jpl, yf, law), _params(pl, yf, law)
    sig, p, back = _inputs(YIELDS.index(yf) * 10 + LAWS.index(law),
                           pp.kinematic)
    want = jpl.return_mapping(jp, jnp.asarray(sig), jnp.asarray(p),
                              jnp.asarray(back))
    got = pl.return_mapping(pp, torch.as_tensor(sig), torch.as_tensor(p),
                            torch.as_tensor(back))
    yielded = np.asarray(want[2])
    assert yielded.any() and not yielded.all()
    assert np.array_equal(got[2].numpy(), yielded)
    for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert np.isfinite(g.numpy()).all()
        assert _rel(g, w) <= 1e-12


@pytest.mark.parametrize("law", LAWS)
@pytest.mark.parametrize("yf", YIELDS)
def test_plastic_tangent_matches_jax(yf, law):
    jp, pp = _params(jpl, yf, law), _params(pl, yf, law)
    sig, p, back = _inputs(100 + YIELDS.index(yf) * 10 + LAWS.index(law),
                           pp.kinematic)
    # the state a return mapping leaves: returned stress, its yielded set
    s, pn, y, b = jpl.return_mapping(jp, jnp.asarray(sig), jnp.asarray(p),
                                     jnp.asarray(back))
    lam, mu = 210000.0 * 0.3 / (1.3 * 0.4), 210000.0 / 2.6
    De = np.zeros((6, 6))
    De[:3, :3] = lam
    De[np.arange(3), np.arange(3)] += 2 * mu
    De[np.arange(3, 6), np.arange(3, 6)] = mu
    De = np.broadcast_to(De, sig.shape[:2] + (6, 6)).copy()
    want = jpl.plastic_tangent(jp, jnp.asarray(De), s, pn, b, y)
    got = pl.plastic_tangent(pp, torch.as_tensor(De),
                             torch.as_tensor(np.array(s)),
                             torch.as_tensor(np.array(pn)),
                             torch.as_tensor(np.array(b)),
                             torch.as_tensor(np.array(y)))
    assert np.isfinite(got.numpy()).all()
    assert _rel(got, want) <= 1e-12


def test_eigh3_voigt_reconstructs():
    rng = np.random.default_rng(5)
    v = rng.standard_normal((50, 6))
    v[0] = [1.0, 1.0, 1.0, 0.0, 0.0, 0.0]                 # triple root
    ev, vec = pl.eigh3_voigt(torch.as_tensor(v))
    A = torch.einsum("bik,bk,bjk->bij", vec, ev, vec).numpy()
    want = np.stack([v[:, 0], v[:, 3], v[:, 5], v[:, 3], v[:, 1], v[:, 4],
                     v[:, 5], v[:, 4], v[:, 2]], -1).reshape(-1, 3, 3)
    assert np.abs(A - want).max() <= 1e-12 * np.abs(want).max()
    assert (np.diff(ev.numpy(), axis=-1) >= -1e-12).all()


def test_plastic_params_from_jax():
    jp = _params(jpl, "MISES", "MULTILINEAR")
    pp = convert.plastic_params_from_numpy(jp)
    assert isinstance(pp, pl.PlasticParams)
    assert (pp.youngs, pp.poisson, pp.hardening, pp.yield_func) == \
        (jp.youngs, jp.poisson, jp.hardening, jp.yield_func)
    assert np.array_equal(pp.consts, jp.consts)
    assert np.array_equal(pp.table, jp.table)
