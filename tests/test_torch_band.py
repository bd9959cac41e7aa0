"""The port's band Cholesky (``solver/band.py``, FRONTISTR_TPU_DIRECT=band)
against the JAX package's on the CPU: the block-band layout bit for bit
against the JAX package's host relayout, EIGEN (eigenvalues and modes up
to sign) and implicit DYNAMIC (linear and Newton arms) through
``run_directory`` against the JAX band arm and the port's own SuperLU
arm, and a factor against a dense solve on a small matrix with fixed
dofs, zero rows and a diagonal added.

Bars: fields within 1e-8 of the largest, Lanczos counts equal.
"""

import numpy as np
import pytest
import torch

from frontistr_tpu_torch.run import run_directory
from frontistr_tpu_torch.solver import band

from _torch_decks import dyn_deck, run_both, solid_box
from test_torch_direct import EIGEN


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", "f64")
    monkeypatch.setenv("FRONTISTR_TPU_REORDER", "1")
    monkeypatch.setenv("FRONTISTR_TPU_DIRECT", "band")
    return monkeypatch


def _close(a, b, rel=1e-8):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.isfinite(a).all()
    assert np.abs(a - b).max() <= rel * np.abs(b).max()


def _jax_layout(kes, dofs_list, perm, free, n_dof, nb, scale, diag_add):
    """The JAX package's host band and relayout (``BandCholesky.__init__``,
    ``frontistr_tpu/solver/band.py:140-169``), written out here: the
    class factors on its device as it builds."""
    b = max(int((perm[d].max(axis=1) - perm[d].min(axis=1)).max())
            for d in dofs_list)
    B = b // nb + 2
    nblk = -(-n_dof // nb)
    npad = nblk * nb
    Ab = np.zeros((npad, (B - 1) * nb + 1))
    fp = np.ones(npad)
    fp[perm] = free
    fp[n_dof:] = 0.0
    for ke, dofs in zip(kes, dofs_list):
        pd = perm[dofs]
        kv = np.asarray(ke, float) * scale
        E, m, _ = kv.shape
        r = np.repeat(pd, m, axis=1).reshape(-1)
        c = np.tile(pd[:, None, :], (1, m, 1)).reshape(-1)
        v = kv.reshape(-1) * fp[r] * fp[c]
        keep = r >= c
        np.add.at(Ab, (r[keep], r[keep] - c[keep]), v[keep])
    if diag_add is not None:
        Ab[perm, 0] += np.asarray(diag_add) * fp[perm]
    Ab[:, 0] = np.where(fp > 0, np.where(Ab[:, 0] == 0.0, 1.0, Ab[:, 0]),
                        1.0)
    Ablk = np.zeros((nblk, B, nb, nb))
    ii = np.arange(npad)
    for l in range(B):
        for cc in range(nb):
            d = ii % nb + l * nb - cc
            ok = (d >= 0) & (d <= (B - 1) * nb) & (ii - d >= 0)
            Ablk[ii[ok] // nb, l, ii[ok] % nb, cc] = Ab[ii[ok], d[ok]]
    return Ablk


def _random_system(seed=0, n_node=30, nd=3, E=40, nn=4):
    """Random SPD element blocks on a random node graph, a free mask
    with fixed dofs and a node no element touches."""
    rng = np.random.default_rng(seed)
    conn = np.stack([rng.choice(n_node - 1, nn, replace=False)
                     for _ in range(E)])
    m = nn * nd
    a = rng.standard_normal((E, m, m))
    kes = a @ a.transpose(0, 2, 1) + m * np.eye(m)
    dofs = (conn[:, :, None] * nd + np.arange(nd)).reshape(E, m)
    free = np.ones(n_node * nd)
    free[rng.choice(n_node * nd, 7, replace=False)] = 0.0
    return conn, kes, dofs, free


@pytest.mark.parametrize("nb", [4, 32])
def test_band_layout_bits_match_jax(nb):
    conn, kes, dofs, free = _random_system()
    n_dof = 90
    perm = np.random.default_rng(1).permutation(n_dof)
    diag = np.random.default_rng(2).random(n_dof)
    got, B, nblk = band.band_layout([kes], [dofs], perm, free, n_dof, nb,
                                    scale=1.7, diag_add=diag)
    want = _jax_layout([kes], [dofs], perm, free, n_dof, nb, 1.7, diag)
    assert got.shape == (nblk + B,) + want.shape[1:]
    assert np.array_equal(got[:nblk], want) and not got[nblk:].any()


@pytest.mark.parametrize("nb", [3, 32])
def test_band_solve_matches_dense(nb):
    """P A P + (I - P), A = 1.7 K + diag(d), solved against numpy."""
    conn, kes, dofs, free = _random_system(seed=4)
    n_dof = 90
    d = np.random.default_rng(5).random(n_dof)
    fac = band.BandCholesky([torch.as_tensor(kes)], [dofs], n_dof, free,
                            [conn], 30, nb=nb, scale=1.7, diag_add=d)
    A = np.zeros((n_dof, n_dof))
    for ke, dd in zip(kes, dofs):
        A[np.ix_(dd, dd)] += 1.7 * ke
    A += np.diag(d)
    Ac = free[:, None] * A * free[None, :] + np.diag(1.0 - free)
    Ac[np.diag(Ac) == 0.0, np.diag(Ac) == 0.0] = 1.0
    rhs = np.random.default_rng(6).standard_normal(n_dof)
    x = fac.solve(torch.as_tensor(rhs)).numpy()
    _close(x, np.linalg.solve(Ac, rhs), 1e-12)
    assert fac.band == (fac.B - 1) * nb and fac.stats()["nb"] == nb


@pytest.mark.parametrize("etype", [361, 341])
def test_band_eigen_matches_jax_band_and_superlu(tmp_path, env, etype):
    # a 100 x 70 section: no two bending modes share an eigenvalue
    mesh = solid_box(etype, 4, 2, 2, lx=400.0, ly=100.0, lz=70.0)
    cnt = EIGEN.format(sol="EIGEN", dyn="", loads="", step="")
    ot, oj, wd, _ = run_both(tmp_path, mesh, cnt)
    et, ej = ot["eigen"], oj["eigen"]
    assert et.iters == ej.iters
    np.testing.assert_allclose(et.eigenvalues, ej.eigenvalues, rtol=1e-8)
    # modes up to sign
    sign = np.sign((et.eigenvectors * ej.eigenvectors).sum(axis=0))
    _close(et.eigenvectors * sign, ej.eigenvectors)
    assert et.factor["band"] > 0 and et.factor["factor_s"] >= 0.0
    env.delenv("FRONTISTR_TPU_DIRECT")
    es = run_directory(wd, device="cpu")["eigen"]
    assert es.factor == {} and es.iters == et.iters
    np.testing.assert_allclose(et.eigenvalues, es.eigenvalues, rtol=1e-8)


@pytest.mark.parametrize("scan", ["1", "0"])
def test_band_implicit_dynamics_matches_jax_band_and_superlu(tmp_path, env,
                                                             scan):
    """Newmark with one band factor of c1 K + c2 M: once a run on the
    linear arm (scan "1"), every iteration on the Newton arm ("0")."""
    env.setenv("FRONTISTR_TPU_IMPLICIT_SCAN", scan)
    cnt = dyn_deck(eqa=1, n_step=4, dt=1e-6, ray_m=1e3, ray_k=1e-9,
                   loads="!CLOAD\n X1, 3, -1.0\n").replace("METHOD=CG",
                                                          "METHOD=DIRECT")
    ot, oj, wd, _ = run_both(tmp_path, solid_box(361, 3, 2, 2), cnt)
    for name in ("u", "vel", "acc"):
        _close(getattr(ot["dynamic"], name), getattr(oj["dynamic"], name))
    env.delenv("FRONTISTR_TPU_DIRECT")
    ds = run_directory(wd, device="cpu")["dynamic"]
    for name in ("u", "vel", "acc"):
        _close(getattr(ot["dynamic"], name), getattr(ds, name))
