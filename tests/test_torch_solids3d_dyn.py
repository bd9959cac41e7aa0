"""The prism (351, 352) and hex20 (362) solids in implicit DYNAMIC
(HRZ-lumped mass), EIGEN and transient HEAT, the port against the JAX
package on the CPU through ``run_directory``, on ``solid_box`` decks.
The JAX package's compile of a hex20 run takes most of a minute, so
the hex20 dynamics and the quadratic eigen decks are in
``test_torch_solids3d_hex20.py``, on another worker.

Bars: displacements, velocities, accelerations and temperatures within
1e-8 of the largest, eigenvalues within 1e-8 relative, Lanczos and
fixed-point iterations equal.  The eigen box is 300 x 200 x 100 mm:
Lanczos's absolute breakdown test stops a millimetre box at step 1 in
both packages (ROADMAP, reference-side caveats).
"""

import shutil

import numpy as np
import pytest

import frontistr_tpu.run as jrun
from frontistr_tpu_torch.run import run_directory

from _torch_decks import (dyn_deck, heat_deck, heat_mesh, run_both,
                          solid_box, write_heat_deck)

ETYPES = (351, 352, 362)
EIGEN = ("!VERSION\n 3\n!SOLUTION, TYPE=EIGEN\n!EIGEN\n 3, 1.0e-8, 60\n"
         "!BOUNDARY\n X0, 1, 3, 0.0\n!MATERIAL, NAME=M1\n!ELASTIC\n"
         " 210000.0, 0.3\n!DENSITY\n 7.85e-9\n"
         "!SOLVER, METHOD=CG, PRECOND=1, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
         " 1.0e-10, 1.0, 0.0\n!END\n")


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", "f64")
    monkeypatch.setenv("FRONTISTR_TPU_REORDER", "1")
    return monkeypatch


def _close(a, b, rel=1e-8):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.isfinite(a).all()
    assert np.abs(a - b).max() <= rel * np.abs(b).max()


def implicit_dynamics(tmp_path, etype):
    cnt = dyn_deck(eqa=1, n_step=4, dt=1e-6, ray_m=1e3, ray_k=1e-9,
                   loads="!CLOAD\n X1, 3, -1.0\n")
    ot, oj, _, _ = run_both(tmp_path, solid_box(etype, 2, 2, 1), cnt)
    dt, dj = ot["dynamic"], oj["dynamic"]
    assert dt.steps == dj.steps == 4
    for name in ("u", "vel", "acc"):
        _close(getattr(dt, name), getattr(dj, name))


def eigen(tmp_path, etype):
    ot, oj, _, _ = run_both(tmp_path, solid_box(etype, 3, 2, 1, lx=300.0,
                                                   ly=200.0, lz=100.0),
                              EIGEN)
    et, ej = ot["eigen"], oj["eigen"]
    assert et.iters == ej.iters
    np.testing.assert_allclose(et.eigenvalues, ej.eigenvalues, rtol=1e-8)


@pytest.mark.parametrize("etype", (351, 352))
def test_implicit_dynamics_matches_jax(tmp_path, env, etype):
    implicit_dynamics(tmp_path, etype)


def test_eigen_matches_jax(tmp_path, env):
    eigen(tmp_path, 351)


@pytest.mark.parametrize("etype", ETYPES)
def test_transient_heat_matches_jax(tmp_path, env, etype):
    mesh = heat_mesh(etype)
    wd = write_heat_deck(tmp_path / "port", mesh, heat_deck(mesh))
    wj = str(tmp_path / "jax")
    shutil.copytree(wd, wj)
    hj = jrun.run_directory(wj)["heat"]
    ht = run_directory(wd, device="cpu")["heat"]
    assert (ht.steps, ht.iters) == (hj.steps, hj.iters)
    _close(ht.T, hj.T)
