"""!EQUATION and !SPRING in NLSTATIC (both solve policies), implicit
DYNAMIC, EIGEN, frequency response and HEAT, the port against the JAX
package on the CPU through ``run_directory``: the decks and bars of
``test_torch_mpc_spring.py`` (an X1 face tied in z to one master node,
loaded there and held by a spring).
"""

import os
import shutil

import numpy as np
import pytest

import frontistr_tpu.run as jrun
from frontistr_tpu_torch.run import run_directory

from _torch_decks import (dyn_deck, heat_deck, heat_mesh, run_both,
                          solid_box, write_heat_deck)
from test_torch_mpc_spring import _close, _deck, env, tie_face  # noqa


@pytest.mark.parametrize("policy", ["f64", "mixed"])
def test_nlstatic_mpc_spring_matches_jax(tmp_path, env, policy):
    env.setenv("FRONTISTR_TPU_PRECISION", policy)
    mesh = solid_box(341, 3, 2, 2)
    ot, oj, wd, wj = run_both(tmp_path, mesh, _deck(mesh, "NLSTATIC",
                                                    load=None))
    res, jres = ot["static"], oj["static"]
    _close(res.u, jres.u)
    assert res.iters == int(jres.iters) >= 2
    with open(os.path.join(wd, "FSTR.sta")) as a, \
            open(os.path.join(wj, "FSTR.sta")) as b:
        assert a.read() == b.read()


def test_implicit_dynamics_mpc_matches_jax(tmp_path, env):
    mesh = solid_box(361, 3, 2, 2)
    mast = tie_face(mesh)
    cnt = dyn_deck(eqa=1, n_step=4, dt=1e-6, ray_m=1e3, ray_k=1e-9,
                   loads=f"!CLOAD\n {mast}, 3, -5.0\n")
    ot, oj, _, _ = run_both(tmp_path, mesh, cnt)
    for name in ("u", "vel", "acc"):
        _close(getattr(ot["dynamic"], name), getattr(oj["dynamic"], name))


EIGEN = ("!VERSION\n 3\n!SOLUTION, TYPE={sol}\n{dyn}!EIGEN\n 3, 1.0e-8, 60\n"
         "!BOUNDARY\n X0, 1, 3, 0.0\n{loads}!MATERIAL, NAME=M1\n!ELASTIC\n"
         " 210000.0, 0.3\n!DENSITY\n 7.85e-9\n"
         "!SOLVER, METHOD=CG, PRECOND=1, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
         " 1.0e-10, 1.0, 0.0\n!END\n")


def _eigen_mesh():
    mesh = solid_box(361, 4, 2, 2, lx=400.0, ly=100.0, lz=100.0)
    tie_face(mesh)
    return mesh


def test_eigen_mpc_matches_jax(tmp_path, env):
    ot, oj, _, _ = run_both(tmp_path, _eigen_mesh(),
                            EIGEN.format(sol="EIGEN", dyn="", loads=""))
    et, ej = ot["eigen"], oj["eigen"]
    assert et.iters == ej.iters
    np.testing.assert_allclose(et.eigenvalues, ej.eigenvalues, rtol=1e-8)


def test_frequency_response_mpc_matches_jax(tmp_path, env):
    """Frequency response on the MPC deck, its modes from an in-process
    Lanczos run with the elimination."""
    dyn = "!DYNAMIC\n 11, 2\n 1000.0, 40000.0, 20, 1.0\n 0.5, 0.25\n" \
          " 1, 1, 3.0, 2.0e-6\n"
    cnt = EIGEN.format(sol="DYNAMIC", dyn=dyn,
                       loads="!FLOAD, LOAD CASE=1\n X1, 3, 1.0\n")
    ot, oj, _, _ = run_both(tmp_path, _eigen_mesh(), cnt)
    ft, fj = ot["freq"], oj["freq"]
    np.testing.assert_allclose(ft.freqs, fj.freqs, rtol=1e-12)
    for name in ("disp_amp_max", "vel_amp_max", "acc_amp_max"):
        np.testing.assert_allclose(getattr(ft, name), getattr(fj, name),
                                   rtol=1e-8)


def test_heat_mpc_matches_jax(tmp_path, env):
    """Transient HEAT with the X1 face's temperatures tied to one node."""
    mesh = heat_mesh("hex8")
    tie_face(mesh, dof=1)
    wd = write_heat_deck(tmp_path / "port", mesh, heat_deck(mesh))
    wj = str(tmp_path / "jax")
    shutil.copytree(wd, wj)
    hj = jrun.run_directory(wj)["heat"]
    ht = run_directory(wd, device="cpu")["heat"]
    assert (ht.steps, ht.iters) == (hj.steps, hj.iters)
    _close(ht.T, hj.T)
