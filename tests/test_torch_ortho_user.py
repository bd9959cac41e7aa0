"""Orthotropic !ELASTIC in a section's !ORIENTATION frame, the
temperature-dependent !ELASTIC table, and the user plug points (a umat
and a uload registered in both packages' own registries), the port
against the JAX package on the CPU through ``run_directory``: a shuffled
``box_hex8(3, 2, 2)``, X0 fixed, X1 loaded, the f64 policy, in linear
STATIC and NLSTATIC.

Bars: displacements within 1e-8 of the largest, the 0.log summaries
within 1e-8, Newton iterations and FSTR.sta equal (NLSTATIC), CG
iterations within one (STATIC).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import frontistr_tpu.user as juser
import frontistr_tpu_torch.user as tuser
from frontistr_tpu_torch.meshgen import box_hex8

from _torch_decks import run_both
from test_torch_hyper import check_static

ORTHO = ("!ELASTIC, TYPE=ORTHOTROPIC\n 200000., 100000., 50000., 0.3, 0.2,"
         " 0.25, 40000., 30000., 20000.\n")
ORIENT = ("!SECTION, SECNUM=1, ORIENTATION=OR1\n!ORIENTATION, NAME=OR1, "
          "DEFINITION=COORDINATES\n 0.6, 0.8, 0.0,  -0.8, 0.6, 0.5,  "
          "0.0, 0.0, 0.0\n")
TEMP_EL = ("!ELASTIC\n 210000.0, 0.30, 0.0\n 150000.0, 0.28, 100.0\n"
           " 90000.0, 0.25, 300.0\n!EXPANSION_COEFF\n 1.2e-5\n")
CNT = ("!VERSION\n 3\n!SOLUTION, TYPE={sol}\n{head}!BOUNDARY\n"
       " X0, 1, 3, 0.0\n!CLOAD\n X1, 3, {load}\n X1, 1, {pull}\n{temp}"
       "!MATERIAL, NAME=M1\n{mat}{tail}!STEP, SUBSTEPS=2\n BOUNDARY, 1\n"
       " LOAD, 1\n!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
       " 1.0e-8, 1.0, 0.0\n!END\n")


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", "f64")
    monkeypatch.setenv("FRONTISTR_TPU_REORDER", "1")
    return monkeypatch


@pytest.fixture
def registries():
    juser.clear()
    tuser.clear()
    yield
    juser.clear()
    tuser.clear()


def _check(ot, oj, wd, wj, sol):
    if sol == "NLSTATIC":
        check_static(ot, oj, wd, wj)
        return
    check_static(ot, oj, wd, wj, newton=False)
    assert abs(ot["static"].iters - int(oj["static"].iters)) <= 1


@pytest.mark.parametrize("sol", ["STATIC", "NLSTATIC"])
def test_ortho_orientation_matches_jax(tmp_path, env, sol):
    ot, oj, wd, wj = run_both(tmp_path, box_hex8(3, 2, 2), CNT.format(
        sol=sol, head="", load=-300.0, pull=200.0, temp="", mat=ORTHO,
        tail=ORIENT))
    D = ot["model"].blocks[0].D[0]
    assert not np.allclose(D[3:, :3], 0)     # the frame couples them
    _check(ot, oj, wd, wj, sol)


@pytest.mark.parametrize("sol", ["STATIC", "NLSTATIC"])
def test_temperature_dependent_elastic_matches_jax(tmp_path, env, sol):
    """E(T), nu(T) interpolated at every gauss point of a temperature
    field that varies over the box (X1 hot), with its thermal load."""
    ot, oj, wd, wj = run_both(tmp_path, box_hex8(3, 2, 2), CNT.format(
        sol=sol, head="!REFTEMP\n 0.0\n", load=-300.0, pull=0.0,
        temp="!TEMPERATURE\n ALL, 50.0\n X1, 250.0\n", mat=TEMP_EL,
        tail=""))
    assert ot["model"].blocks[0].D.ndim == 4
    _check(ot, oj, wd, wj, sol)


def _register(E_, nu):
    lam = E_ * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E_ / (2 * (1 + nu))
    D6 = np.zeros((6, 6))
    D6[:3, :3] = lam
    D6[np.arange(3), np.arange(3)] += 2 * mu
    D6[np.arange(3, 6), np.arange(3, 6)] = mu

    @juser.register_umat("M1")
    def jumat(matl, strain, stress, fstat, dtime, ttime):
        D = jnp.asarray(D6) * matl[0]
        return D, D @ strain, fstat + 1.0

    @tuser.register_umat("M1")
    def tumat(matl, strain, stress, fstat, dtime, ttime):
        D = torch.as_tensor(D6, dtype=strain.dtype,
                            device=strain.device) * matl[0]
        return (D.expand(strain.shape + (6,)),
                torch.einsum("kl,...l->...k", D, strain), fstat + 1.0)

    def uload(coords, t):
        f = np.zeros((len(coords), 3))
        f[:, 1] = 0.5 * np.asarray(coords)[:, 0]
        return f
    juser.register_uload(uload)
    tuser.register_uload(uload)


def test_umat_and_uload_match_jax(tmp_path, env, registries):
    """A !USER_MATERIAL block (isotropic elasticity scaled by the card's
    constant, one status value counting updates) and a uload of 0.5 x in
    y, each registered in both packages; NLSTATIC, INFINITE."""
    _register(210000.0, 0.3)
    ot, oj, wd, wj = run_both(tmp_path, box_hex8(3, 2, 2), CNT.format(
        sol="NLSTATIC", head="", load=-300.0, pull=0.0, temp="",
        mat="!USER_MATERIAL, NSTATUS=1, INFINITE\n 1.5\n", tail=""))
    assert ot["model"].blocks[0].material.mtype == "USERMATERIAL"
    f = ot["model"].f_ext.reshape(-1, 3)
    assert np.isclose(f[:, 1].sum(), 0.5 * ot["model"].coords[:, 0].sum())
    check_static(ot, oj, wd, wj)


def test_user_module_env(tmp_path, env, registries, monkeypatch):
    """FRONTISTR_TPU_USER_MODULE names a file that registers the port's
    umat; without one a !USER_MATERIAL deck raises naming the
    material."""
    from frontistr_tpu_torch.run import run_directory
    from _torch_decks import write_deck
    cnt = CNT.format(sol="NLSTATIC", head="", load=-300.0, pull=0.0,
                     temp="", mat="!USER_MATERIAL, NSTATUS=1, INFINITE\n"
                     " 1.0\n", tail="")
    wd = write_deck(tmp_path / "w", box_hex8(2, 1, 1), cnt)
    with pytest.raises(ValueError, match="M1"):
        run_directory(wd, device="cpu")
    mod = tmp_path / "umod.py"
    mod.write_text(
        "import torch\nimport frontistr_tpu_torch.user as u\n"
        "@u.register_umat('M1')\n"
        "def f(matl, e, s, fs, dt, t):\n"
        "    D = 1000.0 * torch.eye(6, dtype=e.dtype)\n"
        "    return D.expand(e.shape + (6,)), e @ D, fs\n")
    monkeypatch.setenv("FRONTISTR_TPU_USER_MODULE", str(mod))
    res = run_directory(wd, device="cpu")["static"]
    assert np.isfinite(res.u).all() and np.abs(res.u).max() > 0
