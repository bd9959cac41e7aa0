"""The hyperelastic materials (NEOHOOKE, MOONEY-RIVLIN, ARRUDA-BOYCE,
``fem/hyper.py``) in NLSTATIC, the port against the JAX package on the
CPU through ``run_directory``: a shuffled ``box_hex8(3, 2, 2)`` (hex8,
B-bar under nlgeom) and a tet10 box, X0 fixed, X1 loaded in z, the f64
policy, total Lagrange.  Then the laws' stress and tangent against the
JAX package's at random strains, and the refusal of a 2-D
hyperelastic deck.

Bars: displacements within 1e-8 of the largest, the 0.log summaries
within 1e-8, Newton iterations and FSTR.sta equal; S and D at the
gauss-point level within 1e-10 relative (both are float64 autodiff of
the same energy).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from frontistr_tpu.fem import hyper as jhyper
from frontistr_tpu.io import logio as jlogio
from frontistr_tpu_torch.fem import hyper
from frontistr_tpu_torch.meshgen import box_hex8, box_plane
from frontistr_tpu_torch.run import run_directory

from _torch_decks import run_both, tet10_box, write_plane_deck

LAWS = {"NEOHOOKE": "!HYPERELASTIC, TYPE=NEOHOOKE\n 1.0, 1.0\n",
        "MOONEY-RIVLIN": "!HYPERELASTIC, TYPE=MOONEY-RIVLIN\n"
                         " 40000.0, 5000.0, 1.2e-5\n",
        "ARRUDA-BOYCE": "!HYPERELASTIC, TYPE=ARRUDA-BOYCE\n"
                        " 80000.0, 2.5, 1.2e-5\n"}
CNT = ("!VERSION\n 3\n!SOLUTION, TYPE=NLSTATIC\n!BOUNDARY\n"
       " X0, 1, {ndof}, 0.0\n!CLOAD\n X1, {ldof}, {load}\n"
       "!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n{law}"
       "!STEP, SUBSTEPS=2\n BOUNDARY, 1\n LOAD, 1\n"
       "!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
       " 1.0e-8, 1.0, 0.0\n!END\n")


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", "f64")
    monkeypatch.setenv("FRONTISTR_TPU_REORDER", "1")
    return monkeypatch


def summaries_close(wd, wj, tol=1e-8):
    a = jlogio.parse_log_summaries(os.path.join(wd, "0.log"))
    b = jlogio.parse_log_summaries(os.path.join(wj, "0.log"))
    assert a.keys() == b.keys()
    for sec in a:
        assert a[sec].keys() == b[sec].keys()
        scale = max(max(abs(v) for v in pair) for pair in b[sec].values())
        for k, pair in a[sec].items():
            assert np.allclose(pair, b[sec][k], rtol=0,
                               atol=tol * max(scale, 1e-300)), (sec, k)


def check_static(ot, oj, wd, wj, newton=True):
    res, jres = ot["static"], oj["static"]
    uj = np.asarray(jres.u)
    assert res.u.shape == uj.shape and np.isfinite(res.u).all()
    assert np.abs(res.u - uj).max() <= 1e-8 * np.abs(uj).max()
    if newton:
        assert res.iters == int(jres.iters) >= 2
        with open(os.path.join(wd, "FSTR.sta")) as a, \
                open(os.path.join(wj, "FSTR.sta")) as b:
            assert a.read() == b.read()
    summaries_close(wd, wj)


@pytest.mark.parametrize("law", list(LAWS))
@pytest.mark.parametrize("mesh", ["hex8", "tet10"])
def test_hyper_matches_jax(tmp_path, env, law, mesh):
    m = box_hex8(3, 2, 2) if mesh == "hex8" else tet10_box(2, 2, 1)
    ot, oj, wd, wj = run_both(tmp_path, m, CNT.format(
        ndof=3, ldof=3, load=-400.0 if mesh == "hex8" else -150.0,
        law=LAWS[law]))
    assert ot["model"].blocks[0].material.mtype == law
    check_static(ot, oj, wd, wj)


@pytest.mark.parametrize("law,consts", [
    ("NEOHOOKE", (210000.0, 0.3)),
    ("MOONEY-RIVLIN", (40000.0, 5000.0, 1.2e-5)),
    ("ARRUDA-BOYCE", (80000.0, 2.5, 1.2e-5))])
def test_hyper_laws_match_jax(law, consts):
    E = np.random.default_rng(7).uniform(-0.05, 0.05, (40, 6))
    pk2, tan = hyper.make_hyper_fns(law, consts)
    jpk2, jtan = jhyper.make_hyper_fns(law, consts)
    S, D = pk2(torch.as_tensor(E)), tan(torch.as_tensor(E))
    jS, jD = np.asarray(jpk2(jnp.asarray(E))), np.asarray(jtan(jnp.asarray(E)))
    assert S.shape == (40, 6) and D.shape == (40, 6, 6)
    assert np.abs(S.numpy() - jS).max() <= 1e-10 * np.abs(jS).max()
    assert np.abs(D.numpy() - jD).max() <= 1e-10 * np.abs(jD).max()


def test_hyper_on_plane_elements_raises(tmp_path, env):
    """The laws are 3-D (six strain components): a 2-D block of one
    raises, as the JAX package fails on it."""
    wd = write_plane_deck(tmp_path, box_plane(3, 2), CNT.format(
        ndof=2, ldof=2, load=-10.0, law=LAWS["MOONEY-RIVLIN"]))
    with pytest.raises(NotImplementedError, match="MOONEY-RIVLIN"):
        run_directory(wd, device="cpu")
