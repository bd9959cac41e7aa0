"""The prism (351, 352) and hex20 (362) solids in linear STATIC and
NLSTATIC, the port against the JAX package on the CPU through
``run_directory``: a shuffled ``solid_box(etype, 3, 2, 2)`` (prisms: each
hex split in two; 352 and 362 raised by mid-edge nodes), X0 fixed, X1
loaded in z, the f64 policy.

Bars: displacements within 1e-8 of the largest, the 0.log summaries
equal, Newton iterations and FSTR.sta equal, CG iterations within one
(float64 summation order puts a solve one iteration either side of its
tolerance).  Implicit dynamics, eigen and heat on these types:
``test_torch_solids3d_dyn.py``.
"""

import os

import numpy as np
import pytest

from frontistr_tpu.io import logio as jlogio

from _torch_decks import run_both, solid_box

ETYPES = (351, 352, 362)
CNT = ("!VERSION\n 3\n!SOLUTION, TYPE={sol}\n!BOUNDARY\n X0, 1, 3, 0.0\n"
       "!CLOAD\n X1, 3, {load}\n!MATERIAL, NAME=M1\n!ELASTIC\n"
       " 210000.0, 0.3\n!STEP, SUBSTEPS=2\n BOUNDARY, 1\n LOAD, 1\n"
       "!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
       " 1.0e-8, 1.0, 0.0\n!END\n")


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", "f64")
    monkeypatch.setenv("FRONTISTR_TPU_REORDER", "1")
    return monkeypatch


def _summaries(wd):
    return jlogio.parse_log_summaries(os.path.join(wd, "0.log"))


@pytest.mark.parametrize("etype", ETYPES)
@pytest.mark.parametrize("sol,load", [("STATIC", -100.0),
                                      ("NLSTATIC", -300.0)])
def test_solid_matches_jax(tmp_path, env, etype, sol, load):
    ot, oj, wd, wj = run_both(tmp_path, solid_box(etype, 3, 2, 2),
                              CNT.format(sol=sol, load=load))
    res, jres = ot["static"], oj["static"]
    uj = np.asarray(jres.u)
    assert res.u.shape == uj.shape and np.isfinite(res.u).all()
    assert np.abs(res.u - uj).max() <= 1e-8 * np.abs(uj).max()
    if sol == "STATIC":
        assert abs(res.iters - int(jres.iters)) <= 1
    else:
        assert res.iters == int(jres.iters) >= 2
        with open(os.path.join(wd, "FSTR.sta")) as a, \
                open(os.path.join(wj, "FSTR.sta")) as b:
            assert a.read() == b.read()
    assert _summaries(wd) == _summaries(wj)
