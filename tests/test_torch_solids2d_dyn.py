"""The 2-D solids in implicit and explicit DYNAMIC (HRZ-lumped mass over
the thickness) and in EIGEN, the port against the JAX package on the
CPU through ``run_directory``, on plane boxes of thickness 0.5 (X0
fixed, X1 loaded in y); a 2-D NLSTATIC deck's result file.

Bars: displacements, velocities and accelerations within 1e-8 of the
largest, eigenvalues within 1e-8 relative, Lanczos iterations equal,
the result file's nodal and element fields within 1e-8.
"""

import os

import numpy as np
import pytest

from frontistr_tpu.io import resfile as jresfile
from frontistr_tpu_torch.io import resfile
from frontistr_tpu_torch.meshgen import box_plane

from _torch_decks import dyn_deck, run_both_plane, write_plane_deck
from test_torch_solids2d import env  # noqa: F401 (a fixture)
from test_torch_solids2d import plane_cnt, plane_mesh

EIGEN = ("!VERSION\n 3\n!SOLUTION, TYPE=EIGEN\n!EIGEN\n 3, 1.0e-8, 60\n"
         "!BOUNDARY\n X0, 1, 2, 0.0\n!MATERIAL, NAME=M1\n!ELASTIC\n"
         " 210000.0, 0.3\n!DENSITY\n 7.85e-9\n"
         "!SOLVER, METHOD=CG, PRECOND=1, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
         " 1.0e-10, 1.0, 0.0\n!END\n")


def _close(a, b, rel=1e-8):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.isfinite(a).all()
    assert np.abs(a - b).max() <= rel * np.abs(b).max()


@pytest.mark.parametrize("etype,eqa,opt", [(241, 1, 1), (242, 1, 0),
                                           (232, 1, 2), (231, 11, 0)])
def test_plane_dynamics_matches_jax(tmp_path, env, etype, eqa, opt):
    """Implicit Newmark with Rayleigh damping (eqa 1), or explicit
    central difference at a tenth of the critical step (eqa 11)."""
    dt = 1e-6 if eqa == 1 else 2e-8
    cnt = dyn_deck(eqa=eqa, n_step=4 if eqa == 1 else 20, dt=dt,
                   ray_m=1e3 if eqa == 1 else 0.0,
                   ray_k=1e-9 if eqa == 1 else 0.0,
                   loads="!CLOAD\n X1, 2, -1.0\n")
    ot, oj, _, _ = run_both_plane(tmp_path, plane_mesh(etype, opt), cnt)
    d, dj = ot["dynamic"], oj["dynamic"]
    assert d.steps == dj.steps
    assert d.u.shape[-1] == 2 or d.u.size == 2 * ot["model"].n_node
    for name in ("u", "vel", "acc"):
        _close(getattr(d, name), getattr(dj, name))


@pytest.mark.parametrize("etype", [232, 242])
def test_plane_eigen_matches_jax(tmp_path, env, etype):
    """Through the library entry points: the JAX package's EIGEN log
    writer indexes a Z column a 2-D deck does not have and fails after
    the solve (ROADMAP queue 3), so its ``run_eigen`` is called without
    a log; the port's run writes its 0.log with Z as 0."""
    from frontistr_tpu.analysis.eigen import run_eigen as jrun_eigen
    from frontistr_tpu.assembly.model import build_struct_model as jbuild
    from frontistr_tpu.io.ctrlio import read_cnt as jread_cnt
    from frontistr_tpu.io.meshio import read_mesh as jread_mesh
    from frontistr_tpu_torch.run import run_directory
    mesh = box_plane(4, 2, lx=300.0, ly=100.0, etype=etype, thick=10.0)
    wd = write_plane_deck(tmp_path, mesh, EIGEN)
    e = run_directory(wd, device="cpu")["eigen"]
    from frontistr_tpu.ordering import maybe_reorder
    jm = jbuild(maybe_reorder(jread_mesh(os.path.join(wd, "mesh.msh"))),
                jread_cnt(os.path.join(wd, "case.cnt")))
    ej = jrun_eigen(jm)
    _close(e.eigenvalues, np.asarray(ej.eigenvalues))
    assert e.iters == int(ej.iters)
    with open(os.path.join(wd, "0.log")) as fh:
        assert "RESULT OF EIGEN VALUE ANALYSIS" in fh.read()


def test_plane_result_file_matches_jax(tmp_path, env):
    cnt = plane_cnt("NLSTATIC", loads="!CLOAD\n X1, 2, -300.0\n")
    cnt = cnt.replace("!END\n", "!WRITE, RESULT\n!END\n")
    ot, oj, wd, wj = run_both_plane(tmp_path, plane_mesh(242, 1), cnt)
    got = resfile.read_result(os.path.join(wd, "mesh.res.0.1"))
    want = jresfile.read_result(os.path.join(wj, "mesh.res.0.1"))
    for (gk, gv), (wk, wv) in zip(got["node_comps"], want["node_comps"]):
        assert gk == wk
        _close(gv, wv)
    for (gk, gv), (wk, wv) in zip(got["elem_comps"], want["elem_comps"]):
        assert gk == wk
        _close(gv, wv)
