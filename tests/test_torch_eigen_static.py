"""The !EIGENREAD and STATICEIGEN part of the eigen slice of the port
(``analysis/eigen.py``, ``analysis/freq.py``) against the JAX package on
the CPU (split from tests/test_torch_eigen.py, whose helpers it uses, so
that ``--dist loadfile`` spreads the runs over two workers).

- ``!EIGENREAD`` of a JAX-written and of a port-written eigen run
  (``0.log`` and ``.res``): the frequency-response 0.log table within
  1e-8 relative of the JAX runner's on the JAX-written files.
- STATICEIGEN on the beam deck (``run_static_eigen``; and through
  ``run_directory``): the static displacements within 1e-8 of the
  largest, eigenvalues within 1e-8, the same Lanczos iterations; the
  run's ``!WRITE, VISUAL`` PVR picture within the bar of
  ``_torch_vis_decks.assert_pictures_close``.
"""

import os
import shutil

import numpy as np

import frontistr_tpu.run as jrun
from frontistr_tpu.analysis import freq as jfreq
from frontistr_tpu_torch.analysis import freq
from frontistr_tpu_torch.meshgen import box_hex8
from frontistr_tpu_torch.run import run_directory

from _torch_vis_decks import VISUAL, assert_pictures_close
from test_torch_eigen import (FLOAD, _by_id, _eglist, _env,  # noqa: F401
                              _hold_eigen, _mesh, _models, _pair,
                              eigen_deck)


FREQ = ("!VERSION\n 3\n!SOLUTION, TYPE=DYNAMIC\n!DYNAMIC\n 11, 2\n"
        " {f0!r}, {f1!r}, 30, 1.0\n 0.5, 0.25\n 1, 1, 3.0, 2.0e-6\n"
        "!EIGENREAD\n eigen.log\n 1, 5\n!BOUNDARY\n X0, 1, 3, 0.0\n"
        "{loads}!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n!DENSITY\n"
        " 7.85e-9\n!SOLVER, METHOD=CG, PRECOND=1, ITERLOG=NO, TIMELOG=NO\n"
        " 10000, 1\n 1.0e-10, 1.0, 0.0\n!END\n")


def _freq_table(path):
    with open(path) as f:
        lines = f.read().splitlines()
    assert "  modes imported via !EIGENREAD" in lines
    i = next(k for k, ln in enumerate(lines) if "disp_amp_max" in ln)
    return np.asarray([[float(v) for v in ln.split()]
                       for ln in lines[i + 1:] if ln.strip()])


def test_eigenread_matches_jax(tmp_path):
    """The modes of a JAX-written and of a port-written eigen run, read
    by a frequency-response deck's !EIGENREAD."""
    mesh = _mesh("hex8")
    loads = FLOAD.format(node=int(mesh.node_ids[-1]))
    wj, wd = _pair(tmp_path, mesh, eigen_deck(loads=loads))
    oj = jrun.run_directory(wj)
    run_directory(wd, device="cpu")
    fq = oj["eigen"].freq
    cnt = FREQ.format(f0=0.5 * fq[0], f1=1.5 * fq[2], loads=loads)
    for w in (wj, wd):
        shutil.copy(os.path.join(w, "0.log"), os.path.join(w, "eigen.log"))
        with open(os.path.join(w, "case.cnt"), "w") as f:
            f.write(cnt)
    wj2 = str(tmp_path / "jax_read_by_port")
    shutil.copytree(wj, wj2)
    jrun.run_directory(wj)
    want = _freq_table(os.path.join(wj, "0.log"))
    for w in (wj2, wd):
        out = run_directory(w, device="cpu")
        assert len(out["freq"].freqs) == 30
        got = _freq_table(os.path.join(w, "0.log"))
        np.testing.assert_allclose(got, want, rtol=1e-8)


BEAM = dict(sol="STATICEIGEN", nget=4, loads="!CLOAD\n X1, 3, -0.05\n",
            step="!STEP, SUBSTEPS=2, CONVERG=1.0e-8\n")


def _beam():
    return box_hex8(6, 1, 1, lx=6.0, youngs=1000.0, density=1.0)


def test_static_eigen_matches_jax(tmp_path):
    cnt = eigen_deck(**BEAM).replace("210000.0, 0.3", "1000.0, 0.3") \
        .replace("7.85e-9", "1.0")
    jm, tm = _models(tmp_path, _beam(), cnt)
    sj, ej = jfreq.run_static_eigen(jm)
    st, et = freq.run_static_eigen(tm)
    uj = np.asarray(sj.u)
    np.testing.assert_allclose(np.asarray(st.u), uj, rtol=0,
                               atol=1e-8 * np.abs(uj).max())
    assert et.iters == ej.iters
    np.testing.assert_allclose(et.eigenvalues, ej.eigenvalues, rtol=1e-8)
    assert (et.eigenvalues > 0).all()


def test_static_eigen_run_directory_matches_jax(tmp_path):
    cnt = eigen_deck(**BEAM).replace("210000.0, 0.3", "1000.0, 0.3") \
        .replace("7.85e-9", "1.0").replace("!END", VISUAL.format(
            freq="", method="PVR", more="!color_comp_name = MISES\n")
            + "!END")
    wj, wd = _pair(tmp_path, _beam(), cnt)
    oj = jrun.run_directory(wj)
    ot = run_directory(wd, device="cpu")
    assert ot["static"].newton.total_iters == oj["static"].iters
    _hold_eigen(oj, ot)
    uj = _by_id(oj, oj["static"].u)
    np.testing.assert_allclose(_by_id(ot, ot["static"].u), uj, rtol=0,
                               atol=1e-8 * np.abs(uj).max())
    gj = _eglist(os.path.join(wj, "0.log"))
    gt = _eglist(os.path.join(wd, "0.log"))
    np.testing.assert_allclose(gt[:, :3], gj[:, :3], rtol=1e-4)
    assert os.path.exists(os.path.join(wd, "mesh.res.0.1"))
    # !WRITE, VISUAL after STATICEIGEN: the PVR volume of the Mises stress
    assert_pictures_close(os.path.join(wd, "result.bmp"),
                          os.path.join(wj, "result.bmp"))
