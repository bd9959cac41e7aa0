"""Beams 611 (6 dofs a node) and 641 (four 3-dof nodes) of the port
(``fem/beam.py``, the beam arms of the model build, the stiffness and
the stress recovery) against the JAX package on the CPU: the cantilevers
and the axial and torsion deck of ``tests/test_beam.py`` through
``run_directory`` (u within 1e-8 relative, CG count equal, the
Euler-Bernoulli answers), the 641 fiber stresses of a round section, the
bad-reference-vector error, EIGEN of a 611 cantilever, and the Newton
and Newmark drivers on the same models through the library (the JAX
package's 0.log writer fails on a mesh of beams only, and the port
refuses that log by name)."""

import numpy as np
import pytest

from frontistr_tpu_torch.run import run_directory

from _torch_shell_decks import (beam_line, deck, fiber_beam, rel, run_both)

GROUPS = ("FIX", "TIP")
DYN = ("!DYNAMIC\n {eqa}, 1\n 0.0, 0.002, 20, 1.0e-4\n 0.5, 0.25\n"
       " 1, 1, 0.0, 0.0\n 10, 0, 1\n")


@pytest.fixture(autouse=True)
def f64(monkeypatch):
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", "f64")


def test_611_tip_load_axial_and_torsion(tmp_path):
    """611 under a tip load, an axial force and a torque (E 1000, nu 0.3,
    A 1, I 2, J 1, L 10)."""
    cnt = deck(bc=" FIX, 1, 6, 0.0\n",
               loads="!CLOAD\n TIP, 3, -1.0\n TIP, 1, 5.0\n TIP, 4, 2.0\n",
               resid="1.0e-12")
    op, oj, wd, wj = run_both(tmp_path, beam_line(611), cnt, GROUPS)
    a, b = op["static"], oj["static"]
    assert a.iters == b.iters
    assert rel(a.u, b.u) <= 1e-8
    tip = np.argmax(np.abs(a.u[:, 2]))
    np.testing.assert_allclose(a.u[tip, 2], -1000.0 / 6000.0, rtol=1e-8)
    np.testing.assert_allclose(a.u[tip, 4], 100.0 / 4000.0, rtol=1e-8)
    np.testing.assert_allclose(a.u[tip, 0], 0.05, rtol=1e-8)
    np.testing.assert_allclose(a.u[tip, 3], 2.0 * 10.0 / (1000.0 / 2.6),
                               rtol=1e-8)
    assert open(wd + "/0.log").read() == open(wj + "/0.log").read()


def test_641_fiber_stress(tmp_path):
    """The 641 cantilever of a round section: u, the fiber stresses at
    the six angles (element and nodal), the wall stress M r / I and the
    tip deflection P L^3 / 3 E I."""
    cnt = deck(bc=" FIX, 1, 3, 0.0\n", loads="!CLOAD\n TIP, 2, -100.0\n",
               resid="1.0e-12")
    op, oj, _, _ = run_both(tmp_path, fiber_beam(), cnt, GROUPS)
    a, b = op["static"], oj["static"]
    assert a.u.shape[1] == 3 and a.iters == b.iters
    assert rel(a.u, b.u) <= 1e-8
    for k in ("elem_stress", "elem_strain", "elem_mises", "nodal_stress",
              "nodal_mises"):
        assert rel(getattr(a, k), getattr(b, k)) <= 1e-8, k
    r, L, P = 0.05, 1.0, 100.0
    iy = np.pi * r ** 4 / 4.0
    assert abs(np.abs(a.elem_stress).max() - P * L * r / iy) < \
        0.15 * P * L * r / iy
    d_ref = P * L ** 3 / (3 * 210e9 * iy)
    assert abs(np.abs(a.u[:, 1]).max() - d_ref) < 0.02 * d_ref


@pytest.mark.parametrize("etype", [611, 641])
def test_bad_reference_vector(tmp_path, etype):
    """A reference vector along the beam axis: both packages refuse the
    section with the same message."""
    mesh = beam_line(etype, section=(1.0, 0.0, 0.0, 1.0, 2.0, 2.0, 1.0))
    cnt = deck(bc=" FIX, 1, 3, 0.0\n", loads="!CLOAD\n TIP, 2, -1.0\n")
    with pytest.raises(ValueError, match="Bad reference vector"):
        run_both(tmp_path, mesh, cnt, GROUPS)
    with pytest.raises(ValueError, match="Bad reference vector"):
        run_directory(str(tmp_path / "port"), device="cpu")


def test_611_eigen(tmp_path):
    cnt = deck("EIGEN", " FIX, 1, 6, 0.0\n",
               extra="!EIGEN\n 3, 1.0e-8, 60\n", resid="1.0e-12")
    op, oj, _, _ = run_both(tmp_path, beam_line(611, ne=8), cnt, GROUPS)
    a, b = op["eigen"], oj["eigen"]
    assert a.iters == b.iters
    assert rel(a.eigenvalues, b.eigenvalues) <= 1e-8


def _models(tmp_path, mesh, cnt):
    """The JAX package's model of the deck and the port's copy."""
    from frontistr_tpu.assembly.model import build_struct_model as jbuild
    from frontistr_tpu.io.ctrlio import read_cnt as jcnt
    from frontistr_tpu.io.meshio import read_mesh as jread
    from frontistr_tpu_torch.convert import model_from_numpy
    from frontistr_tpu_torch.io.neu import write_static_workdir
    wd = str(tmp_path)
    write_static_workdir(wd, mesh, cnt, ngroups=GROUPS)
    jm = jbuild(jread(wd + "/mesh.msh"), jcnt(wd + "/case.cnt"))
    return jm, model_from_numpy(jm, device="cpu"), wd


def test_newton_and_newmark_through_the_library(tmp_path):
    """611 NLSTATIC in two substeps and 641 implicit dynamics, each
    package's driver on the same model; the port refuses the 0.log the
    JAX package's writer fails on."""
    from frontistr_tpu.analysis.dynamic import run_dynamic as jdyn
    from frontistr_tpu.analysis.nonlinear import run_nonlinear_static as jnl
    from frontistr_tpu_torch.analysis.dynamic import run_dynamic
    from frontistr_tpu_torch.analysis.nonlinear import run_nonlinear_static
    cnt = deck("NLSTATIC", " FIX, 1, 6, 0.0\n", "!CLOAD\n TIP, 3, -1.0\n",
               "!STEP, SUBSTEPS=2\n", resid="1.0e-12")
    jm, tm, wd = _models(tmp_path / "nl", beam_line(611), cnt)
    b, a = jnl(jm), run_nonlinear_static(tm)
    assert a.iters == b.iters == 2
    assert rel(a.u, b.u) <= 1e-8
    with pytest.raises(NotImplementedError, match="beams and solid-shells"):
        run_directory(wd, device="cpu")
    cnt = deck("DYNAMIC", " FIX, 1, 3, 0.0\n", "!CLOAD\n TIP, 2, -100.0\n",
               DYN.format(eqa=1), resid="1.0e-14")
    jm, tm, _ = _models(tmp_path / "dyn", fiber_beam(), cnt)
    b, a = jdyn(jm), run_dynamic(tm)
    for k in ("u", "vel", "acc"):
        assert rel(getattr(a, k), getattr(b, k)) <= 1e-8, k


def test_641_explicit_refused(tmp_path):
    """Explicit dynamics of a 641 model: its rotation carriers have no
    mass and the JAX package's run diverges; the port refuses it."""
    cnt = deck("DYNAMIC", " FIX, 1, 3, 0.0\n", "!CLOAD\n TIP, 2, -100.0\n",
               DYN.format(eqa=11))
    from frontistr_tpu_torch.analysis.dynamic import run_dynamic
    _, tm, _ = _models(tmp_path, fiber_beam(), cnt)
    with pytest.raises(NotImplementedError, match="rotation carriers"):
        run_dynamic(tm)
