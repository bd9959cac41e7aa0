"""The 2-D solids (231 tri3, 232 tri6, 241 quad4, 242 quad8) in linear
STATIC, the port against the JAX package on the CPU through
``run_directory``: a shuffled ``box_plane(4, 2)`` 2 x 1 (the quadratic
types with mid-edge nodes) of thickness 0.5, each sect_opt (0 plane
stress, 1 plane strain, 2 axisymmetric), X0 fixed, X1 loaded in y, the
f64 policy; !DLOAD edge pressure (a surface group and a P face) and
body forces; quad4 under !PLASTIC; the axisymmetric hoop-strain caveat;
the refusals.
NLSTATIC: ``test_torch_solids2d_nl.py``; dynamics and eigen:
``test_torch_solids2d_dyn.py``.

Bars: displacements within 1e-8 of the largest, the 0.log summaries
within 1e-8 (values; tied extremes may name another node), CG
iterations within one, element stresses within 1e-8.
"""

import numpy as np
import pytest
import torch

from frontistr_tpu_torch.elements.tables import get_table
from frontistr_tpu_torch.fem import material as mat
from frontistr_tpu_torch.fem import solid
from frontistr_tpu_torch.meshgen import box_plane
from frontistr_tpu_torch.run import run_directory

from _torch_decks import run_both_plane, write_plane_deck
from test_torch_hyper import check_static

ETYPES = (231, 232, 241, 242)
OPTS = (0, 1, 2)
PLANE = ("!VERSION\n 3\n!SOLUTION, TYPE={sol}\n!BOUNDARY\n X0, 1, 2, 0.0\n"
         "{loads}!MATERIAL, NAME=M1\n!ELASTIC{el}\n 210000.0, 0.3\n"
         "!DENSITY\n 7.85e-9\n{plastic}!STEP, SUBSTEPS={sub}\n BOUNDARY, 1\n"
         " LOAD, 1\n!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
         " 1.0e-8, 1.0, 0.0\n!END\n")


def plane_cnt(sol="STATIC", loads="!CLOAD\n X1, 2, -100.0\n", el="",
              plastic="", sub=2):
    return PLANE.format(sol=sol, loads=loads, el=el, plastic=plastic,
                        sub=sub)


def plane_mesh(etype, opt):
    return box_plane(4, 2, lx=2.0, etype=etype, thick=0.5, opt=opt)


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", "f64")
    monkeypatch.setenv("FRONTISTR_TPU_REORDER", "1")
    return monkeypatch


def check_linear(ot, oj, wd, wj):
    check_static(ot, oj, wd, wj, newton=False)
    res, jres = ot["static"], oj["static"]
    assert abs(res.iters - int(jres.iters)) <= 1
    es, ej = res.elem_stress, np.asarray(jres.elem_stress)
    assert es.shape == ej.shape and es.shape[1] == 3     # 11, 22, 12
    assert np.abs(es - ej).max() <= 1e-8 * np.abs(ej).max()


@pytest.mark.parametrize("etype", ETYPES)
@pytest.mark.parametrize("opt", OPTS)
def test_plane_static_matches_jax(tmp_path, env, etype, opt):
    ot, oj, wd, wj = run_both_plane(tmp_path, plane_mesh(etype, opt),
                                    plane_cnt())
    m = ot["model"]
    assert (m.dim, m.ndof, m.blocks[0].thick) == (2, 2, 0.5)
    assert m.blocks[0].iset == {0: mat.PLANE_STRESS, 1: mat.PLANE_STRAIN,
                                2: mat.AXISYMMETRIC}[opt]
    check_linear(ot, oj, wd, wj)


@pytest.mark.parametrize("etype", [232, 241])
def test_plane_dload_matches_jax(tmp_path, env, etype):
    """Edge pressure on the surface group EX1 (x = max) and on face 2 of
    element 1, a body force BX and gravity, each over the thickness."""
    loads = ("!DLOAD\n EX1, S, 30.0\n 1, P2, 5.0\n ALL, BX, 2.0\n"
             " ALL, GRAV, 9810.0, 0.0, -1.0, 0.0\n")
    ot, oj, wd, wj = run_both_plane(tmp_path, plane_mesh(etype, 1),
                                    plane_cnt(loads=loads))
    check_linear(ot, oj, wd, wj)


def test_axisymmetric_has_no_hoop_strain():
    """The JAX package's 2-D strain selector has a zero hoop row and no
    2 pi r weight (``frontistr_tpu/fem/isoparam.py:91-97``), and the port
    holds that: on one quad4 ring element under u_r = c r the hoop strain
    u_r / r = c of an axisymmetric solid comes out 0 (ROADMAP, queue 3,
    reference-side caveats)."""
    t = get_table(241)
    x = torch.as_tensor([[[1.0, 0.0], [2.0, 0.0], [2.0, 1.0], [1.0, 1.0]]],
                        dtype=torch.float64)
    u = torch.zeros_like(x)
    u[..., 0] = 1e-3 * x[..., 0]                   # u_r = c r, c = 1e-3
    eps = solid.strains_at_gauss(t, x, u)          # (1, nq, 4)
    assert np.allclose(eps[..., 0].numpy(), 1e-3)  # e_rr = c
    assert np.allclose(eps[..., 3].numpy(), 0.0)   # e_theta: 0, not c


def test_plane_plastic_matches_jax(tmp_path, env):
    """quad4 plane strain under !PLASTIC (MISES, INFINITE), where the
    JAX package runs 2-D plasticity.  Its return map splits the four
    plane components as it splits the six of 3-D (the shear g12 read as
    s33), so past yield Newton crawls: both packages take the same 26
    iterations on this one-substep deck, where an elastic one takes 2-3
    (ROADMAP queue 3)."""
    ot, oj, wd, wj = run_both_plane(
        tmp_path, box_plane(2, 1, lx=2.0, etype=241, thick=0.5, opt=1),
        plane_cnt("NLSTATIC", loads="!CLOAD\n X1, 2, -60.0\n", sub=1,
                  plastic="!PLASTIC, YIELD=MISES, HARDEN=LINEAR, "
                          "INFINITE\n 250.0, 1000.0\n"))
    check_static(ot, oj, wd, wj)
    res = ot["static"]
    assert res.newton.history[-1]["yielded"] > 0 and res.iters > 10


@pytest.mark.parametrize("card,match", [
    ("!PLASTIC, YIELD=MISES\n 250.0, 1000.0\n", "updated Lagrange"),
    ("!VISCOELASTIC\n 0.3, 1.0\n", "VISCOELASTIC"),
    ("!CREEP, TYPE=NORTON\n 1.0e-12, 3.0, 0.0\n", "NORTON")])
def test_plane_unported_materials_raise(tmp_path, env, card, match):
    """A 2-D block of a 3-D law, or !PLASTIC with its default updated
    Lagrange flag (the JAX package's GEOMAT is 3-D only), raises naming
    itself."""
    wd = write_plane_deck(tmp_path, plane_mesh(241, 1),
                          plane_cnt(sol="NLSTATIC", plastic=card))
    with pytest.raises(NotImplementedError, match=match):
        run_directory(wd, device="cpu")
