"""!SOLVER METHOD=DIRECT, DUMPTYPE and ESTCOND in the port against the
JAX package on the CPU (``solver/direct.py``, ``solver/dump.py``,
``solver/cond.py``): linear STATIC, NLSTATIC (with !EQUATION: the
iterative elimination, as in the JAX package), implicit DYNAMIC on both
arms, EIGEN, frequency response, STATICEIGEN and HEAT through
``run_directory``; the dumped MatrixMarket file byte for byte; the
condition estimate within 1e-8.  Also: linear STATIC with DIRECT and
!EQUATION is refused (the JAX package's answer there is not the
constrained one, ROADMAP queue 3 fault 4), and what the port still
lacks raises by name.

Bars: f64 fields within 1e-8 of the largest, Newton and Lanczos counts
equal.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

import frontistr_tpu.run as jrun
from frontistr_tpu.analysis import static as jstatic
from frontistr_tpu.assembly import femop as jfemop
from frontistr_tpu.assembly.model import build_struct_model as jbuild
from frontistr_tpu.io.ctrlio import read_cnt as jread_cnt
from frontistr_tpu.solver.cond import estimate_condition as jestimate
from frontistr_tpu_torch.analysis import static
from frontistr_tpu_torch.assembly import femop
from frontistr_tpu_torch.assembly.model import build_struct_model
from frontistr_tpu_torch.io.ctrlio import read_cnt
from frontistr_tpu_torch.io.neu import write_static_workdir
from frontistr_tpu_torch.meshgen import box_plane
from frontistr_tpu_torch.run import run_directory
from frontistr_tpu_torch.solver.cond import estimate_condition

from _torch_decks import (dyn_deck, heat_deck, heat_mesh, run_both,
                          solid_box, write_heat_deck)
from test_torch_mpc_spring import tie_face

CNT = ("!VERSION\n 3\n!SOLUTION, TYPE={sol}\n!BOUNDARY\n X0, 1, 3, 0.0\n"
       "!CLOAD\n X1, 3, {load}\n!MATERIAL, NAME=M1\n!ELASTIC\n"
       " 210000.0, 0.3\n!STEP, SUBSTEPS=2\n BOUNDARY, 1\n LOAD, 1\n"
       "!SOLVER, METHOD={method}, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
       " 1.0e-8, 1.0, 0.0\n!END\n")
EIGEN = ("!VERSION\n 3\n!SOLUTION, TYPE={sol}\n{dyn}!EIGEN\n 3, 1.0e-8, 60\n"
         "!BOUNDARY\n X0, 1, 3, 0.0\n{loads}!MATERIAL, NAME=M1\n!ELASTIC\n"
         " 210000.0, 0.3\n!DENSITY\n 7.85e-9\n{step}"
         "!SOLVER, METHOD=DIRECT, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
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


@pytest.mark.parametrize("method", ["DIRECT", "MUMPS"])
@pytest.mark.parametrize("sol", ["STATIC", "NLSTATIC"])
def test_direct_static_matches_jax(tmp_path, env, method, sol):
    cnt = CNT.format(sol=sol, load=-300.0, method=method)
    ot, oj, wd, wj = run_both(tmp_path, solid_box(342, 3, 2, 2), cnt)
    res, jres = ot["static"], oj["static"]
    _close(res.u, jres.u)
    assert res.iters == int(jres.iters)
    if sol == "NLSTATIC":
        assert res.iters >= 2
        with open(os.path.join(wd, "FSTR.sta")) as a, \
                open(os.path.join(wj, "FSTR.sta")) as b:
            assert a.read() == b.read()


def test_direct_nlstatic_with_equation_matches_jax(tmp_path, env):
    """METHOD=DIRECT with !EQUATION under Newton: the eliminated CG."""
    mesh = solid_box(341, 3, 2, 2)
    mast = tie_face(mesh)
    cnt = CNT.format(sol="NLSTATIC", load=-300.0, method="DIRECT").replace(
        " X1, 3, -300.0", f" {mast}, 3, -30.0")
    ot, oj, _, _ = run_both(tmp_path, mesh, cnt)
    _close(ot["static"].u, oj["static"].u)
    assert ot["static"].iters == int(oj["static"].iters) >= 2


def test_direct_nlstatic_restart_matches_jax(tmp_path, env):
    """METHOD=DIRECT under Newton with !RESTART, FREQUENCY=1 (formerly
    refused): the answer and the Newton counts unchanged, a checkpoint a
    substep, and each package's checkpoint read by the other."""
    from frontistr_tpu.io.restart import load_restart as jload
    from frontistr_tpu_torch.io.restart import load_restart
    cnt = CNT.format(sol="NLSTATIC", load=-300.0, method="DIRECT").replace(
        "!END\n", "!RESTART, FREQUENCY=1\n!END\n")
    ot, oj, wd, wj = run_both(tmp_path, solid_box(342, 3, 2, 2), cnt)
    _close(ot["static"].u, oj["static"].u)
    assert ot["static"].iters == int(oj["static"].iters) >= 2
    pt, pj = (os.path.join(d, "restart.npz") for d in (wd, wj))
    a, b = load_restart(pj), jload(pt)
    assert int(a["step_count"]) == int(b["step_count"]) == 2
    _close(b["u"], a["u"])
    assert sorted(a["states"][0]) == sorted(b["states"][0])


def test_direct_static_with_equation_is_refused(tmp_path, env):
    """Linear STATIC with DIRECT and !EQUATION: the JAX package solves
    without the elimination and then overwrites the dependent dofs; its
    answer differs from the eliminated CG's by more than the answer
    itself on this deck (2.9 times the largest displacement).  The port
    raises for the pair."""
    mesh = solid_box(361, 3, 2, 2)
    mast = tie_face(mesh)
    cnt = CNT.format(sol="STATIC", load=-300.0, method="DIRECT").replace(
        " X1, 3, -300.0", f" {mast}, 3, -30.0")
    with pytest.raises(NotImplementedError, match="DIRECT with !EQUATION"):
        run_both(tmp_path / "a", mesh, cnt)
    wj = str(tmp_path / "a" / "jax")
    uj_direct = np.asarray(jrun.run_directory(wj)["static"].u)
    with open(os.path.join(wj, "case.cnt"), "w") as f:
        f.write(cnt.replace("METHOD=DIRECT", "METHOD=CG"))
    uj_cg = np.asarray(jrun.run_directory(wj)["static"].u)
    assert np.abs(uj_direct - uj_cg).max() > 1.0 * np.abs(uj_cg).max()


@pytest.mark.parametrize("scan", ["1", "0"])
def test_direct_implicit_dynamics_matches_jax(tmp_path, env, scan):
    """Newmark with one host factor of c1 K + c2 M: once a run on the
    linear arm (scan "1"), every iteration on the Newton arm ("0")."""
    env.setenv("FRONTISTR_TPU_IMPLICIT_SCAN", scan)
    cnt = dyn_deck(eqa=1, n_step=4, dt=1e-6, ray_m=1e3, ray_k=1e-9,
                   loads="!CLOAD\n X1, 3, -1.0\n").replace("METHOD=CG",
                                                          "METHOD=DIRECT")
    ot, oj, _, _ = run_both(tmp_path, solid_box(361, 3, 2, 2), cnt)
    for name in ("u", "vel", "acc"):
        _close(getattr(ot["dynamic"], name), getattr(oj["dynamic"], name))


def _eigen_mesh():
    return solid_box(361, 4, 2, 2, lx=400.0, ly=100.0, lz=100.0)


@pytest.mark.parametrize("sol", ["EIGEN", "STATICEIGEN"])
def test_direct_eigen_matches_jax(tmp_path, env, sol):
    kw = dict(sol=sol, dyn="", loads="", step="")
    if sol == "STATICEIGEN":
        kw.update(loads="!CLOAD\n X1, 3, -50.0\n",
                  step="!STEP, SUBSTEPS=2, CONVERG=1.0e-8\n")
    ot, oj, _, _ = run_both(tmp_path, _eigen_mesh(), EIGEN.format(**kw))
    et, ej = ot["eigen"], oj["eigen"]
    assert et.iters == ej.iters
    np.testing.assert_allclose(et.eigenvalues, ej.eigenvalues, rtol=1e-8)
    if sol == "STATICEIGEN":
        _close(ot["static"].u, oj["static"].u)


def test_direct_frequency_response_matches_jax(tmp_path, env):
    dyn = "!DYNAMIC\n 11, 2\n 1000.0, 40000.0, 20, 1.0\n 0.5, 0.25\n" \
          " 1, 1, 3.0, 2.0e-6\n"
    cnt = EIGEN.format(sol="DYNAMIC", dyn=dyn, step="",
                       loads="!FLOAD, LOAD CASE=1\n X1, 3, 1.0\n")
    ot, oj, _, _ = run_both(tmp_path, _eigen_mesh(), cnt)
    for name in ("disp_amp_max", "vel_amp_max", "acc_amp_max"):
        np.testing.assert_allclose(getattr(ot["freq"], name),
                                   getattr(oj["freq"], name), rtol=1e-8)


@pytest.mark.parametrize("transient", [False, True])
def test_direct_heat_matches_jax(tmp_path, env, transient):
    """HEAT with K + C/dt refactored at every fixed-point pass."""
    mesh = heat_mesh("hex8")
    cnt = heat_deck(mesh, transient=transient).replace("METHOD=CG",
                                                       "METHOD=DIRECT")
    wd = write_heat_deck(tmp_path / "port", mesh, cnt)
    wj = str(tmp_path / "jax")
    shutil.copytree(wd, wj)
    hj = jrun.run_directory(wj)["heat"]
    ht = run_directory(wd, device="cpu")["heat"]
    assert (ht.steps, ht.iters) == (hj.steps, hj.iters)
    _close(ht.T, hj.T)


def _models(tmp_path, etype=341):
    """The JAX and port models of a small STATIC deck with a spring."""
    p = tmp_path / "case.cnt"
    p.write_text(CNT.format(sol="STATIC", load=-1.0, method="CG").replace(
        "!MATERIAL", "!SPRING\n 1, 2, 40.0\n!MATERIAL"))
    mesh = solid_box(etype, 2, 2, 2)
    return (jbuild(mesh, jread_cnt(str(p))),
            build_struct_model(mesh, read_cnt(str(p)), device="cpu"))


@pytest.mark.parametrize("etype", [341, 362])
def test_dump_matches_jax(tmp_path, monkeypatch, etype):
    """DUMPTYPE=MM: the port's file (K1's cluster slots read out as
    scalar ELL blocks) against the JAX package's (its ELL assembly), the
    spring block included: byte-equal for tet4; for hex20, whose
    27-point element matrices differ from the JAX package's in the last
    bits, the same entries with values within 1e-12 of the largest."""
    jm, pm = _models(tmp_path, etype)
    for d, m, solve in (("jax", jm, jstatic.solve_linear),
                        ("port", pm, None)):
        os.makedirs(tmp_path / d)
        monkeypatch.chdir(tmp_path / d)
        m.cfg.solver.dumptype = "MM"
        if solve is not None:
            solve(m)
        else:
            static.solve_linear(m, static.compute_element_stiffness(m))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names and names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        with open(tmp_path / "jax" / name) as a, \
                open(tmp_path / "port" / name) as b:
            want, got = a.read(), b.read()
        if etype == 341:
            assert got == want
            continue
        w = [ln.split() for ln in want.splitlines()]
        g = [ln.split() for ln in got.splitlines()]
        assert [r[:2] for r in g] == [r[:2] for r in w]
        wv = np.asarray([float(r[2]) for r in w[2:]])
        gv = np.asarray([float(r[2]) for r in g[2:]])
        assert np.abs(gv - wv).max() <= 1e-12 * np.abs(wv).max()


def test_estcond_matches_jax(tmp_path, capsys):
    """ESTCOND: the k-step Lanczos estimate of the block-Jacobi-
    preconditioned operator, within 1e-8 of the JAX package's, and the
    line it prints."""
    import jax.numpy as jnp
    jm, pm = _models(tmp_path)
    jk = jstatic.compute_element_stiffness(jm)
    jop = jfemop.from_model(jm, jk)
    want = jestimate(jop.apply_constrained, jm.n_dof_total,
                     M=jop.block_jacobi())
    kes = static.compute_element_stiffness(pm)
    op = femop.from_model(pm, kes)
    got = estimate_condition(op.apply_constrained, pm.n_dof_total,
                             M=op.block_jacobi())
    assert abs(got - want) <= 1e-8 * want
    jm.cfg.solver.estcond = pm.cfg.solver.estcond = 1
    capsys.readouterr()
    jstatic.solve_linear(jm)
    line_j = [ln for ln in capsys.readouterr().out.splitlines()
              if "Condition number" in ln]
    static.solve_linear(pm, kes)
    line_t = [ln for ln in capsys.readouterr().out.splitlines()
              if "Condition number" in ln]
    assert line_t == line_j and len(line_t) == 1


STILL_UNPORTED = {
    "embed": ("!EMBED, NAME=EM1\n X1, X0\n", "STATIC", {}, "EMBED"),
    # the id predates the shell port: the case is the truss 301, an
    # element type the port does not run
    "shell_731": ("", "STATIC", {}, "element type 301"),
}


@pytest.mark.parametrize("case", list(STILL_UNPORTED))
def test_still_unported_raise_by_name(tmp_path, env, case):
    """What the port still lacks raises NotImplementedError naming it:
    !EMBED (the JAX package warns and drops it) and an element type
    outside the port (a truss 301 block)."""
    extra, sol, envs, msg = STILL_UNPORTED[case]
    for k, v in envs.items():
        env.setenv(k, v)
    cnt = CNT.format(sol=sol, load=-1.0, method="CG")
    cnt = cnt.replace("!MATERIAL", extra + "!MATERIAL")
    mesh = solid_box(361, 2, 2, 2)
    if case == "shell_731":
        mesh = box_plane(3, 2)
        b = mesh.blocks[0]
        mesh.blocks = [dataclasses.replace(b, etype=301, conn=b.conn[:, :2],
                                           conn_hecmw=b.conn[:, :2])]
    wd = str(tmp_path / "wd")
    write_static_workdir(wd, mesh, cnt)
    with pytest.raises(NotImplementedError, match=msg):
        run_directory(wd, device="cpu")
