"""!EQUATION (MPC), !SPRING and ROT_CENTER in the port against the JAX
package on the CPU: the model build (spring blocks, rotational
boundary rows, torque loads), the elimination's reduction against the
JAX package's ``mpc_Tt``, and whole decks through ``run_directory`` in
STATIC and NLSTATIC (``ROT_CENTER``); NLSTATIC in both solve policies,
implicit DYNAMIC, EIGEN, frequency response and HEAT with the tied
plate are in ``test_torch_mpc_spring_dyn.py``.

The decks tie the z displacement of every node of the X1 face to one
master node (a rigid end plate), load the master and hold it by a
spring to the ground.  Bars: f64 fields within 1e-8 of the largest,
Newton, Lanczos and fixed-point counts equal, CG counts within one in
the f64 policy and within 2 + 10% in the mixed one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frontistr_tpu.assembly import extras as jextras
from frontistr_tpu.assembly.model import build_struct_model as jbuild
from frontistr_tpu.io.ctrlio import read_cnt as jread_cnt
from frontistr_tpu_torch.assembly import extras
from frontistr_tpu_torch.assembly.model import build_struct_model
from frontistr_tpu_torch.io.ctrlio import read_cnt
from frontistr_tpu_torch.io.meshio import Equation

from _torch_decks import run_both, solid_box

STATIC = ("!VERSION\n 3\n!SOLUTION, TYPE={sol}\n!BOUNDARY\n X0, 1, 3, 0.0\n"
          "{bc}!CLOAD{cl}\n {load}\n!SPRING\n {mast}, 3, 50.0\n"
          "!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n!STEP, SUBSTEPS=2\n"
          " BOUNDARY, 1\n LOAD, 1\n!SOLVER, METHOD=CG, ITERLOG=NO, "
          "TIMELOG=NO\n 10000, 1\n 1.0e-8, 1.0, 0.0\n!END\n")


def tie_face(mesh, group="X1", dof=3):
    """Tie ``dof`` of every node of ``group`` to the group's first node by
    1:-1 equations; returns the master's node id."""
    nodes = mesh.node_groups[group]
    m = int(nodes[0])
    mesh.equations = [Equation(np.asarray([int(n), m]),
                               np.asarray([dof, dof]),
                               np.asarray([1.0, -1.0]), 0.0)
                      for n in nodes[1:]]
    return int(mesh.node_ids[m])


def _deck(mesh, sol="STATIC", load=None, bc="", cl=""):
    mast = tie_face(mesh)
    return STATIC.format(sol=sol, bc=bc, cl=cl, mast=mast,
                         load=load or f"{mast}, 3, -20.0")


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", "f64")
    monkeypatch.setenv("FRONTISTR_TPU_REORDER", "1")
    return monkeypatch


def _close(a, b, rel=1e-8):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.isfinite(a).all()
    assert np.abs(a - b).max() <= rel * np.abs(b).max()


def _center(mesh, side="X1"):
    """Node group CEN: the node at the middle of the face ``side``."""
    c = mesh.coords
    x = c[:, 0].max() if side == "X1" else c[:, 0].min()
    mid = np.array([x, c[:, 1].mean(), c[:, 2].mean()])
    mesh.node_groups["CEN"] = np.asarray(
        [np.argmin(np.linalg.norm(c - mid, axis=1))], np.int64)
    return mesh


def test_model_extras_and_rotation_match_jax(tmp_path):
    """Spring blocks, the rotational !BOUNDARY rows folded into the
    Dirichlet set, and a torque !CLOAD, against the JAX model."""
    mesh = _center(solid_box(361, 3, 2, 2), "X0")
    p = tmp_path / "case.cnt"
    p.write_text(_deck(mesh, bc="!BOUNDARY, ROT_CENTER=CEN\n X1, 1, 1, 0.1\n",
                       cl=", ROT_CENTER=CEN", load="X1, 3, 7.0"))
    jm = jbuild(mesh, jread_cnt(str(p)))
    pm = build_struct_model(mesh, read_cnt(str(p)), device="cpu")
    for name in ("fixed_dofs", "fixed_vals", "f_ext"):
        np.testing.assert_array_equal(getattr(pm, name), getattr(jm, name))
    assert len(pm.rot_bcs) == len(jm.rot_bcs) == 1
    for a, b in zip(pm.extras, jm.extras):
        assert len(a) == len(b) == 1
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_mpc_reduction_matches_jax():
    """``mpc_T``/``mpc_Tt``/``mpc_recover`` on random vectors, many
    dependents on one master and a three-term equation, against the JAX
    package's functions: equal to the last bit on the CPU."""
    mesh = solid_box(361, 3, 2, 2)
    tie_face(mesh)
    a, b, c = (int(v) for v in mesh.node_groups["X0"][:3])
    mesh.equations.append(Equation(np.asarray([a, b, c]),
                                   np.asarray([1, 2, 1]),
                                   np.asarray([2.0, -0.5, 1.5]), 0.25))
    n = mesh.n_node * 3
    m = extras.mpc_arrays(mesh, 3, n, "cpu")
    jm = jextras.mpc_arrays(mesh, 3, n)
    y = np.random.default_rng(0).standard_normal(n)
    yt, yj = torch.as_tensor(y), jnp.asarray(y)
    for f, jf in ((extras.mpc_T, jextras.mpc_T),
                  (extras.mpc_Tt, jextras.mpc_Tt)):
        np.testing.assert_array_equal(f(m, yt).numpy(), np.asarray(jf(jm, yj)))
    np.testing.assert_array_equal(
        extras.mpc_recover(m, yt, 0.5).numpy(),
        np.asarray(jextras.mpc_recover(jm, yj, 0.5)))


@pytest.mark.parametrize("etype", (341, 361, 362))
def test_static_mpc_spring_matches_jax(tmp_path, env, etype):
    """Linear STATIC: the elimination with block-Jacobi CG (the hex8 box
    leaves the stencil arm, as in the JAX package).  The port's
    preconditioner is restricted to the reduced space (ROADMAP fault 5),
    so its CG takes fewer iterations than the JAX package's; with the
    JAX package's preconditioner it takes the same (below)."""
    mesh = solid_box(etype, 3, 2, 2 if etype != 362 else 1)
    ot, oj, _, _ = run_both(tmp_path, mesh, _deck(mesh))
    res, jres = ot["static"], oj["static"]
    _close(res.u, jres.u)
    assert res.iters < int(jres.iters)
    u = res.u.reshape(-1, 3)
    assert np.ptp(u[ot["mesh"].node_groups["X1"], 2]) <= \
        1e-10 * np.abs(u).max()
    # the JAX package's preconditioner: block-Jacobi of the whole K on
    # the eliminated operator
    from frontistr_tpu_torch.analysis import static
    from frontistr_tpu_torch.assembly import femop, operators
    from frontistr_tpu_torch.solver.cg import pcg
    model = ot["model"]
    op = femop.from_model(model, static.compute_element_stiffness(model))
    n = model.n_dof_total
    f = torch.as_tensor(model.f_ext)
    u_fix = torch.as_tensor(operators.full_fixed_vector(
        n, model.fixed_dofs, model.fixed_vals))
    m = extras.mpc_arrays(model.mesh, 3, n, "cpu")
    b = extras.mpc_reduce_rhs(m, op.apply_constrained,
                              op.constrained_rhs(f, u_fix), 1.0)
    r = pcg(extras.mpc_wrap(m, op.apply_constrained), b,
            M=op.block_jacobi(), tol=1e-8, maxiter=10000)
    assert abs(r.iters - int(jres.iters)) <= 1
    _close(extras.mpc_recover(m, r.x, 1.0).numpy().reshape(-1, 3), jres.u)


def test_nlstatic_rotation_matches_jax(tmp_path, env):
    """!BOUNDARY, ROT_CENTER under nlgeom: the X1 face turned 0.2 rad
    about x, re-rotated from the current positions every substep."""
    mesh = _center(solid_box(361, 3, 2, 2))
    cnt = STATIC.format(sol="NLSTATIC", mast="CEN", cl="",
                        bc="!BOUNDARY, ROT_CENTER=CEN\n X1, 1, 1, 0.2\n",
                        load="CEN, 3, 0.0")
    ot, oj, _, _ = run_both(tmp_path, mesh, cnt, ngroups=("X0", "X1", "CEN"))
    _close(ot["static"].u, oj["static"].u)
    assert ot["static"].iters == int(oj["static"].iters) >= 2


def test_static_torque_matches_jax(tmp_path, env):
    """A torque !CLOAD, ROT_CENTER on the X1 face, about z through the
    X0 face's middle."""
    mesh = _center(solid_box(361, 3, 2, 2), "X0")
    cnt = STATIC.format(sol="STATIC", mast="CEN", bc="",
                        cl=", ROT_CENTER=CEN", load="X1, 3, 7.0")
    ot, oj, _, _ = run_both(tmp_path, mesh, cnt, ngroups=("X0", "X1", "CEN"))
    _close(ot["static"].u, oj["static"].u)
