"""The Krylov menu and the scalar block-ELL operator, held to the JAX
package on the CPU.

- ``cg.pcg``, ``bicgstab``, ``gmres``, ``gpbicg`` and the dispatcher
  ``solve`` (names and the numeric ids 1-4) on seeded float64 SPD and
  nonsymmetric systems with a Jacobi preconditioner: equal iteration
  counts, x within 1e-10 of max|x|.  GPBiCG is held to the JAX
  package's recurrence with Zhang's t_{k-1} in the update of u (the
  port's; the JAX package's own takes t_{k-2}, and its answer drifts
  from its residual: ROADMAP queue 3, fault 9, shown here too).
- ``ell.from_model``: the (N, W, 3, 3) blocks summed by K1's plain
  version at the ELL profile's plan against the JAX package's
  ``ell.from_model``, within 1e-12 of max|K|, with a spring block; its
  product and block-Jacobi against the JAX package's.
- ``check_solver``: the names the deck reader passes and the JAX
  package's ``solve`` lacks raise by name.
"""

import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from frontistr_tpu.assembly import ell as jell
from frontistr_tpu.assembly.model import build_struct_model as jbuild
from frontistr_tpu.analysis import static as jstatic
from frontistr_tpu.io.ctrlio import read_cnt as jread_cnt
from frontistr_tpu.solver import cg as jcg
from frontistr_tpu_torch.analysis import static
from frontistr_tpu_torch.assembly import ell
from frontistr_tpu_torch.assembly.model import build_struct_model
from frontistr_tpu_torch.io.ctrlio import read_cnt
from frontistr_tpu_torch.meshgen import box_hex8, box_tet4
from frontistr_tpu_torch.solver import cg


def _zhang_gpbicg():
    """The JAX package's ``gpbicg`` with t_{k-1} in the update of u."""
    src = inspect.getsource(jcg.gpbicg)
    fixed = src.replace("M(t0) - M(r)", "M(t) - M(r)")
    assert fixed != src
    ns = {}
    exec(fixed, jcg.__dict__, ns)
    return ns["gpbicg"]


def _system(kind, n=80, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, n))
    a = q @ q.T + n * np.eye(n)
    if kind == "nonsym":
        a = a + 0.3 * np.sqrt(n) * rng.standard_normal((n, n))
    return a, rng.standard_normal(n)


CASES = [(m, k) for m in ("CG", "1", "BICGSTAB", "2", "GMRES", "3",
                          "GPBICG", "4") for k in ("spd", "nonsym")
         if not (m in ("CG", "1") and k == "nonsym")]


@pytest.mark.parametrize("method,kind", CASES)
def test_solvers_match_jax(method, kind):
    a, b = _system(kind)
    d = np.diag(a).copy()
    if method in ("GPBICG", "4"):
        jfn = _zhang_gpbicg()
        want = jfn(lambda x: jnp.asarray(a) @ x, jnp.asarray(b),
                   M=lambda r: r / jnp.asarray(d), tol=1e-10, maxiter=500)
    else:
        want = jcg.solve(method, lambda x: jnp.asarray(a) @ x,
                         jnp.asarray(b), M=lambda r: r / jnp.asarray(d),
                         tol=1e-10, maxiter=500)
    at, dt = torch.as_tensor(a), torch.as_tensor(d)
    got = cg.solve(method, lambda x: at @ x, torch.as_tensor(b),
                   M=lambda r: r / dt, tol=1e-10, maxiter=500)
    xw = np.asarray(want.x)
    assert got.iters == int(want.iters) and got.converged
    assert np.abs(got.x.numpy() - xw).max() <= 1e-10 * np.abs(xw).max()
    assert got.relres <= 1e-10 and float(want.relres) <= 1e-10


CNT = ("!VERSION\n 3\n!SOLUTION, TYPE=STATIC\n!BOUNDARY\n X0, 1, 3, 0.0\n"
       "!CLOAD\n X1, 3, -1.0\n!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n"
       "!SPRING\n 1, 3, 100.0\n"
       "!SOLVER, METHOD=BICGSTAB, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
       " 1.0e-8, 1.0, 0.0\n!END\n")


def _models(tmp_path, mesh, cnt=CNT):
    p = str(tmp_path / "case.cnt")
    with open(p, "w") as fh:
        fh.write(cnt)
    return (jbuild(mesh, jread_cnt(p)),
            build_struct_model(mesh, read_cnt(p), device="cpu"))


@pytest.mark.parametrize("etype", [341, 361])
def test_ell_operator_matches_jax(tmp_path, etype):
    mesh = (box_tet4 if etype == 341 else box_hex8)(3, 2, 2)
    jm, pm = _models(tmp_path, mesh)
    assert pm.extras[0]                       # the spring block
    jkes = jstatic.compute_element_stiffness(jm)
    want = jell.from_model(jm, jkes)
    got = ell.from_model(pm, static.compute_element_stiffness(pm))
    wb = np.asarray(want.blocks)
    assert got.blocks.shape == wb.shape
    assert np.abs(got.blocks.numpy() - wb).max() <= 1e-12 * np.abs(wb).max()
    assert np.array_equal(got.cols.numpy(), np.asarray(want.cols))
    x = np.random.default_rng(1).standard_normal(pm.n_dof_total)
    for fw, fg in ((want.apply_constrained, got.apply_constrained),
                   (want.block_jacobi(), got.block_jacobi())):
        yw = np.asarray(fw(jnp.asarray(x)))
        yg = fg(torch.as_tensor(x)).numpy()
        assert np.abs(yg - yw).max() <= 1e-12 * np.abs(yw).max()
    dw = np.asarray(want.diag_blocks())
    assert np.abs(got.diag_blocks().numpy() - dw).max() <= \
        1e-12 * np.abs(dw).max()


def test_jax_gpbicg_answer_drifts(tmp_path):
    """Fault 9: on a tet box's ELL system with block-Jacobi, the JAX
    package's GPBiCG reports convergence while its answer's true
    relres is above 1; the port's (and the corrected JAX recurrence's)
    true relres is at the tolerance."""
    jm, pm = _models(tmp_path, box_tet4(4, 3, 3))
    eop = ell.from_model(pm, static.compute_element_stiffness(pm))
    n = pm.n_dof_total
    eye = torch.eye(n, dtype=torch.float64)
    a = torch.stack([eop.apply_constrained(eye[i]) for i in range(n)], 1)
    mj = eop.block_jacobi()
    m = torch.stack([mj(eye[i]) for i in range(n)], 1)
    b = np.random.default_rng(0).standard_normal(n)
    aj, mjj = jnp.asarray(a.numpy()), jnp.asarray(m.numpy())

    def true_relres(x):
        return np.linalg.norm(b - a.numpy() @ np.asarray(x)) / \
            np.linalg.norm(b)

    want = jcg.gpbicg(lambda x: aj @ x, jnp.asarray(b),
                      M=lambda r: mjj @ r, tol=1e-8, maxiter=3000)
    assert float(want.relres) <= 1e-8 and true_relres(want.x) > 1.0
    got = cg.gpbicg(lambda x: a @ x, torch.as_tensor(b), M=lambda r: m @ r,
                    tol=1e-8, maxiter=3000)
    fixed = _zhang_gpbicg()(lambda x: aj @ x, jnp.asarray(b),
                            M=lambda r: mjj @ r, tol=1e-8, maxiter=3000)
    assert got.converged and true_relres(got.x) <= 2e-8
    assert abs(got.iters - int(fixed.iters)) <= 1
    assert true_relres(fixed.x) <= 2e-8


@pytest.mark.parametrize("method", ["GMRESR", "GMRESREN", "BOGUS"])
def test_methods_without_solver_raise(tmp_path, method):
    _, pm = _models(tmp_path, box_tet4(2, 2, 2),
                    CNT.replace("METHOD=BICGSTAB", f"METHOD={method}"))
    with pytest.raises(NotImplementedError, match=method):
        static.check_solver(pm.cfg.solver)
    with pytest.raises(ValueError):
        cg.solve(method, None, torch.zeros(3))
    with pytest.raises(ValueError, match="direct"):
        cg.solve("DIRECT", None, torch.zeros(3))
