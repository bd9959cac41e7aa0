"""Linear STATIC by each Krylov method of the deck's menu, held to the
JAX package on the CPU: BiCGSTAB, GMRES and GPBiCG by name and by the
ids 2-4, and FRONTISTR_TPU_PRECOND=cheby, on a shuffled tet4 box (the
scalar block-ELL operator whose blocks K1 sums, block-Jacobi).  Bars: u
within 1e-8 of max|u|, iteration counts within 1; with ``cheby`` within
2 (the degree-8 polynomial of ``solver/cheby.py`` is indefinite below
lmax/30, and on this box a 3e-16 change of its product moves the CG
count from 20 to 22: ROADMAP queue 3).  GPBiCG is held to the JAX
package's recurrence with Zhang's t_{k-1} in the update of u (fault 9).
The structured hex8 and !EQUATION decks: test_torch_krylov_arms.py."""

import inspect

import numpy as np
import jax
import pytest

from frontistr_tpu.solver import cg as jcg
from frontistr_tpu_torch import ordering
from frontistr_tpu_torch.io.neu import write_static_workdir
from frontistr_tpu_torch.meshgen import box_tet4
from frontistr_tpu_torch.run import run_directory

from _torch_decks import run_both

MESH = box_tet4(4, 3, 3)
CNT = ("!VERSION\n 3\n!SOLUTION, TYPE=STATIC\n!BOUNDARY\n X0, 1, 3, 0.0\n"
       "!CLOAD\n {load}\n!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n"
       "!SOLVER, METHOD={method}, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
       " 1.0e-8, 1.0, 0.0\n!END\n")


@pytest.fixture
def env(monkeypatch, request):
    """f64 policy, the RCM reorder; for GPBiCG the JAX package's
    recurrence with Zhang's t_{k-1}, its compiled solves traced afresh
    before and after."""
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", "f64")
    monkeypatch.setenv("FRONTISTR_TPU_REORDER", "1")
    gp = request.node.callspec.params.get("method") in ("GPBICG", "4")
    if gp:
        src = inspect.getsource(jcg.gpbicg)
        ns = {}
        exec(src.replace("M(t0) - M(r)", "M(t) - M(r)"), jcg.__dict__, ns)
        for key in ("GPBICG", "4"):
            monkeypatch.setitem(jcg.SOLVERS, key, ns["gpbicg"])
        jax.clear_caches()
    yield monkeypatch
    if gp:
        jax.clear_caches()


def _check(res, jres, eq=False, slack=1):
    uj = np.asarray(jres.u)
    assert np.isfinite(res.u).all()
    assert np.abs(res.u - uj).max() <= 1e-8 * np.abs(uj).max()
    if eq:
        assert res.iters <= int(jres.iters) + slack
    else:
        assert abs(res.iters - int(jres.iters)) <= slack
    assert res.policy == "f64" and res.iters > 1


TET = ["BICGSTAB", "GMRES", "GPBICG", "2", "3", "4", "cheby"]
IDS = {"2": "BICGSTAB", "3": "GMRES", "4": "GPBICG"}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's result of each named method's deck."""
    return {}


@pytest.mark.parametrize("method", TET)
def test_tet_methods_match_jax(tmp_path, env, jax_runs, method):
    """The shuffled tet4 box through both runners; ``cheby``: CG with
    the Chebyshev preconditioner.  An id's deck is held to the JAX
    package's run of its named method (``SOLVERS`` maps both to one
    function), run once."""
    if method == "cheby":
        env.setenv("FRONTISTR_TPU_PRECOND", "cheby")
    cnt = CNT.format(load="X1, 3, -1.0",
                     method="CG" if method == "cheby" else method)
    name = IDS.get(method, method)
    assert jcg.SOLVERS.get(method) is jcg.SOLVERS.get(name)
    if name in jax_runs:
        wd = tmp_path / "port"
        write_static_workdir(str(wd), ordering.permute_mesh(
            MESH, np.random.default_rng(3).permutation(MESH.n_node)), cnt)
        got = run_directory(str(wd), device="cpu")["static"]
        want = jax_runs[name]
    else:
        ot, oj, _, _ = run_both(tmp_path, MESH, cnt)
        got, want = ot["static"], oj["static"]
        jax_runs[name] = want
    _check(got, want, slack=2 if method == "cheby" else 1)

