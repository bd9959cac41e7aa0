"""The sharded solves of transient HEAT, implicit DYNAMIC and EIGEN
(``parallel/shard.row_pcg`` in ``analysis/heat.py``, ``dynamic.py`` and
``eigen.py``) on 2 and 3 ranks on the CPU (gloo) against the JAX
package's single-device run, the counterparts of ``tests/
test_parallel.py``'s ``test_sharded_heat_transient_matches``,
``test_sharded_implicit_dynamics_matches`` and
``test_sharded_eigen_matches``: fields within 1e-8, CG counts within 2
of the port's single-device run."""

import numpy as np
import pytest

from _torch_decks import heat_deck, heat_mesh, write_heat_deck
from _torch_shard_tasks import pools, references, rel, run
from frontistr_tpu_torch import ordering
from frontistr_tpu_torch.io.neu import write_static_workdir
from frontistr_tpu_torch.meshgen import box_tet4

ENV = {"FRONTISTR_TPU_CACHE_DIR": "0", "FRONTISTR_TPU_PRECISION": "f64",
       "FRONTISTR_TPU_REORDER": "1"}
DYN = ("!VERSION\n 3\n!SOLUTION, TYPE=DYNAMIC\n!DYNAMIC\n 1, 1\n"
       " 0.0, 0.03, 3, 0.01\n 0.5, 0.25\n 1, 1, 0.5, {ray_k}\n 10\n"
       "!BOUNDARY, GRPID=1\n X0, 1, 3, 0.0\n!CLOAD, GRPID=1\n X1, 3, -1.5\n"
       "!STEP, SUBSTEPS=1, CONVERG=1.0e-8\n BOUNDARY, 1\n LOAD, 1\n"
       "!MATERIAL, NAME=M1\n!ELASTIC\n 500.0, 0.3\n!DENSITY\n 2.0\n"
       "!SOLVER,METHOD=CG,PRECOND=1,ITERLOG=NO,TIMELOG=NO\n 10000, 1\n"
       " 1.0e-12, 1.0, 0.0\n!END\n")
EIG = ("!VERSION\n 3\n!SOLUTION, TYPE=EIGEN\n!EIGEN\n 4, 1.0e-10, 60\n"
       "!BOUNDARY\n X0, 1, 3, 0.0\n!MATERIAL, NAME=M1\n!ELASTIC\n"
       " 1000.0, 0.3\n!DENSITY\n 1.0\n"
       "!SOLVER,METHOD=CG,ITERLOG=NO,TIMELOG=NO\n 10000, 1\n"
       " 1.0e-10, 1.0, 0.0\n!END\n")


@pytest.fixture(scope="module")
def ranks():
    with pools(2, 3) as ps:
        yield ps


def _workdir(path, mesh, cnt):
    order = np.random.default_rng(3).permutation(mesh.n_node)
    write_static_workdir(str(path), ordering.permute_mesh(mesh, order), cnt)
    return str(path)


def _same_ranks(got, key):
    for g in got[1:]:
        np.testing.assert_array_equal(g[key], got[0][key])


def _cg_close(got, one):
    flat = [np.ravel(v) for v in (got, one)]
    assert flat[0].shape == flat[1].shape
    assert np.abs(flat[0] - flat[1]).max() <= 2


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_heat_transient_matches(ranks, tmp_path, n):
    """Transient heat with a film, radiation and fluxes (the fixed point
    over the conductances): each solve row-sharded."""
    mesh = heat_mesh("hex8")
    wd = write_heat_deck(tmp_path / "wd", mesh, heat_deck(mesh))
    jo, one = references("heat", wd, ENV)
    want = np.asarray(jo["heat"].T).reshape(-1)
    got = ranks[n].run(run, wd, ENV)
    _same_ranks(got, "T")
    assert np.abs(want).max() > 1.0
    assert rel(got[0]["T"], want) <= 1e-8
    _cg_close(sum(got[0]["cg"], []), sum(one["cg"], []))


@pytest.mark.parametrize("n,ray_k", [(2, "0.0"), (3, "0.0"),
                                     (3, "1.0e-3")])
def test_sharded_implicit_dynamics_matches(ranks, tmp_path, n, ray_k):
    """Newmark implicit dynamics: the effective solve c1 K + c2 M on the
    ranks' rows assembled by K1, block-Jacobi, the dots all-reduced;
    with Rayleigh's K term (the whole operator's product) too."""
    wd = _workdir(tmp_path / "wd", box_tet4(3, 3, 3),
                  DYN.format(ray_k=ray_k))
    jo, one = references(f"dynamic{ray_k}", wd, ENV)
    jo = jo["dynamic"]
    got = ranks[n].run(run, wd, ENV)
    _same_ranks(got, "u")
    assert np.abs(np.asarray(jo.u)).max() > 1e-8
    assert rel(got[0]["u"], np.asarray(jo.u).reshape(-1)) <= 1e-8
    assert rel(got[0]["vel"], np.asarray(jo.vel).reshape(-1)) <= 1e-8
    assert got[0]["newton"] == one["newton"]
    _cg_close(sum(got[0]["cg"], []), sum(one["cg"], []))


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_eigen_matches(ranks, tmp_path, n):
    """Lanczos: every shift-invert apply K^-1 (M q) row-sharded, full
    float64; the eigenvalues and the modes as the JAX package's."""
    wd = _workdir(tmp_path / "wd", box_tet4(3, 3, 3), EIG)
    jo, one = references("eigen", wd, ENV)
    jo = jo["eigen"]
    got = ranks[n].run(run, wd, ENV)
    _same_ranks(got, "eigenvalues")
    assert rel(got[0]["eigenvalues"], np.asarray(jo.eigenvalues)) <= 1e-8
    # the modes up to their sign
    v, w = got[0]["vectors"], np.asarray(jo.eigenvectors)
    sign = np.sign(np.sum(v * w, axis=0))
    assert rel(v * sign, w) <= 1e-6
    _cg_close(got[0]["cg"], one["cg"])
