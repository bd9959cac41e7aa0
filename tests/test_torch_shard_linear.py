"""Row-sharded linear STATIC (``parallel/shard.py``) on 2 and 3 ranks on
the CPU (gloo) against the JAX package's single-device run of the same
deck, the counterparts of ``tests/test_parallel.py``'s linear tests: f64
answers within 1e-8 of the JAX package's, CG counts within 2 of the
port's single-device run (mixed: 2 + 10 %); 3 ranks pad the node rows
unevenly.  Also the element-sharded step of ``parallel/spmd.py`` and the
profile cache under concurrent ranks."""

import numpy as np
import pytest

from _torch_shard_tasks import (adapted_static, one_run, pools, profiles,
                                references, rel, run, sharded_step)
from frontistr_tpu_torch import ordering
from frontistr_tpu_torch.io.meshio import Equation
from frontistr_tpu_torch.io.neu import write_static_workdir
from frontistr_tpu_torch.meshgen import box_tet4

ENV = {"FRONTISTR_TPU_CACHE_DIR": "0", "FRONTISTR_TPU_PRECISION": "f64"}
CNT = ("!VERSION\n 3\n!SOLUTION, TYPE=STATIC\n!BOUNDARY\n X0, 1, 3, 0.0\n"
       "!CLOAD\n X1, 3, -1.0\n!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n"
       "!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
       " 1.0e-10, 1.0, 0.0\n!END\n")


@pytest.fixture(scope="module")
def ranks():
    with pools(2, 3) as ps:
        yield ps


def _workdir(path, mesh, cnt=CNT):
    order = np.random.default_rng(3).permutation(mesh.n_node)
    write_static_workdir(str(path), ordering.permute_mesh(mesh, order), cnt)
    return str(path)


def _by_id(got, nd=3):
    """The displacement ordered by node id (each run reorders alone)."""
    order = np.argsort(got["node_ids"])
    return got["u"].reshape(-1, nd)[order]


def _check(got, want_u, one, cg_slack):
    """Every rank the same answer, within 1e-8 of ``want_u``, its
    iterations within ``cg_slack`` of the single-device run's."""
    for g in got[1:]:
        np.testing.assert_array_equal(g["u"], got[0]["u"])
    assert rel(got[0]["u"], want_u) <= 1e-8
    assert abs(got[0]["iters"] - one["iters"]) <= cg_slack(one["iters"])
    assert np.abs(want_u).max() > 0


@pytest.mark.parametrize("n", [2, 3])
def test_production_sharded_solve_matches(ranks, tmp_path, n):
    """run_linear_static in a group of n: the row-sharded cluster CG
    equals the JAX package's single-device solve on an unstructured tet
    mesh."""
    wd = _workdir(tmp_path / "wd", box_tet4(5, 4, 4))
    jo, one = references("static", wd, ENV)
    got = ranks[n].run(run, wd, ENV)
    _check(got, np.asarray(jo["static"].u).reshape(-1), one, lambda k: 2)


def test_sharded_mixed_solve_matches(ranks, tmp_path):
    """The mixed policy (float32 cluster CG, float64 row residuals of
    the rank's matrix-free elements) in a group of 3."""
    env = dict(ENV, FRONTISTR_TPU_PRECISION="mixed")
    wd = _workdir(tmp_path / "wd", box_tet4(5, 4, 4))
    want = np.asarray(references("static", wd, ENV)[0]["static"].u)
    want = want.reshape(-1)
    one = one_run(wd, env)
    got = ranks[3].run(run, wd, env)
    assert got[0]["passes"] >= 1
    _check(got, want, one, lambda k: 2 + 0.1 * k)


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_linear_mpc_matches(ranks, tmp_path, n):
    """!EQUATION on the sharded linear arm: the elimination on whole
    vectors around the sharded products equals the JAX package's, and
    the tie holds."""
    mesh = box_tet4(4, 4, 4)
    a, b = (int(v) for v in mesh.node_groups["X1"][:2])
    mesh.equations.append(Equation(np.asarray([a, b]), np.asarray([3, 3]),
                                   np.asarray([1.0, -1.0]), 0.0))
    wd = _workdir(tmp_path / "wd", mesh)
    jo, one = references("mpc", wd, ENV)
    got = ranks[n].run(run, wd, ENV)
    _check(got, np.asarray(jo["static"].u).reshape(-1), one, lambda k: 2)
    u = _by_id(got[0])
    ia, ib = (int(np.searchsorted(np.sort(got[0]["node_ids"]),
                                  mesh.node_ids[i])) for i in (a, b))
    assert abs(u[ia, 2] - u[ib, 2]) <= 1e-12 * np.abs(u).max()


def test_sharded_step_matches_single_device(ranks):
    """``spmd.make_sharded_newton_step`` (element- and row-sharded) on 3
    ranks equals the same step in a group of one."""
    u1 = sharded_step((4, 4, 8), 400, 1e-10)
    got = ranks[3].run(sharded_step, (4, 4, 8), 400, 1e-10)
    for g in got:
        np.testing.assert_array_equal(g, got[0])
    assert np.abs(u1).max() > 0
    assert rel(got[0], u1) <= 1e-8


def test_profile_cache_ranks_load_identical(ranks, tmp_path):
    """Two ranks building the same mesh's profiles: rank 0 builds and
    saves them (a temporary name, then ``os.replace``), the other waits
    and loads them; both hold identical arrays."""
    got = ranks[2].run(profiles, str(tmp_path / "cache"), (4, 3, 3))
    assert [g["found"] for g in got] == [False, True]
    assert set(got[0]["arrays"]) == set(got[1]["arrays"])
    for k, v in got[0]["arrays"].items():
        np.testing.assert_array_equal(v, got[1]["arrays"][k], err_msg=k)
    assert not [p for p in (tmp_path / "cache").iterdir()
                if not p.name.endswith(".npz") or ".tmp" in p.name]


def test_adapt_then_sharded_solve_matches(ranks):
    """The counterpart of ``tests/test_adapt.py``'s: an irregular
    red/green-refined mesh from ``adapt.adapt_by_error`` solves on 3
    ranks to the single-device answer."""
    u1 = adapted_static()
    got = ranks[3].run(adapted_static)
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    assert np.abs(u1).max() > 0
    assert rel(got[0], u1) <= 1e-8
