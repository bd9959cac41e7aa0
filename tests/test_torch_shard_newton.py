"""The sharded Newton driver (``analysis/nonlinear.py`` with
``parallel/shard.py``) on 2 and 3 ranks on the CPU (gloo) against the
JAX package's single-device run of the same deck, the counterparts of
``tests/test_parallel.py``'s Newton tests and of
``tests/test_spring_mpc.py::test_mpc_nonlinear_and_sharded``: f64
answers within 1e-8, the Newton iterations equal and each solve's CG
count within 2 of the port's single-device run."""

import numpy as np
import pytest

from _torch_decks import MISES_DECK, deck, write_deck
from _torch_shard_tasks import (amg_gap, pools, references, rel, run,
                                whole_arrays)
from frontistr_tpu_torch import ordering
from frontistr_tpu_torch.io.meshio import Equation
from frontistr_tpu_torch.io.neu import write_static_workdir
from frontistr_tpu_torch.meshgen import box_hex8, box_tet4

ENV = {"FRONTISTR_TPU_CACHE_DIR": "0", "FRONTISTR_TPU_PRECISION": "f64",
       "FRONTISTR_TPU_REORDER": "1"}
HYPER = ("!VERSION\n 3\n!SOLUTION, TYPE=STATIC\n!STATIC, TYPE=NLGEOM\n"
         "!BOUNDARY\n X0, 1, 3, 0.0\n!CLOAD\n X1, 3, -2.0\n"
         "!MATERIAL, NAME=M1\n!HYPERELASTIC, TYPE=NEOHOOKE\n 80.0, 0.001\n"
         "!STEP, SUBSTEPS={sub}\n BOUNDARY, 1\n LOAD, 1\n"
         "!SOLVER, METHOD=CG, PRECOND=1, ITERLOG=NO, TIMELOG=NO\n"
         " 10000, 1\n 1.0e-10, 1.0, 0.0\n!END\n")


@pytest.fixture(scope="module")
def ranks():
    with pools(2, 3) as ps:
        yield ps


def _workdir(path, mesh, cnt):
    order = np.random.default_rng(3).permutation(mesh.n_node)
    write_static_workdir(str(path), ordering.permute_mesh(mesh, order), cnt)
    return str(path)


def _check(got, wd, env, key=None):
    """Every rank the same answer, within 1e-8 of the JAX package's; the
    Newton iterations equal and each solve's CG count within 2 of the
    port's single-device run (both run once per ``key``).  Returns the
    single-device run."""
    jo, one = references(key or wd, wd, env)
    want = np.asarray(jo["static"].u).reshape(-1)
    for g in got[1:]:
        np.testing.assert_array_equal(g["u"], got[0]["u"])
    assert np.abs(want).max() > 1e-6
    assert rel(got[0]["u"], want) <= 1e-8
    assert got[0]["iters"] == one["iters"]
    assert len(got[0]["cg"]) == len(one["cg"])
    assert all(abs(a - b) <= 2 for a, b in zip(got[0]["cg"], one["cg"]))
    return one


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_nonlinear_newton_matches(ranks, tmp_path, n):
    """A hyperelastic NLGEOM run over 2 substeps: each rank owns the
    elements of its rows (their gauss states stay there), the nodal and
    element stresses gathered whole."""
    wd = _workdir(tmp_path / "wd", box_tet4(3, 3, 3), HYPER.format(sub=2))
    got = ranks[n].run(run, wd, ENV)
    one = _check(got, wd, ENV, "hyper2")
    for k in ("nodal_stress", "elem_stress", "node_count"):
        assert rel(got[0][k], one[k]) <= 1e-8, k


@pytest.mark.parametrize("n,precond", [(2, "amg"), (3, "amg"),
                                       (3, "jacobi")])
def test_sharded_amg_newton_matches(ranks, tmp_path, n, precond):
    """The AMG V-cycle (level 0 row-sharded, the coarse levels
    replicated, the Galerkin sums all-reduced) and block-Jacobi under
    the sharded Newton solve."""
    env = dict(ENV, FRONTISTR_TPU_PRECOND=precond)
    wd = _workdir(tmp_path / "wd", box_tet4(4, 3, 3), HYPER.format(sub=1))
    got = ranks[n].run(run, wd, env)
    _check(got, wd, env, precond)


def test_mpc_nonlinear_and_sharded(ranks, tmp_path):
    """!EQUATION through the sharded Newton driver (NLGEOM, 2 substeps):
    the elimination on whole vectors around the sharded solve, the
    residual reduced the same way."""
    mesh = box_tet4(3, 3, 3)
    x1 = mesh.node_groups["X1"]
    for a in x1[1:4]:
        mesh.equations.append(Equation(np.asarray([int(a), int(x1[0])]),
                                       np.asarray([1, 1]),
                                       np.asarray([1.0, -1.0]), 0.0))
    cnt = HYPER.format(sub=2).replace(
        "!HYPERELASTIC, TYPE=NEOHOOKE\n 80.0, 0.001\n",
        "!ELASTIC\n 1000.0, 0.3\n").replace("X1, 3, -2.0", "X1, 1, 0.5")
    wd = _workdir(tmp_path / "wd", mesh, cnt)
    got = ranks[2].run(run, wd, ENV)
    _check(got, wd, ENV)


def test_sharded_plastic_yield_counted_once(ranks, tmp_path):
    """A STATIC deck with a Mohr-Coulomb !PLASTIC material (the Newton
    driver at small strain, hex8 IC) in a group of 3: the yielded gauss
    points of the elements two ranks share are counted once."""
    cnt = deck(sol="STATIC", loads="!CLOAD\n X1, 3, -15.0\n",
               plastic="!PLASTIC, YIELD=MOHR-COULOMB\n 60.0, 20.0, 300.0\n",
               write="")
    wd = write_deck(tmp_path / "wd", box_hex8(4, 3, 3), cnt)
    got = ranks[3].run(run, wd, ENV)
    one = _check(got, wd, ENV)
    assert got[0]["yielded"] == one["yielded"]
    assert max(one["yielded"]) > 0


def test_sharded_follower_keeps_whole_model(ranks, tmp_path):
    """A follower pressure (DLOAD under NLGEOM): every rank keeps the
    whole model (``_maybe_engine``'s exclusion), the solve is sharded."""
    cnt = deck(loads="!DLOAD\n TOP, P2, 40.0\n", plastic=MISES_DECK,
               write="").replace("!SOLUTION, TYPE=NLSTATIC\n",
                                 "!SOLUTION, TYPE=NLSTATIC\n"
                                 "!STATIC, TYPE=NLGEOM\n")
    wd = write_deck(tmp_path / "wd", box_hex8(3, 3, 2), cnt)
    got = ranks[2].run(whole_arrays, wd, ENV)
    _check(got, wd, ENV)
    assert max(got[0]["seen"]) == 18


def test_sharded_element_pipeline_engine(ranks, tmp_path):
    """The element pipeline under sharding: no rank's element programs
    (tangent, update, QFORCE, gauss states) hold an element array of the
    whole model, and the answer is the single-device one."""
    mesh = box_tet4(4, 3, 3)
    wd = _workdir(tmp_path / "wd", mesh, HYPER.format(sub=1))
    got = ranks[3].run(whole_arrays, wd, ENV)
    _check(got, wd, ENV)
    E = mesh.blocks[0].conn.shape[0]
    for g in got:
        assert g["seen"] and max(g["seen"]) < E


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_amg_preconditioner_is_one_devices(ranks, n):
    """On nodes padded to 8 ranks (1,000 to 1,008), each rank's AMG
    V-cycle and operator are one device's on its rows to rounding: the
    power iterations start from the unpadded vectors and the padded
    nodes count in no aggregate's centroid."""
    got = ranks[n].run(amg_gap, 9)
    assert all(g["n_pad"] == 1008 for g in got)
    assert max(g["A"] for g in got) <= 1e-14
    assert max(g["M"] for g in got) <= 1e-14
