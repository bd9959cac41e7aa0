"""Load balancing of a HECMW-DIST work directory in the port
(``parallel/rebalance.py``) against the JAX package on the CPU: the same
partitioned work directory rebalanced by each package (with the corner
refinement of ``tests/test_rebalance.py``, and to another rank count)
gives byte-equal rank files and equal stats; the rebalanced work
directory through the port's ``run_directory`` gives the answer of the
adapted model run as one rank within 1e-8 of max|u|."""

import os
import shutil

import numpy as np
import pytest

from frontistr_tpu.parallel import partition as jpartition
from frontistr_tpu.parallel import rebalance as jrebalance
from frontistr_tpu_torch import adapt
from frontistr_tpu_torch.io.distio import mesh_from_dist_ranks, read_dist
from frontistr_tpu_torch.meshgen import box_tet4
from frontistr_tpu_torch.parallel import rebalance
from frontistr_tpu_torch.parallel.partition import partition_to_files
from frontistr_tpu_torch.run import run_directory

CNT = """!VERSION
 3
!SOLUTION, TYPE=STATIC
!BOUNDARY
 X0, 1, 3, 0.0
!CLOAD
 X1, 3, -1.0
!MATERIAL, NAME=M1
!ELASTIC
 1000.0, 0.3
!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO
 5000, 1
 1.0e-10, 1.0, 0.0
!END
"""
CTRL = ("!MESH, NAME=fstrMSH, TYPE=HECMW-DIST\n box.dist\n"
        "!CONTROL, NAME=fstrCNT\n box.cnt\n"
        "!RESULT, NAME=fstrRES, IO=OUT\n box.res\n")


def _corner_marks(mesh, frac=1.0 / 3.0):
    lim = mesh.coords.max(axis=0) * frac
    b = mesh.blocks[0]
    hit = (mesh.coords[b.conn].mean(axis=1) < lim).all(axis=1)
    return [int(e) for e in b.elem_ids[hit]]


def _workdir(path, mesh, n_parts, partition=partition_to_files):
    path.mkdir()
    partition(mesh, n_parts, str(path / "box.dist"))
    (path / "box.cnt").write_text(CNT)
    (path / "hecmw_ctrl.dat").write_text(CTRL)
    return str(path / "box.dist")


def _ranks(base):
    return [open(p, "rb").read() for p in rebalance.workdir_ranks(base)]


@pytest.mark.parametrize("n_parts,marks", [(None, "corner"), (2, None)])
def test_rebalance_matches_jax(tmp_path, n_parts, marks):
    mesh = box_tet4(6, 6, 6)
    marked = _corner_marks(mesh) if marks else None
    base = _workdir(tmp_path / "torch", mesh, 4)
    jbase = _workdir(tmp_path / "jax", mesh, 4,
                     jpartition.partition_to_files)
    assert _ranks(base) == _ranks(jbase)
    stats = rebalance.rebalance_workdir(base, n_parts=n_parts,
                                        marked_eids=marked)
    jstats = jrebalance.rebalance_workdir(jbase, n_parts=n_parts,
                                          marked_eids=marked)
    assert stats == jstats
    assert _ranks(base) == _ranks(jbase)
    assert stats["n_ranks"] == (n_parts or 4)
    assert not os.path.exists(f"{base}.{stats['n_ranks']}")
    assert sum(stats["after"]) == stats["n_elem_after"]
    assert rebalance.imbalance(np.asarray(stats["after"])) <= 1.35
    if marks:
        assert stats["n_elem_after"] > stats["n_elem_before"]
        ref = adapt.adapt_mesh(mesh, marked)
        got, _ = mesh_from_dist_ranks(
            [read_dist(p) for p in rebalance.workdir_ranks(base)])
        assert (got.n_node, got.n_elem) == (ref.n_node, ref.n_elem)


def test_rebalanced_workdir_matches_whole_model(tmp_path):
    mesh = box_tet4(6, 6, 6)
    marked = _corner_marks(mesh)[:8]
    base = _workdir(tmp_path / "four", mesh, 4)
    rebalance.rebalance_workdir(base, marked_eids=marked)
    out4 = run_directory(str(tmp_path / "four"), device="cpu")
    assert out4["partition"]["n_ranks"] == 4
    one = tmp_path / "one"
    _workdir(one, adapt.adapt_mesh(mesh, marked), 1)
    shutil.move(str(one / "box.dist.0"), str(one / "box.dist"))
    out1 = run_directory(str(one), device="cpu")
    u4 = np.asarray(out4["static"].u).reshape(-1, 3)
    u1 = np.asarray(out1["static"].u).reshape(-1, 3)
    order = {int(g): i for i, g in enumerate(out1["mesh"].node_ids)}
    perm = np.asarray([order[int(g)] for g in out4["mesh"].node_ids])
    assert np.abs(u4 - u1[perm]).max() <= 1e-8 * np.abs(u1).max()
