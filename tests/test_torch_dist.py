"""HECMW-DIST work directories in the port (``io/distio.py``,
``parallel/partition.py``) against the JAX package's: the partitioner's
files (RCB, BLOCK, KMETIS) byte-equal; each package's ``read_dist``
reading the other's files to the same ``DistMesh``; the reassembled
model (``mesh_from_dist_ranks``) equal; a 4-rank STATIC run through
``!MESH, TYPE=HECMW-DIST`` writing the JAX runner's per-rank ``.res``
files (the same ids and components, values within 1e-8 of each
component's largest over the ranks; byte-equal when the port's writer
is given the JAX run's result), its displacements within 1e-8 (of the
largest) of the same mesh read whole.
"""

import os

import numpy as np
import pytest

from frontistr_tpu.io import distio as jdistio
from frontistr_tpu.parallel import partition as jpartition
from frontistr_tpu_torch import run as run_mod
from frontistr_tpu_torch.io import distio
from frontistr_tpu_torch.io.hecmw_ctrl import read_hecmw_ctrl
from frontistr_tpu_torch.io.neu import write_static_workdir
from frontistr_tpu_torch.io.resfile import read_result_any
from frontistr_tpu_torch.meshgen import box_hex8, box_tet4
from frontistr_tpu_torch.parallel import partition
from frontistr_tpu_torch.run import run_directory

from _torch_vis_decks import CNT, assert_same, run_pair, u_by_id, write_ctrl


def _mesh():
    m = box_tet4(4, 3, 2)
    m.elem_groups["HALF"] = m.blocks[0].elem_ids[::2].copy()
    return m


@pytest.mark.parametrize("method", ["RCB", "BLOCK", "KMETIS"])
def test_partition_files_match_jax(tmp_path, method):
    mesh = _mesh()
    got = partition.partition_to_files(mesh, 4, str(tmp_path / "t"), method)
    want = jpartition.partition_to_files(mesh, 4, str(tmp_path / "j"),
                                         method)
    assert len(got) == len(want) == 4
    for p, q in zip(got, want):
        assert open(p, "rb").read() == open(q, "rb").read()
    # each package reads the other's files
    for p, q in zip(got, want):
        assert_same(distio.read_dist(q), jdistio.read_dist(p), "dist")
    mt, pt = distio.mesh_from_dist_ranks([distio.read_dist(p) for p in got])
    mj, pj = jdistio.mesh_from_dist_ranks([jdistio.read_dist(q)
                                           for q in want])
    assert_same(mt, mj)
    assert_same(pt, pj, "partinfo")
    assert pt["n_ranks"] == 4


def test_partition_host_parts_match_jax():
    mesh = box_hex8(4, 3, 3)
    part, subs = partition.partition_mesh(mesh, 3)
    jpart, jsubs = jpartition.partition_mesh(mesh, 3)
    np.testing.assert_array_equal(part, jpart)
    assert_same(subs, jsubs, "subdomains")
    assert partition.edge_cut(mesh, part) == jpartition.edge_cut(mesh, jpart)
    rng = np.random.default_rng(0)
    vecs = [rng.standard_normal(len(s.nodes)) for s in subs]
    for a, b in zip(partition.halo_exchange_reference(subs, vecs),
                    jpartition.halo_exchange_reference(jsubs, vecs)):
        np.testing.assert_array_equal(a, b)


def test_dist_static_run_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("FRONTISTR_TPU_COMPILE_CACHE", "0")
    mesh = box_tet4(4, 3, 2)
    wd = tmp_path / "wd"
    wd.mkdir()
    partition.partition_to_files(mesh, 4, str(wd / "mesh.dist"), "RCB")
    (wd / "case.cnt").write_text(CNT.format(sol="STATIC",
                                            extra="!WRITE, RESULT\n"))
    write_ctrl(str(wd), "mesh.dist", "HECMW-DIST", result=True)
    ot, oj, wj = run_pair(str(wd))
    assert f"### HECMW-DIST: reassembled 4 ranks -> {mesh.n_node} nodes, " \
        f"{mesh.n_elem} elements" in capsys.readouterr().out
    assert ot["partition"]["n_ranks"] == 4
    assert_same(ot["mesh"], oj["mesh"])
    got = [read_result_any(str(wd / f"result.{r}.1")) for r in range(4)]
    want = [read_result_any(os.path.join(wj, f"result.{r}.1"))
            for r in range(4)]
    for g, w in zip(got, want):
        for k in ("node_ids", "elem_ids"):
            np.testing.assert_array_equal(g[k], w[k])
        for k in ("node_comps", "elem_comps"):
            assert [n for n, _ in g[k]] == [n for n, _ in w[k]]
    for k in ("node_comps", "elem_comps"):
        for c in range(len(want[0][k])):
            # each component against its largest over every rank
            big = max(np.abs(w[k][c][1]).max() for w in want)
            for g, w in zip(got, want):
                assert np.abs(g[k][c][1] - w[k][c][1]).max() <= 1e-8 * big
    # the rank files of the JAX run's own result, byte-equal
    again = tmp_path / "again"
    again.mkdir()
    ctrl = read_hecmw_ctrl(str(wd / "hecmw_ctrl.dat"))
    ctrl.result().path = str(again / "result")
    run_mod._write_static_results(ctrl, ot["mesh"], ot["model"],
                                  oj["static"], ot["partition"])
    for r in range(4):
        assert open(again / f"result.{r}.1", "rb").read() == \
            open(os.path.join(wj, f"result.{r}.1"), "rb").read()
    # the same mesh read whole
    whole = tmp_path / "whole"
    write_static_workdir(str(whole), mesh, CNT.format(sol="STATIC",
                                                      extra=""))
    ow = run_directory(str(whole), device="cpu")
    u, uw = u_by_id(ot), u_by_id(ow)
    assert np.abs(u - uw).max() <= 1e-8 * np.abs(uw).max()
