"""The port's tools (``tools/cli.py``, ``tools/rmerge.py``,
``io/vtk.py``, ``io/neu.py``'s reader side) against the JAX package's on
the CPU, on the same input files: every output byte-equal (the npz of
``rconv -t npz`` by its arrays: a zip member carries its write time).

- ``part``: the per-rank HECMW-DIST files of RCB and BLOCK, and the
  ``--check-mesh`` AVS dump.
- ``rmerge`` of the per-rank results of that partition, then ``rconv``
  to binary, back to text, and to npz.
- ``neu2fstr``: the ``.msh`` and ``.cnt`` of the synthetic neutral file
  of ``tests/test_neu.py`` (506 constraints, 507 forces, 601 material).
- ``write_vtk`` and ``write_static_vtk`` on a hex and a tet mesh.
- ``python -m frontistr_tpu_torch.tools.cli rebalance`` reaches the
  rebalance tool (the JAX module's ``__main__`` block precedes
  ``rebalance_main`` and lists no such tool: ROADMAP fault 14).
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest

from frontistr_tpu.io import vtk as jvtk
from frontistr_tpu.io.neu import neu2fstr as jneu2fstr
from frontistr_tpu.tools import cli as jcli
from frontistr_tpu_torch.io import vtk
from frontistr_tpu_torch.io.distio import read_dist
from frontistr_tpu_torch.io.neu import neu2fstr, write_fstr_msh
from frontistr_tpu_torch.io.resfile import read_result, write_result
from frontistr_tpu_torch.meshgen import box_hex8, box_tet4
from frontistr_tpu_torch.tools import cli
from tests.test_neu import _synth_neu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def _partition(tmp_path, method, check):
    msh = str(tmp_path / "cube.msh")
    write_fstr_msh(box_hex8(4, 3, 3), msh)
    bases = []
    for tag, main in (("jax", jcli.part_main), ("torch", cli.part_main)):
        base = str(tmp_path / f"{tag}.dist")
        argv = [msh, "-n", "4", "-o", base, "-m", method]
        assert main(argv + (["--check-mesh"] if check else [])) == 0
        bases.append(base)
    return bases


@pytest.mark.parametrize("method,check", [("RCB", True), ("BLOCK", False)])
def test_part_files_byte_equal(tmp_path, method, check):
    jbase, base = _partition(tmp_path, method, check)
    for r in range(4):
        assert _bytes(f"{base}.{r}") == _bytes(f"{jbase}.{r}"), r
    assert not os.path.exists(f"{base}.4")
    if check:
        assert _bytes(base + ".check.inp") == _bytes(jbase + ".check.inp")


def test_rmerge_rconv_byte_equal(tmp_path):
    """Per-rank results keyed by each rank's global ids (nodal field =
    the node id, elemental = the element id plus a seeded column)."""
    _, base = _partition(tmp_path, "RCB", False)
    rng = np.random.default_rng(6)
    parts = []
    for r in range(4):
        dm = read_dist(f"{base}.{r}")
        gn = dm.global_node_ID[:dm.nn_internal]
        ge = dm.global_elem_ID[:dm.ne_internal]
        p = str(tmp_path / f"res.{r}")
        write_result(p, "*fstrresult", gn, ge,
                     [("GID", gn.astype(float).reshape(-1, 1)),
                      ("V", rng.standard_normal((len(gn), 3)))],
                     [("EID", np.stack([ge.astype(float),
                                        rng.standard_normal(len(ge))], 1))])
        parts.append(p)
    out = {}
    for tag, c in (("jax", jcli), ("torch", cli)):
        merged = str(tmp_path / f"{tag}.merged")
        assert c.rmerge_main(parts + ["-o", merged]) == 0
        for to in ("binary", "text", "npz"):
            conv = str(tmp_path / f"{tag}.{to}")
            assert c.rconv_main([merged, conv, "-t", to]) == 0
        back = str(tmp_path / f"{tag}.back")
        assert c.rconv_main([str(tmp_path / f"{tag}.binary"), back,
                             "-t", "text"]) == 0
        back2 = str(tmp_path / f"{tag}.back2")
        assert c.rconv_main([str(tmp_path / f"{tag}.npz"), back2,
                             "-t", "text"]) == 0
        out[tag] = dict(merged=merged, back=back, back2=back2,
                        binary=str(tmp_path / f"{tag}.binary"),
                        npz=str(tmp_path / f"{tag}.npz"))
    for k in ("merged", "binary", "back", "back2"):
        assert _bytes(out["torch"][k]) == _bytes(out["jax"][k]), k
    with np.load(out["torch"]["npz"]) as a, np.load(out["jax"]["npz"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    m = read_result(out["torch"]["merged"])
    np.testing.assert_array_equal(m["node_comps"][0][1][:, 0],
                                  np.asarray(m["node_ids"], float))


def test_neu2fstr_byte_equal(tmp_path):
    neu = str(tmp_path / "beam.NEU")
    _synth_neu(neu)
    outs = {}
    for tag, fn, main in (("jax", jneu2fstr, jcli.neu2fstr_main),
                          ("torch", neu2fstr, cli.neu2fstr_main)):
        msh, cnt = (str(tmp_path / f"{tag}.{e}") for e in ("msh", "cnt"))
        mesh = fn(neu, msh, cnt_path=cnt)
        msh2 = str(tmp_path / f"{tag}_cli.msh")
        assert main([neu, msh2]) == 0
        outs[tag] = (mesh, msh, cnt, msh2)
    (jm, jmsh, jcnt, jmsh2), (m, msh, cnt, msh2) = outs["jax"], outs["torch"]
    assert _bytes(msh) == _bytes(jmsh)
    assert _bytes(cnt) == _bytes(jcnt)
    assert _bytes(msh2) == _bytes(jmsh2) == _bytes(msh)
    assert m.neu_bc == jm.neu_bc
    np.testing.assert_array_equal(m.coords, jm.coords)
    for b, jb in zip(m.blocks, jm.blocks):
        assert b.etype == jb.etype
        np.testing.assert_array_equal(b.conn, jb.conn)


@pytest.mark.parametrize("box", [box_hex8, box_tet4])
def test_vtk_byte_equal(tmp_path, box):
    mesh = box(3, 2, 2)
    rng = np.random.default_rng(7)
    pd = {"T": rng.standard_normal(mesh.n_node),
          "U": rng.standard_normal((mesh.n_node, 3)),
          "S": rng.standard_normal((mesh.n_node, 6))}
    cd = {"E": rng.standard_normal(mesh.n_elem)}
    res = types.SimpleNamespace(
        u=rng.standard_normal((mesh.n_node, 3)),
        nodal_mises=rng.random(mesh.n_node),
        nodal_stress=rng.standard_normal((mesh.n_node, 6)),
        elem_mises=rng.random(mesh.n_elem))
    for name, w, jw, args in (("f", vtk.write_vtk, jvtk.write_vtk, (pd, cd)),
                              ("s", vtk.write_static_vtk,
                               jvtk.write_static_vtk, (res,))):
        a, b = str(tmp_path / f"{name}.vtk"), str(tmp_path / f"{name}_j.vtk")
        w(a, mesh, *args)
        jw(b, mesh, *args)
        assert _bytes(a) == _bytes(b)


def test_cli_module_runs_rebalance(tmp_path):
    _, base = _partition(tmp_path, "RCB", False)
    jrun = subprocess.run(
        [sys.executable, "-m", "frontistr_tpu.tools.cli", "rebalance", base],
        cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert jrun.returncode == 2 and "usage:" in jrun.stderr   # fault 14
    run = subprocess.run(
        [sys.executable, "-m", "frontistr_tpu_torch.tools.cli", "rebalance",
         base, "-n", "2"], cwd=ROOT, capture_output=True, text=True)
    assert run.returncode == 0, run.stderr
    assert "### DLB: 4 -> 2 ranks" in run.stdout
    assert os.path.exists(f"{base}.1") and not os.path.exists(f"{base}.2")
