"""The port's mesh readers (``io/abaqusio.py``, ``io/nastranio.py``,
``io/geofemio.py``) against the JAX package's, on the JAX tests' own
decks (``tests/test_abaqus.py``, ``test_nastran.py``, ``test_geofem.py``):
the ``Mesh`` field by field (ids, coordinates bit-equal, blocks and both
connectivities, groups, sections, materials, amplitudes), and a STATIC
``run_directory`` of each through ``!MESH, TYPE=`` within 1e-8 of the
JAX runner's displacements (of the largest).  Then the ABAQUS C3D10
reader, which the port repairs (ROADMAP fault 12): the JAX reader raises
IndexError on it; the port's reads it as the native ``.msh`` of the
same mesh does.
"""

import os

import numpy as np
import pytest

from frontistr_tpu.io.abaqusio import read_abaqus as jread_abaqus
from frontistr_tpu.io.geofemio import read_geofem as jread_geofem
from frontistr_tpu.io.nastranio import read_nastran as jread_nastran
from frontistr_tpu_torch.io.abaqusio import read_abaqus
from frontistr_tpu_torch.io.geofemio import read_geofem
from frontistr_tpu_torch.io.meshio import read_mesh
from frontistr_tpu_torch.io.nastranio import read_nastran
from frontistr_tpu_torch.io.neu import write_fstr_msh
from frontistr_tpu_torch.meshgen import box_tet4

import test_abaqus
import test_geofem
import test_nastran
from _torch_decks import tet10_box
from _torch_vis_decks import assert_same, run_pair, write_abaqus, write_ctrl

CPE4 = """*NODE
 1, 0., 0.
 2, 1., 0.
 3, 1., 1.
 4, 0., 1.
*ELEMENT, TYPE=CPE4, ELSET=E1
 1, 1, 2, 3, 4
*SOLID SECTION, ELSET=E1, MATERIAL=M1
 1.0
*MATERIAL, NAME=M1
*ELASTIC
 1000., 0.3
*AMPLITUDE, NAME=RAMP
 0.0, 0.0, 1.0, 1.0
"""


def _geofem(path):
    test_geofem._write_geofem(box_tet4(3, 3, 3), path)


def _text(text):
    def write(path):
        with open(path, "w") as f:
            f.write(text)
    return write


# name: (writer of the mesh file, the JAX reader, the port's, TYPE=,
#        the STATIC deck of the run or None)
DECKS = {
    "abaqus_c3d8": (_text(test_abaqus.INP), jread_abaqus, read_abaqus,
                    "ABAQUS", test_abaqus.CNT),
    "abaqus_cpe4": (_text(CPE4), jread_abaqus, read_abaqus, "ABAQUS", None),
    "nastran": (_text(test_nastran.BULK), jread_nastran, read_nastran,
                "NASTRAN", test_nastran.CNT),
    "geofem": (_geofem, jread_geofem, read_geofem, "GEOFEM",
               "!VERSION\n 3\n!SOLUTION, TYPE=STATIC\n!BOUNDARY\n"
               " X0, 1, 3, 0.0\n!CLOAD\n X1, 3, -1.0\n!SOLVER, METHOD=CG\n"
               " 4000, 1\n 1.0e-10, 1.0, 0.0\n!END\n"),
}


@pytest.mark.parametrize("name", list(DECKS))
def test_reader_matches_jax(tmp_path, name):
    write, jread, read, _, _ = DECKS[name]
    path = str(tmp_path / "mesh.in")
    write(path)
    assert_same(read(path), jread(path))


@pytest.mark.parametrize("name", [k for k, v in DECKS.items() if v[4]])
def test_reader_run_matches_jax(tmp_path, monkeypatch, name):
    """STATIC through ``!MESH, TYPE=``: the port's u within 1e-8 of the
    JAX runner's; both read the same mesh."""
    monkeypatch.setenv("FRONTISTR_TPU_COMPILE_CACHE", "0")
    write, _, _, mtype, cnt = DECKS[name]
    wd = tmp_path / "wd"
    wd.mkdir()
    write(str(wd / "mesh.in"))
    (wd / "case.cnt").write_text(cnt)
    write_ctrl(str(wd), "mesh.in", mtype)
    ot, oj, _ = run_pair(str(wd))
    assert_same(ot["mesh"], oj["mesh"])
    u, uj = ot["static"].u, np.asarray(oj["static"].u)
    assert np.isfinite(u).all() and u.shape == uj.shape
    assert np.abs(u - uj).max() <= 1e-8 * np.abs(uj).max()
    assert "Global Summary" in open(wd / "0.log").read()


def test_abaqus_c3d10_reads_as_native(tmp_path):
    """C3D10 (342): the port's reader applies the HEC-MW -> FSTR table as
    ``meshio`` does (1-based); the JAX reader indexes it 0-based and
    raises IndexError (ROADMAP fault 12)."""
    mesh = tet10_box(2, 2, 1)
    inp, msh = str(tmp_path / "m.inp"), str(tmp_path / "m.msh")
    write_abaqus(inp, mesh, "C3D10")
    write_fstr_msh(mesh, msh)
    got, native = read_abaqus(inp), read_mesh(msh)
    assert got.blocks[0].etype == 342
    np.testing.assert_array_equal(got.blocks[0].conn, native.blocks[0].conn)
    np.testing.assert_array_equal(got.blocks[0].conn, mesh.blocks[0].conn)
    np.testing.assert_array_equal(got.coords, native.coords)
    with pytest.raises(IndexError):
        jread_abaqus(inp)
    assert os.path.exists(inp)
