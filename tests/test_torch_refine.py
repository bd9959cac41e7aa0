"""``!MESH ..., REFINE=n`` of the port (``io/refine.py``) against the JAX
package's ``refine_mesh``: on hex8, tet4, quad4, tri3 and a 741 plate,
with node, element and surface groups, at levels 1 and 2, every output
array identical (coordinates bit-equal, the same node and element
numbering, the same group arrays).  Then a STATIC deck read from ABAQUS
with ``REFINE=1`` through ``run_directory``: the refined mesh equal to
the JAX runner's and the displacements within 1e-8 (of the largest).
"""

import numpy as np
import pytest

from frontistr_tpu.io.refine import refine_mesh as jrefine_mesh
from frontistr_tpu_torch.assembly.loads import FACE_TABLES
from frontistr_tpu_torch.io.refine import refine_mesh
from frontistr_tpu_torch.meshgen import (box_hex8, box_plane, box_tet4,
                                         plate_shell)

from _torch_decks import top_faces
from _torch_vis_decks import CNT, abaqus_workdir, assert_same, run_pair

MESHES = {
    "hex8": lambda: box_hex8(2, 2, 1),
    "tet4": lambda: box_tet4(2, 1, 1),
    "quad4": lambda: box_plane(3, 2, etype=241),
    "tri3": lambda: box_plane(2, 2, etype=231),
    "plate741": lambda: plate_shell(3, 2, etype=741),
}


def _with_groups(mesh):
    """The mesh with an element group (every other element) and, where
    the type has faces, a surface group (the top faces, or face 1 of
    every element)."""
    b = mesh.blocks[0]
    mesh.elem_groups["HALF"] = b.elem_ids[::2].copy()
    if b.etype in (341, 361):
        mesh.surf_groups["STOP"] = top_faces(mesh)
    elif b.etype in FACE_TABLES:
        mesh.surf_groups["F1"] = np.stack(
            [b.elem_ids, np.ones_like(b.elem_ids)], axis=1)
    return mesh


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("kind", list(MESHES))
def test_refine_matches_jax(kind, levels):
    mesh = _with_groups(MESHES[kind]())
    got, want = refine_mesh(mesh, levels), jrefine_mesh(mesh, levels)
    assert got.n_elem == mesh.n_elem * (8 if kind in ("hex8", "tet4")
                                        else 4) ** levels
    assert_same(got, want)


def test_refined_abaqus_static_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("FRONTISTR_TPU_COMPILE_CACHE", "0")
    monkeypatch.setenv("FRONTISTR_TPU_REORDER", "1")
    wd = abaqus_workdir(str(tmp_path / "wd"), box_tet4(3, 2, 2),
                        CNT.format(sol="STATIC", extra=""), refine=1)
    ot, oj, _ = run_pair(wd)
    assert "### mesh refined x1: 175 nodes, 576 elements" in \
        capsys.readouterr().out
    assert_same(ot["mesh"], oj["mesh"])
    assert set(ot["timings"]) >= {"read", "refine", "reorder"}
    u, uj = ot["static"].u, np.asarray(oj["static"].u)
    assert np.abs(u - uj).max() <= 1e-8 * np.abs(uj).max()
