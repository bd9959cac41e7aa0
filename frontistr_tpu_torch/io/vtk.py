"""Legacy-VTK output (host code copied from ``frontistr_tpu/io/vtk.py``;
the files are byte-equal to the JAX package's).

The reference's in-situ software renderer (hecmw1/src/visualizer, 26k LoC of
PSF/PVR ray-casting) is a pre-GPU-era artifact; the modern equivalent —
which the reference itself also offers (hecmw_fstr_output_vtk.c) — is VTK
output consumed by ParaView.  This writer emits ASCII legacy .vtk
unstructured grids with nodal/elemental fields.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# etype -> (vtk cell type, node order permutation from FSTR ordering)
_VTK_CELL = {
    111: (3, None), 112: (21, None),
    231: (5, None), 232: (22, None), 241: (9, None), 242: (23, None),
    341: (10, None), 342: (24, [0, 1, 2, 3, 4, 5, 6, 7, 8, 9]),
    351: (13, None), 352: (26, None),
    361: (12, None), 362: (25, None),
}


def write_vtk(path: str, mesh, point_data: Optional[Dict[str, np.ndarray]]
              = None, cell_data: Optional[Dict[str, np.ndarray]] = None,
              title: str = "frontistr_tpu result"):
    """point_data arrays: (n_node,) or (n_node, k); cell_data concatenated
    over blocks in block order."""
    n_node = mesh.n_node
    blocks = [b for b in mesh.blocks if b.etype in _VTK_CELL]
    n_cell = sum(len(b.elem_ids) for b in blocks)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write(title + "\n")
        f.write("ASCII\nDATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {n_node} double\n")
        for p in mesh.coords:
            x = list(p) + [0.0] * (3 - len(p))
            f.write(f"{x[0]:.10g} {x[1]:.10g} {x[2]:.10g}\n")
        total = sum((b.conn.shape[1] + 1) * len(b.elem_ids) for b in blocks)
        f.write(f"CELLS {n_cell} {total}\n")
        for b in blocks:
            _, perm = _VTK_CELL[b.etype]
            conn = b.conn if perm is None else b.conn[:, perm]
            for row in conn:
                f.write(str(len(row)) + " " +
                        " ".join(str(int(v)) for v in row) + "\n")
        f.write(f"CELL_TYPES {n_cell}\n")
        for b in blocks:
            ct = _VTK_CELL[b.etype][0]
            f.write((f"{ct}\n") * len(b.elem_ids))
        if point_data:
            f.write(f"POINT_DATA {n_node}\n")
            _write_fields(f, point_data)
        if cell_data:
            f.write(f"CELL_DATA {n_cell}\n")
            _write_fields(f, cell_data)


def _write_fields(f, fields: Dict[str, np.ndarray]):
    for name, arr in fields.items():
        arr = np.asarray(arr)
        if arr.ndim == 1:
            f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
            for v in arr:
                f.write(f"{v:.10g}\n")
        elif arr.shape[1] == 3:
            f.write(f"VECTORS {name} double\n")
            for row in arr:
                f.write(f"{row[0]:.10g} {row[1]:.10g} {row[2]:.10g}\n")
        else:
            f.write(f"SCALARS {name} double {arr.shape[1]}\n"
                    "LOOKUP_TABLE default\n")
            for row in arr:
                f.write(" ".join(f"{v:.10g}" for v in row) + "\n")


def write_static_vtk(path: str, mesh, res):
    """Convenience: displacement/stress/mises fields from a StaticResult."""
    u = np.asarray(res.u)
    if u.shape[1] == 2:
        u = np.hstack([u, np.zeros((len(u), 1))])
    pd = {"DISPLACEMENT": u, "NodalMISES": res.nodal_mises,
          "NodalSTRESS": res.nodal_stress}
    cd = {"ElementalMISES": res.elem_mises}
    write_vtk(path, mesh, pd, cd)
