"""AVS UCD (.inp) writer — hecmw_ucd_print.c re-created.

The reference emits AVS UCD files in two flavors: the multi-step header
(HECMW_ucd_print) and the legacy one-line header
(HECMW_ucd_legacy_print); the visualizer's AVS output modes
(hecmw_vis_surface_main.c output_type=COMPLETE_AVS etc.) and the
partitioner's check-mesh dumps both go through this format.  Node and
element ids are 1-based LOCAL indices, coordinates print as %.7E, and
connectivity is permuted from the HECMW order into the UCD cell order
via the inverse of hecmw_ucd_print.c's conv_index_ucd2hec tables
(second-order cells degrade to their first-order UCD label using the
corner subset, exactly like the reference).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

# FSTR/HECMW etype -> (ucd label, hec-index per ucd position)
# from conv_index_ucd2hec_* (hecmw_ucd_print.c:16-83), -1 slots dropped
_UCD = {
    111: ("line", [0, 1]), 112: ("line", [0, 2]),
    611: ("line", [0, 1]), 641: ("line", [0, 1]),
    231: ("tri", [0, 1, 2]), 232: ("tri", [0, 1, 2]),
    731: ("tri", [0, 1, 2]), 732: ("tri", [0, 1, 2]),
    741: ("quad", [0, 1, 2, 3]), 742: ("quad", [0, 1, 2, 3]),
    241: ("quad", [0, 1, 2, 3]), 242: ("quad", [0, 1, 2, 3]),
    761: ("prism", [3, 4, 5, 0, 1, 2]),
    781: ("hex", [4, 5, 6, 7, 0, 1, 2, 3]),
    341: ("tet", [0, 3, 2, 1]), 342: ("tet", [0, 3, 2, 1]),
    3414: ("tet", [0, 3, 2, 1]),
    351: ("prism", [3, 4, 5, 0, 1, 2]),
    352: ("prism", [3, 4, 5, 0, 1, 2]),
    361: ("hex", [4, 5, 6, 7, 0, 1, 2, 3]),
    362: ("hex", [4, 5, 6, 7, 0, 1, 2, 3]),
}


def write_ucd(mesh, path: str,
              node_data: Optional[Sequence[Tuple[str, np.ndarray]]] = None,
              elem_data: Optional[Sequence[Tuple[str, np.ndarray]]] = None,
              legacy: bool = False) -> str:
    """Write mesh (+ optional results) as an AVS UCD .inp file.

    node_data / elem_data: [(label, (n, dof) or (n,) array), ...] —
    the hecmwST_result_data component lists.  legacy=True writes the
    one-line old-UCD header (HECMW_ucd_legacy_print)."""
    node_data = [(lb, np.atleast_2d(np.asarray(v, float).T).T
                  if np.asarray(v).ndim == 1 else np.asarray(v, float))
                 for lb, v in (node_data or [])]
    elem_data = [(lb, np.atleast_2d(np.asarray(v, float).T).T
                  if np.asarray(v).ndim == 1 else np.asarray(v, float))
                 for lb, v in (elem_data or [])]
    nn_item = sum(v.shape[1] for _, v in node_data)
    ne_item = sum(v.shape[1] for _, v in elem_data)
    n_node = mesh.n_node
    n_elem = sum(len(b.elem_ids) for b in mesh.blocks)
    with open(path, "w") as f:
        if legacy:
            f.write(f"{n_node} {n_elem} {nn_item} {ne_item} 0\n")
        else:
            f.write("# File Format : multi-step UCD data for "
                    "unstructured mesh\n")
            f.write("# created by frontistr_tpu (hecmw_ucd_print "
                    "equivalent)\n")
            f.write("1\ndata\nstep1\n")
            f.write(f"{n_node} {n_elem}\n")
        for i in range(n_node):
            x, y, z = (list(mesh.coords[i][:3]) + [0.0, 0.0, 0.0])[:3]
            f.write(f"{i + 1} {x:.7E} {y:.7E} {z:.7E}\n")
        ei = 0
        for b in mesh.blocks:
            lab_perm = _UCD.get(b.etype)
            conn = b.conn_hecmw if getattr(b, "conn_hecmw", None) \
                is not None else b.conn
            if lab_perm is None:            # unknown: raw point list
                lab, perm = "pt", [0]
            else:
                lab, perm = lab_perm
            for e in range(conn.shape[0]):
                ei += 1
                nodes = " ".join(str(int(conn[e, j]) + 1) for j in perm)
                f.write(f"{ei} 0 {lab} {nodes}\n")
        for items, count, n_rows in ((node_data, nn_item, n_node),
                                     (elem_data, ne_item, n_elem)):
            if not items:
                continue
            f.write(str(len(items)) + "".join(
                f" {v.shape[1]}" for _, v in items) + "\n")
            for lb, _ in items:
                f.write(f"{lb}, unit_unknown\n")
            allv = np.concatenate([v for _, v in items], axis=1)
            for i in range(n_rows):
                f.write(f"{i + 1}" + "".join(
                    f" {allv[i, j]:.7E}" for j in range(count)) + "\n")
    return path


def static_result_ucd(mesh, result, path: str, legacy: bool = False):
    """UCD dump of a StaticResult — the visualizer's COMPLETE_AVS /
    COMPLETE_REORDER_AVS output modes (hecmw_vis_surface_main.c)."""
    u = np.asarray(result.u)
    if u.ndim == 1:
        u = u.reshape(mesh.n_node, -1)
    nd: List[Tuple[str, np.ndarray]] = [("DISPLACEMENT", u[:, :3])]
    if getattr(result, "nodal_stress", None) is not None:
        nd.append(("STRESS", np.asarray(result.nodal_stress)))
    if getattr(result, "nodal_mises", None) is not None:
        nd.append(("MISES", np.asarray(result.nodal_mises)))
    return write_ucd(mesh, path, node_data=nd, legacy=legacy)
