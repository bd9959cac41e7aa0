"""FEMAP neutral (.NEU) reader, neu2fstr conversion and the HECMW-ENTIRE
``.msh`` writer (host code copied from ``frontistr_tpu/io/neu.py``; the
writer also writes the initial conditions and !ZERO), and
``write_static_workdir``, which writes a runnable work directory for a
generated mesh and a deck.

The reader is a rebuild of fistr1/tools/neu2fstr (neu2fstr.cpp + NFD/ +
converter/conv_neu2hec.cpp): it parses the '-1 / <blockID> / records /
-1' neutral structure, decodes Block 403 (nodes) and Block 404
(elements), maps FEMAP topologies to HECMW element types with the
converter's connectivity permutation table (conv_neu2hec.cpp:296-330),
and reads materials (601), properties (402), constraints (506) and
loads (507).  Unknown blocks are skipped.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from frontistr_tpu_torch.elements.tables import HECMW2FSTR_ORDER
from frontistr_tpu_torch.io.meshio import (Mesh, ElemBlock, Section,
                                           MaterialDef, Equation)

# topology id -> (con_table row, nn); enum order per CNFDB_404.h:27-43:
# Line2,Line3,Tri3,Tri6,Quad4,Quad8,Tetra4,Wedge6,Brick8,Point,
# Tetra10,Wedge15,Brick20
_TOPO = {0: (0, 2), 1: (1, 3), 2: (2, 3), 3: (3, 6), 4: (4, 4),
         5: (5, 8), 6: (6, 4), 7: (8, 6), 8: (10, 8),
         10: (7, 10), 11: (9, 15), 12: (11, 20)}
# con_table (conv_neu2hec.cpp:296-330)
_CON = [
    [0, 1], [0, 1, 2],
    [0, 1, 2], [0, 1, 2, 5, 6, 4],
    [0, 1, 2, 3], [0, 1, 2, 3, 4, 5, 6, 7],
    [0, 1, 2, 4], [0, 1, 2, 4, 9, 10, 8, 12, 13, 14],
    [0, 1, 2, 4, 5, 6],
    [0, 1, 2, 4, 5, 6, 9, 10, 8, 17, 18, 16, 12, 13, 14],
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 16, 17, 18, 19, 12, 13, 14,
     15],
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 16, 17, 18, 19, 12, 13, 14,
     15],
]
# base etype per topology for 3D solids; line/tri/quad resolve via the
# element property type (conv_neu2hec.cpp line/tri/quad_elem_type):
# PLATE(17,18) -> shells, PLANESTRAIN(19,20) -> 2D solids,
# ROD/LINK vs BEAM for lines
_ETYPE3D = {6: 341, 7: 351, 8: 361, 10: 342, 11: 352, 12: 362}
_PLATE = {17, 18}
_PSTRAIN = {19, 20}
_BEAMP = {2, 5, 8, 37}       # BAR/BEAM/CURVEBEAM/BEAM2


def _elem_type(topo: int, ptype: int) -> int:
    if topo in _ETYPE3D:
        return _ETYPE3D[topo]
    if topo in (0, 1):                     # Line2/Line3
        first = topo == 0
        if ptype in _BEAMP:
            return 611 if first else 612
        return 111 if first else 112
    if topo in (2, 3):                     # Tri3/Tri6
        first = topo == 2
        if ptype in _PLATE:
            return 731 if first else 732
        return 231 if first else 232
    if topo in (4, 5):                     # Quad4/Quad8
        first = topo == 4
        if ptype in _PLATE:
            return 741 if first else 742
        return 241 if first else 242
    raise ValueError(f"unsupported FEMAP topology {topo}")


def _fields(line: str) -> List[str]:
    return [t for t in line.strip().rstrip(",").split(",") if t != ""]


def read_neu(path: str) -> Mesh:
    lines = open(path, "r", errors="replace").read().splitlines()
    i = 0
    n = len(lines)
    node_ids: List[int] = []
    coords: List[tuple] = []
    elems: List[tuple] = []     # (eid, etype, conn_hecmw(global), propID)
    props: Dict[int, int] = {}       # propID -> matID (Block 402)
    mats: Dict[int, list] = {}       # matID -> mval[200] (Block 601)
    bc506: Dict[int, set] = {}       # nodeID -> fixed dofs (Block 506)
    eqs: List[tuple] = []            # (nodeID, dof, coeff) rows
    disp507: Dict[tuple, float] = {}  # (nodeID, dof) -> prescribed value
    cloads: List[tuple] = []         # (nodeID, dof, value)
    grav = None                      # (gx, gy, gz) when grav_on
    version = 8.2

    def block_lines(start):
        """Lines of one block (start = first content line); returns
        (content, next_index_after_terminator)."""
        j = start
        out = []
        while j < n and lines[j].strip() != "-1":
            out.append(lines[j])
            j += 1
        return out, j + 1

    while i < n:
        if lines[i].strip() != "-1":
            i += 1
            continue
        if i + 1 >= n:
            break
        bid = lines[i + 1].strip()
        content, i = block_lines(i + 2)
        if bid == "100" and len(content) >= 2:
            try:
                version = float(_fields(content[1])[0])
            except (ValueError, IndexError):
                pass
        elif bid == "403":
            for ln in content:
                f = _fields(ln)
                if len(f) < 14:
                    continue
                node_ids.append(int(float(f[0])))
                coords.append((float(f[11]), float(f[12]),
                               float(f[13])))
        elif bid == "404":
            k = 0
            while k < len(content):
                f = _fields(content[k])
                if len(f) < 5:
                    k += 1
                    continue
                eid = int(float(f[0]))
                topo = int(float(f[4]))
                # records 2-3: 20 node slots over two lines
                nodes = []
                for r in (1, 2):
                    nodes += [int(float(v))
                              for v in _fields(content[k + r])]
                # records 4-7: orient/offset1/offset2/release (+lists)
                k += 7
                # FEMAP >= 5.x appends extra per-element lines for some
                # topologies (MultiList etc.) — not supported here
                if topo not in _TOPO:
                    continue
                con_row, nn = _TOPO[topo]
                conn = [nodes[_CON[con_row][j]] for j in range(nn)]
                elems.append((eid, _elem_type(topo, int(float(f[3]))),
                              conn, int(float(f[2]))))
        elif bid == "402" and content:
            # property: ID, color, matID, type, ... (CNFDB_402.cpp)
            f = _fields(content[0])
            if len(f) >= 3:
                props[int(float(f[0]))] = int(float(f[2]))
        elif bid == "601" and len(content) >= 29:
            # material: header, title, Bcount+bval, Icount+ival(3 lines),
            # Mcount + mval 200 over 20 lines (CNFDB_601.cpp); E=mval[0],
            # nu=mval[6], alpha=mval[36], rho=mval[49] (CNFDB_601.h)
            f = _fields(content[0])
            mid = int(float(f[0]))
            mval: List[float] = []
            k = 9
            while k < len(content) and len(mval) < 200:
                try:
                    mval += [float(v) for v in _fields(content[k])]
                except ValueError:
                    break
                k += 1
            if len(mval) >= 50:
                mats[mid] = mval
        elif bid == "506" and len(content) >= 3:
            # constraints (CNFDB_506.cpp): setID, title, then four
            # const-item lists (nodes/points/curves/surfaces: ID, color,
            # layer, DOF[6], ex_geom; terminated by ID=-1), then the
            # equation list + num_co + (nodeID, dof, coeff) rows
            k = 2

            def const_items(k):
                out = []
                while k < len(content):
                    f = _fields(content[k])
                    k += 1
                    if not f or int(float(f[0])) == -1:
                        break
                    if len(f) >= 9:
                        out.append((int(float(f[0])),
                                    [int(float(v)) for v in f[3:9]]))
                return out, k
            for which in range(4):
                items, k = const_items(k)
                if which == 0:          # nodes (curves/surfaces: no
                    for nid2, dofs6 in items:   # geometry to expand)
                        s = bc506.setdefault(nid2, set())
                        s.update(d + 1 for d in range(6) if dofs6[d])
            eq_n = 0
            while k < len(content):     # equation headers
                f = _fields(content[k])
                k += 1
                if not f or int(float(f[0])) == -1:
                    break
                eq_n += 1
            k += eq_n                   # num_co records (one int each)
            for _ in range(eq_n):       # (nodeID, dof, coeff) rows
                if k >= len(content):
                    break
                f = _fields(content[k])
                k += 1
                if len(f) >= 3:
                    eqs.append((int(float(f[0])), int(float(f[1])),
                                float(f[2])))
        elif bid == "507" and len(content) >= 22:
            # loads (CNFDB_507.cpp): 21 header lines, then structural
            # load records (7 lines each, terminated by loadID=-1).
            # loadtype 1 = nodal force -> !CLOAD; loadtype 3 = nodal
            # displacement -> !BOUNDARY value (conv_neu2fstr_static.cpp
            # SetCLoad / set_boundary_node_by_507); header grav_on +
            # grav vector -> !DLOAD GRAV (set_dload_grav)
            f3 = _fields(content[2])
            f4 = _fields(content[3])
            if len(f3) >= 4 and int(float(f3[3])) and len(f4) >= 3:
                g = (float(f4[0]), float(f4[1]), float(f4[2]))
                if any(abs(v) > 0 for v in g):
                    grav = g
            k = 21
            while k + 2 < len(content):
                f1 = _fields(content[k])
                if len(f1) < 2 or int(float(f1[0])) == -1:
                    break
                lid = int(float(f1[0]))
                ltype = int(float(f1[1]))
                dof_face = [int(float(v))
                            for v in _fields(content[k + 1])[:3]]
                value = [float(v) for v in _fields(content[k + 2])[:5]]
                if ltype == 1:                       # nodal force
                    for d in range(3):
                        if d < len(dof_face) and dof_face[d]:
                            cloads.append((lid, d + 1, value[d]))
                elif ltype == 3:                     # nodal displacement
                    for d in range(3):
                        if d < len(value):
                            disp507[(lid, d + 1)] = value[d]
                k += 7
        # other blocks skipped
    node_ids_a = np.asarray(node_ids, np.int64)
    coords_a = np.asarray(coords)
    id2idx = {int(g): i2 for i2, g in enumerate(node_ids_a)}
    order: Dict[tuple, List[int]] = {}
    for i2, (eid, et, conn, pid) in enumerate(elems):
        order.setdefault((et, pid), []).append(i2)
    # materials from Block 601 (MAT<id> naming, conv_util.h)
    materials: Dict[str, MaterialDef] = {}
    for mid, mv in mats.items():
        materials[f"MAT{mid}"] = MaterialDef(
            f"MAT{mid}", items={1: [[mv[0], mv[6]]], 2: [[mv[49]]],
                                3: [[mv[36]]]})
    if not materials:
        materials = {"M1": MaterialDef("M1",
                                       items={1: [[210000.0, 0.3]]})}
    blocks = []
    sections = []
    for (et, pid), rows in order.items():
        conn_h = np.asarray([[id2idx[g] for g in elems[r][2]]
                             for r in rows], np.int64)
        eids = np.asarray([elems[r][0] for r in rows], np.int64)
        perm = HECMW2FSTR_ORDER.get(et)
        conn = conn_h[:, np.asarray(perm) - 1] \
            if perm is not None else conn_h
        mid = props.get(pid)
        mname = f"MAT{mid}" if mid in mats else next(iter(materials))
        stype = "SHELL" if et // 100 == 7 else \
            ("BEAM" if et // 100 == 6 else "SOLID")
        sections.append(Section(stype, f"SECT{pid}", mname,
                                [1.0] if stype != "BEAM" else
                                [0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0]))
        blocks.append(ElemBlock(et, eids, conn, conn_h,
                                section_id=len(sections) - 1))
    all_eids = np.concatenate([b.elem_ids for b in blocks]) if blocks \
        else np.zeros(0, np.int64)
    # 506 equation rows -> Equation pytrees (the reference reads one
    # (nodeID, dof, coeff) record per equation — CNFDB_506.cpp
    # read_num_co_list — i.e. single-term pins)
    equations = []
    for nid2, dof, coeff in eqs:
        if nid2 in id2idx and coeff != 0.0:
            equations.append(Equation(
                np.asarray([id2idx[nid2]]), np.asarray([dof]),
                np.asarray([coeff]), 0.0))
    mesh = Mesh(header="FEMAP neutral", coords=coords_a,
                node_ids=node_ids_a, id2idx=id2idx, blocks=blocks,
                sections=sections, materials=materials,
                node_groups={"ALL": np.arange(len(node_ids_a))},
                elem_groups={"ALL": all_eids}, surf_groups={},
                amplitudes={}, equations=equations, contact_pairs=[],
                initial_conditions={})
    # boundary rows: 506 fixes (value 0), overridden by 507 nodal
    # displacements (set_boundary_node_by_507 semantics: the 507 value
    # replaces the zero only on dofs 506 already constrained)
    bnd = []
    for nid2 in sorted(bc506):
        for d in sorted(bc506[nid2]):
            bnd.append((nid2, d, disp507.get((nid2, d), 0.0)))
    mesh.neu_bc = dict(boundary=bnd, cload=sorted(set(cloads)),
                       grav=grav)
    return mesh


def write_fstr_msh(mesh: Mesh, path: str) -> None:
    """Minimal HECMW-ENTIRE '.msh' writer (the neu2fstr output side)."""
    with open(path, "w") as f:
        f.write("!HEADER\n converted by frontistr_tpu neu2fstr\n")
        f.write("!NODE\n")
        for i in range(mesh.n_node):
            x, y, z = mesh.coords[i][:3]
            f.write(f" {mesh.node_ids[i]}, {float(x)!r}, "
                    f"{float(y)!r}, {float(z)!r}\n")
        for b in mesh.blocks:
            f.write(f"!ELEMENT, TYPE={b.etype}\n")
            conn = b.conn_hecmw if b.conn_hecmw is not None else b.conn
            for e in range(len(b.elem_ids)):
                ids = ", ".join(str(mesh.node_ids[g]) for g in conn[e])
                f.write(f" {b.elem_ids[e]}, {ids}\n")
        # element groups per section so !SECTION can bind materials
        for si, sec in enumerate(mesh.sections):
            eids = np.concatenate(
                [b.elem_ids for b in mesh.blocks
                 if b.section_id == si]) if mesh.blocks else []
            f.write(f"!EGROUP, EGRP={sec.egrp}\n")
            for e in eids:
                f.write(f" {int(e)}\n")
        for name, md in mesh.materials.items():
            f.write(f"!MATERIAL, NAME={name}, ITEM={len(md.items)}\n")
            for k in sorted(md.items):
                rows = md.items[k]
                sub = len(rows[0]) if rows else 1
                f.write(f"!ITEM={k}, SUBITEM={sub}\n")
                for row in rows:
                    f.write(" " + ", ".join(repr(float(v))
                                            for v in row) + "\n")
        for sec in mesh.sections:
            f.write(f"!SECTION, TYPE={sec.stype}, EGRP={sec.egrp}, "
                    f"MATERIAL={sec.material}"
                    + (f", SECOPT={sec.opt}" if sec.opt else "") + "\n")
            if sec.values:
                f.write(" " + ", ".join(repr(float(v))
                                        for v in sec.values) + "\n")
        if mesh.equations:
            f.write("!EQUATION\n")
            for eq in mesh.equations:
                f.write(f" {len(eq.nodes)}, {float(eq.const)!r}\n ")
                f.write(", ".join(
                    f"{int(mesh.node_ids[nd])}, {int(df)}, {float(cf)!r}"
                    for nd, df, cf in zip(eq.nodes, eq.dofs, eq.coefs))
                    + "\n")
        for typ, rows in mesh.initial_conditions.items():
            f.write(f"!INITIAL CONDITION, TYPE={typ}\n")
            f.writelines(f" {int(mesh.node_ids[int(k)])}, {float(v)!r}\n"
                         for k, v in rows if k >= 0)
        if mesh.zero_temp:
            f.write(f"!ZERO\n {float(mesh.zero_temp)!r}\n")
        f.write("!END\n")


def write_fstr_cnt(mesh: Mesh, path: str) -> None:
    """Static-analysis .cnt from the converted 506/507 BC data — the
    output side of conv_neu2fstr_static.cpp (SetBoundary/SetCLoad/
    SetDLoad): BOUNDARY rows address literal node ids, like the
    reference's ItoA(nid)-named entries."""
    bc = getattr(mesh, "neu_bc", None) or \
        dict(boundary=[], cload=[], grav=None)
    with open(path, "w") as f:
        f.write("!VERSION\n 3\n!SOLUTION, TYPE=STATIC\n")
        if bc["boundary"]:
            f.write("!BOUNDARY\n")
            for nid, d, v in bc["boundary"]:
                f.write(f" {nid}, {d}, {d}, {v!r}\n")
        if bc["cload"]:
            f.write("!CLOAD\n")
            for nid, d, v in bc["cload"]:
                f.write(f" {nid}, {d}, {v!r}\n")
        if bc["grav"] is not None:
            gx, gy, gz = bc["grav"]
            g = float(np.sqrt(gx * gx + gy * gy + gz * gz))
            f.write("!DLOAD\n ALL, GRAV, "
                    f"{g!r}, {gx / g!r}, {gy / g!r}, {gz / g!r}\n")
        f.write("!SOLVER, METHOD=CG, PRECOND=1\n 10000, 1\n"
                " 1.0e-8, 1.0, 0.0\n!END\n")


def neu2fstr(in_path: str, out_path: str,
             cnt_path: str | None = None) -> Mesh:
    """CLI surface: convert a FEMAP neutral file to an fstr mesh file
    (+ optionally the static .cnt carrying its 506/507 BCs/loads)."""
    mesh = read_neu(in_path)
    write_fstr_msh(mesh, out_path)
    if cnt_path:
        write_fstr_cnt(mesh, cnt_path)
    return mesh


def write_static_workdir(workdir: str, mesh: Mesh, cnt: str,
                         ngroups=("X0", "X1"), egroups=None,
                         sgroups=None, amplitudes=None) -> None:
    """``workdir/{mesh.msh, case.cnt, hecmw_ctrl.dat}``: the mesh with
    the named node groups as ``!NGROUP`` cards, ``egroups`` (name ->
    element ids) as ``!EGROUP``, ``sgroups`` (name -> (n, 2) rows of
    element id and face number) as ``!SGROUP`` and ``amplitudes`` (name
    -> (n, 2) rows of time and value) as ``!AMPLITUDE`` cards, the mesh's
    contact pairs as ``!CONTACT PAIR`` cards (their groups must be among
    the written ones), and the deck ``cnt``."""
    os.makedirs(workdir, exist_ok=True)
    msh = os.path.join(workdir, "mesh.msh")
    write_fstr_msh(mesh, msh)
    end = "!END\n"
    with open(msh, "r+") as f:
        f.seek(0, os.SEEK_END)
        f.seek(f.tell() - len(end))
        f.truncate()
        for g in ngroups:
            ids = mesh.node_ids[np.sort(mesh.node_groups[g])]
            f.write(f"!NGROUP, NGRP={g}\n")
            for k in range(0, len(ids), 10):
                f.write(" " + ", ".join(str(int(v))
                                        for v in ids[k:k + 10]) + "\n")
        for g, ids in (egroups or {}).items():
            f.write(f"!EGROUP, EGRP={g}\n")
            for k in range(0, len(ids), 10):
                f.write(" " + ", ".join(str(int(v))
                                        for v in ids[k:k + 10]) + "\n")
        for g, rows in (sgroups or {}).items():
            f.write(f"!SGROUP, SGRP={g}\n")
            for k in range(0, len(rows), 5):
                f.write(" " + ", ".join(f"{int(e)}, {int(fc)}"
                                        for e, fc in rows[k:k + 5]) + "\n")
        for cp in mesh.contact_pairs:
            f.write(f"!CONTACT PAIR, NAME={cp.name}, TYPE={cp.ctype}\n"
                    f" {cp.slave}, {cp.master}\n")
        for name, rows in (amplitudes or {}).items():
            # the .msh rows hold value, time pairs (meshio AMPLITUDE)
            f.write(f"!AMPLITUDE, NAME={name}, DEFINITION=TABULAR\n")
            for t, v in rows:
                f.write(f" {float(v)!r}, {float(t)!r}\n")
        f.write(end)
    with open(os.path.join(workdir, "case.cnt"), "w") as f:
        f.write(cnt)
    with open(os.path.join(workdir, "hecmw_ctrl.dat"), "w") as f:
        f.write("!MESH, NAME=fstrMSH, TYPE=HECMW-ENTIRE\n mesh.msh\n"
                "!CONTROL, NAME=fstrCNT\n case.cnt\n"
                "!RESULT, NAME=fstrRES, IO=OUT\n mesh.res\n")
