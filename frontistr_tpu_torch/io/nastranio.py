"""NASTRAN bulk-data mesh reader -> frontistr_tpu Mesh.

TPU-side equivalent of the reference's NASTRAN front end
(hecmw1/src/common/hecmw_io_nastran.c, 3.6k LoC): supports the card set
the converter handles — GRID, CROD, CBAR, CTRIA3/6, CQUAD4/8, CTETRA
(4/10), CPENTA (6/15), CHEXA (8/20), PSOLID, PSHELL, PROD, MAT1 — in
free-field (comma), small-field (8-column) and large-field (16-column,
'*' continuation) formats with continuation lines.

Element-type map: CTETRA->341/342, CPENTA->351/352, CHEXA->361/362,
CQUAD4->741 shell if PSHELL else 241, CTRIA3->731/231, CROD->111,
CBAR->611 (hecmw_io_nastran.c GENERATE_CODE table at :1918-1945).
Property id (PID) partitions elements into sections; MAT1 provides
(E, nu, rho)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from frontistr_tpu_torch.io.meshio import (Mesh, ElemBlock, Section,
                                           MaterialDef)
from frontistr_tpu_torch.elements.tables import HECMW2FSTR_ORDER


def _fields(line: str) -> List[str]:
    """Split a bulk-data line into fields (free / small / large)."""
    if "," in line:
        return [t.strip() for t in line.split(",")]
    if line[:8].rstrip().endswith("*") or line.startswith("*"):
        # large field: 8 + 4x16 columns
        out = [line[:8].strip().rstrip("*")]
        body = line[8:72]
        for i in range(0, len(body), 16):
            out.append(body[i:i + 16].strip())
        return out
    out = []
    for i in range(0, min(len(line), 80), 8):
        out.append(line[i:i + 8].strip())
    return out


def _num(tok: str) -> float:
    """NASTRAN floats may embed the exponent sign: 1.23-4 = 1.23e-4."""
    tok = tok.strip()
    if not tok:
        return 0.0
    try:
        return float(tok)
    except ValueError:
        for i in range(len(tok) - 1, 0, -1):
            if tok[i] in "+-" and tok[i - 1] not in "eEdD":
                return float(tok[:i] + "e" + tok[i:])
        raise


_SOLID = {"CTETRA": {4: 341, 10: 342}, "CPENTA": {6: 351, 15: 352},
          "CHEXA": {8: 361, 20: 362}}


def read_nastran(path: str) -> Mesh:
    raw = open(path).read().splitlines()
    # join continuations: a line starting with '+', '*' (cont) or blank
    # first field continues the previous card
    cards: List[List[str]] = []
    in_bulk = False
    for ln in raw:
        s = ln.rstrip()
        if not s or s.startswith("$"):
            continue
        u = s.upper()
        if u.startswith("BEGIN BULK"):
            in_bulk = True
            continue
        if u.startswith("ENDDATA"):
            break
        if not in_bulk and not any(u.startswith(k) for k in
                                   ("GRID", "C", "P", "MAT")):
            continue
        f = _fields(s)
        if f and (f[0] == "" or f[0].startswith("+")
                  or f[0].startswith("*") and cards):
            if cards:
                cards[-1].extend(f[1:])
            continue
        cards.append(f)

    node_ids, coords = [], []
    elems: Dict[tuple, List] = {}      # (name, pid) -> rows
    mats: Dict[int, tuple] = {}        # mid -> (E, nu, rho)
    props: Dict[int, tuple] = {}       # pid -> (kind, mid, thick)
    for f in cards:
        name = f[0].upper()
        if name == "GRID":
            node_ids.append(int(f[1]))
            coords.append([_num(f[3]), _num(f[4]),
                           _num(f[5]) if len(f) > 5 else 0.0])
        elif name in _SOLID or name in ("CQUAD4", "CQUAD8", "CTRIA3",
                                        "CTRIA6", "CROD", "CBAR"):
            eid, pid = int(f[1]), int(f[2])
            nodes = [int(t) for t in f[3:] if t and _is_int(t)]
            elems.setdefault((name, pid), []).append((eid, nodes))
        elif name == "MAT1":
            mid = int(f[1])
            E = _num(f[2])
            G = _num(f[3]) if len(f) > 3 and f[3] else 0.0
            nu = _num(f[4]) if len(f) > 4 and f[4] else \
                (E / (2 * G) - 1.0 if G else 0.3)
            rho = _num(f[5]) if len(f) > 5 and f[5] else 0.0
            mats[mid] = (E, nu, rho)
        elif name == "PSOLID":
            props[int(f[1])] = ("SOLID", int(f[2]), 1.0)
        elif name == "PSHELL":
            props[int(f[1])] = ("SHELL", int(f[2]),
                                _num(f[3]) if len(f) > 3 else 1.0)
        elif name == "PROD":
            props[int(f[1])] = ("SOLID", int(f[2]),
                                _num(f[3]) if len(f) > 3 else 1.0)

    node_ids_a = np.asarray(node_ids, np.int64)
    coords_a = np.asarray(coords)
    id2idx = {int(v): k for k, v in enumerate(node_ids_a)}

    materials: Dict[str, MaterialDef] = {}
    mat_name: Dict[int, str] = {}
    for mid, (E, nu, rho) in mats.items():
        nm = f"MAT{mid}"
        md = MaterialDef(nm)
        md.items[1] = [[E, nu]]
        md.items[2] = [[rho]]
        materials[nm] = md
        mat_name[mid] = nm

    sections: List[Section] = []
    blocks: List[ElemBlock] = []
    elem_groups: Dict[str, list] = {"ALL": []}
    for (name, pid), rows in elems.items():
        kind, mid, thick = props.get(pid, ("SOLID", 0, 1.0))
        nn = len(rows[0][1])
        if name in _SOLID:
            etype = _SOLID[name][nn]
        elif name == "CQUAD4":
            etype = 741 if kind == "SHELL" else 241
        elif name == "CQUAD8":
            etype = 742 if kind == "SHELL" else 242
        elif name == "CTRIA3":
            etype = 731 if kind == "SHELL" else 231
        elif name == "CTRIA6":
            etype = 232
        elif name == "CROD":
            etype = 111
        elif name == "CBAR":
            etype = 611
        else:
            continue
        eids = np.asarray([r[0] for r in rows], np.int64)
        conn_h = np.asarray([[id2idx[v] for v in r[1]] for r in rows],
                            np.int64)
        perm = HECMW2FSTR_ORDER.get(etype)
        # the table is 1-based (fstr[k] = hecmw[TABLE[k] - 1], as
        # meshio reads it); the JAX reader indexes it 0-based and
        # raises IndexError on 232/342/352 (ROADMAP fault 12)
        conn = conn_h[:, np.asarray(perm) - 1] if perm is not None \
            else conn_h
        si = len(sections)
        grp = f"P{pid}"
        sections.append(Section(
            stype=kind, egrp=grp, material=mat_name.get(mid, ""),
            values=[thick]))
        blocks.append(ElemBlock(etype, eids, conn, conn_h,
                                section_id=si))
        elem_groups.setdefault(grp, []).extend(int(e) for e in eids)
        elem_groups["ALL"].extend(int(e) for e in eids)

    elem_groups_a = {k: np.asarray(sorted(set(v)), np.int64)
                     for k, v in elem_groups.items()}
    node_groups = {"ALL": np.arange(len(node_ids_a))}
    return Mesh(header="nastran", coords=coords_a, node_ids=node_ids_a,
                id2idx=id2idx, blocks=blocks, sections=sections,
                materials=materials, node_groups=node_groups,
                elem_groups=elem_groups_a, surf_groups={},
                amplitudes={}, equations=[], contact_pairs=[],
                initial_conditions={})


def _is_int(tok: str) -> bool:
    try:
        int(tok)
        return True
    except ValueError:
        return False
