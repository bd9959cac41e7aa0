"""Abaqus .inp mesh reader -> frontistr_tpu Mesh.

TPU-side equivalent of the reference's flex-based Abaqus front end
(hecmw1/src/common/hecmw_io_abaqus.c + hecmw_ablex.l): supports the card
subset FrontISTR's converter handles — *NODE (NSET=), *ELEMENT (TYPE=,
ELSET=), *NSET / *ELSET (GENERATE), *SOLID SECTION / *SHELL SECTION
(ELSET=, MATERIAL=), *BEAM SECTION, *MATERIAL / *ELASTIC / *DENSITY /
*EXPANSION / *CONDUCTIVITY / *SPECIFIC HEAT, *AMPLITUDE, *HEADING,
*EQUATION, *INITIAL CONDITIONS, *CONTACT PAIR.

Element name map replicated from hecmw_io_abaqus.c:397-431 (abaqus etype ->
hecmw etype, secopt); node ordering: Abaqus solid/shell orderings coincide
with HEC-MW's for the supported types, then the standard hecmw->fstr
permutations of meshio apply.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from frontistr_tpu_torch.io.meshio import (Mesh, ElemBlock, Section,
                                           MaterialDef, Amplitude)
from frontistr_tpu_torch.elements.tables import HECMW2FSTR_ORDER

# abaqus element name -> (hecmw etype, secopt) (hecmw_io_abaqus.c:397-431)
ETYPE_MAP = {
    "B31": (611, 0), "B32": (612, 0),
    "C3D4": (341, 0), "C3D6": (351, 0), "C3D8": (361, 0),
    "C3D8I": (361, 0), "C3D10": (342, 0), "C3D15": (352, 0),
    "C3D20": (362, 0),
    "CAX3": (231, 2), "CAX4": (241, 2), "CAX4I": (241, 2),
    "CAX4R": (241, 12), "CAX6": (232, 2), "CAX8": (242, 2),
    "CAX8R": (242, 12),
    "CPE3": (231, 1), "CPE4": (241, 1), "CPE4I": (241, 1),
    "CPE4R": (241, 11), "CPE6": (232, 1), "CPE8": (242, 1),
    "CPE8R": (242, 11),
    "CPS3": (231, 0), "CPS4": (241, 0), "CPS4I": (241, 0),
    "CPS4R": (241, 10), "CPS6": (232, 0), "CPS8": (242, 0),
    "CPS8R": (242, 10),
    "DC1D2": (111, 0), "DC1D3": (112, 0),
    "DC2D3": (231, 0), "DC2D4": (241, 0), "DC2D6": (232, 0),
    "DC2D8": (242, 0),
    "DC3D4": (341, 0), "DC3D6": (351, 0), "DC3D8": (361, 0),
    "DC3D10": (342, 0), "DC3D15": (352, 0), "DC3D20": (362, 0),
    "DCAX3": (231, 2), "DCAX4": (241, 2), "DCAX6": (232, 0),
    "DCAX8": (242, 0),
    "DINTER4": (541, 0), "DINTER8": (542, 0),
    "INTER4": (541, 0), "INTER8": (542, 0),
    "DS4": (741, 0), "DS8": (742, 0),
    "S3R": (731, 0), "S3": (731, 0), "S4R": (741, 0), "S4": (741, 0),
    "S8R": (742, 0),
    "T3D2": (111, 0), "T3D3": (112, 0),
}


def _parse_keyword(line: str):
    parts = [p.strip() for p in line.lstrip()[1:].split(",")]
    kw = parts[0].upper().replace(" ", "")
    params: Dict[str, str] = {}
    for p in parts[1:]:
        if "=" in p:
            k, v = p.split("=", 1)
            params[k.strip().upper().replace(" ", "")] = v.strip()
        elif p:
            params[p.strip().upper().replace(" ", "")] = "1"
    return kw, params


def _floats(line: str) -> List[float]:
    return [float(t) for t in line.replace(",", " ").split()]


def read_abaqus(path: str) -> Mesh:
    lines = open(path).read().splitlines()
    header = ""
    node_ids: List[int] = []
    coords: List[List[float]] = []
    elems: Dict[tuple, List] = {}        # (etype, elset, secopt) -> rows
    nsets: Dict[str, List[int]] = {}
    elsets: Dict[str, List[int]] = {}
    sections: List[Section] = []
    materials: Dict[str, MaterialDef] = {}
    amplitudes: Dict[str, Amplitude] = {}

    i, n = 0, len(lines)
    cur_mat: MaterialDef = None

    def data_block(start):
        """Collect data lines until the next keyword/comment-or-eof."""
        j = start
        out = []
        while j < n:
            s = lines[j].strip()
            if s.startswith("**"):
                j += 1
                continue
            if s.startswith("*"):
                break
            if s:
                out.append(s)
            j += 1
        return out, j

    while i < n:
        s = lines[i].strip()
        if not s or s.startswith("**"):
            i += 1
            continue
        if not s.startswith("*"):
            i += 1
            continue
        kw, params = _parse_keyword(s)
        if kw == "HEADING":
            data, i = data_block(i + 1)
            header = data[0] if data else ""
        elif kw == "NODE":
            data, i = data_block(i + 1)
            ns = params.get("NSET")
            ids_here = []
            for ln in data:
                toks = ln.replace(",", " ").split()
                nid = int(toks[0])
                xyz = [float(t) for t in toks[1:4]] + [0.0] * 3
                node_ids.append(nid)
                coords.append(xyz[:3])
                ids_here.append(nid)
            if ns:
                nsets.setdefault(ns.upper(), []).extend(ids_here)
        elif kw == "ELEMENT":
            at = params.get("TYPE", "").upper()
            if at not in ETYPE_MAP:
                raise ValueError(f"unsupported Abaqus element type {at}")
            etype, secopt = ETYPE_MAP[at]
            elset = params.get("ELSET", "ALL").upper()
            data, i = data_block(i + 1)
            # continuation lines: a data line ending with ',' continues
            rows, buf = [], ""
            for ln in data:
                buf += ln
                if buf.rstrip().endswith(","):
                    continue
                rows.append([int(t) for t in
                             buf.replace(",", " ").split()])
                buf = ""
            elems.setdefault((etype, elset, secopt), []).extend(rows)
        elif kw in ("NSET", "ELSET"):
            name = params.get(kw, params.get("NSET" if kw == "NSET"
                                             else "ELSET", ""))
            name = (name or "").upper()
            data, i = data_block(i + 1)
            ids = []
            if "GENERATE" in params:
                for ln in data:
                    t = [int(v) for v in ln.replace(",", " ").split()]
                    step = t[2] if len(t) > 2 else 1
                    ids.extend(range(t[0], t[1] + 1, step))
            else:
                for ln in data:
                    for tok in ln.replace(",", " ").split():
                        ids.append(int(tok))
            (nsets if kw == "NSET" else elsets).setdefault(
                name, []).extend(ids)
        elif kw in ("SOLIDSECTION", "SHELLSECTION", "BEAMSECTION"):
            data, i = data_block(i + 1)
            vals: List[float] = []
            for ln in data:
                try:
                    vals.extend(_floats(ln))
                except ValueError:
                    pass
            stype = {"SOLIDSECTION": "SOLID", "SHELLSECTION": "SHELL",
                     "BEAMSECTION": "BEAM"}[kw]
            sections.append(Section(
                stype=stype, egrp=params.get("ELSET", "ALL").upper(),
                material=params.get("MATERIAL", ""), values=vals))
        elif kw == "MATERIAL":
            cur_mat = materials.setdefault(
                params.get("NAME", f"MAT{len(materials)+1}"),
                MaterialDef(params.get("NAME", "")))
            i += 1
        elif kw in ("ELASTIC", "DENSITY", "EXPANSION", "CONDUCTIVITY",
                    "SPECIFICHEAT"):
            data, i = data_block(i + 1)
            if cur_mat is None:
                continue
            rows = [_floats(ln) for ln in data]
            # structural convention: item1=(E,nu), 2=(rho), 3=(alpha);
            # heat shares item1=rho, 2=cp, 3=k (fstr_get_prop / heat_init)
            if kw == "ELASTIC":
                cur_mat.items[1] = rows
            elif kw == "DENSITY":
                cur_mat.items[2] = rows
            elif kw == "EXPANSION":
                cur_mat.items[3] = rows
            elif kw == "CONDUCTIVITY":
                cur_mat.items[3] = rows
            elif kw == "SPECIFICHEAT":
                cur_mat.items[2] = rows
        elif kw == "AMPLITUDE":
            data, i = data_block(i + 1)
            name = params.get("NAME", "").upper()
            pts = []
            for ln in data:
                v = _floats(ln)
                pts.extend(zip(v[0::2], v[1::2]))
            if name:
                t = np.asarray([p[0] for p in pts])
                va = np.asarray([p[1] for p in pts])
                amplitudes[name] = Amplitude(name, "TABULAR", t, va)
        else:
            # skip unknown keyword + its data lines
            _, i = data_block(i + 1)
        if i < n and lines[i].strip().startswith("*") and \
                not lines[i].strip().startswith("**"):
            continue

    node_ids_a = np.asarray(node_ids, np.int64)
    coords_a = np.asarray(coords)
    id2idx = {int(v): k for k, v in enumerate(node_ids_a)}

    blocks: List[ElemBlock] = []
    sec_by_egrp = {sec.egrp: si for si, sec in enumerate(sections)}
    for (etype, elset, secopt), rows in elems.items():
        eids = np.asarray([r[0] for r in rows], np.int64)
        nn = len(rows[0]) - 1
        conn_h = np.asarray([[id2idx[v] for v in r[1:]] for r in rows],
                            np.int64)
        perm = HECMW2FSTR_ORDER.get(etype)
        # the table is 1-based (fstr[k] = hecmw[TABLE[k] - 1], as
        # meshio reads it); the JAX reader indexes it 0-based and
        # raises IndexError on 232/342/352 (ROADMAP fault 12)
        conn = conn_h[:, np.asarray(perm) - 1] if perm is not None \
            else conn_h
        si = sec_by_egrp.get(elset, 0)
        if sections and secopt in (1, 2, 11, 12):
            sections[si].opt = secopt % 10
        blocks.append(ElemBlock(etype, eids, conn, conn_h, section_id=si))
        elsets.setdefault(elset, []).extend(int(e) for e in eids)
        elsets.setdefault("ALL", []).extend(int(e) for e in eids)

    node_groups = {name: np.asarray(sorted({id2idx[i] for i in ids
                                            if i in id2idx}), np.int64)
                   for name, ids in nsets.items()}
    node_groups.setdefault("ALL", np.arange(len(node_ids_a)))
    elem_groups = {name: np.asarray(sorted(set(ids)), np.int64)
                   for name, ids in elsets.items()}
    if not sections:
        mname = next(iter(materials), "")
        sections.append(Section("SOLID", "ALL", mname, []))
    return Mesh(header=header, coords=coords_a, node_ids=node_ids_a,
                id2idx=id2idx, blocks=blocks, sections=sections,
                materials=materials, node_groups=node_groups,
                elem_groups=elem_groups, surf_groups={},
                amplitudes=amplitudes, equations=[], contact_pairs=[],
                initial_conditions={})
