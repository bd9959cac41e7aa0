"""FrontISTR-compatible ``0.log`` summary writer + golden-log parser.

The writer reproduces the Local/Global Summary tables emitted by
fstr_static_Output (fistr1/src/analysis/static/static_output.f90 and
fstr_NodalStress summary printers); the parser mirrors
examples/test_FrontISTR.rb:141-200 (Global Summary / @Element sections,
"13"->"31" key normalization, D-less exponent tolerance).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

LABELS_U = {2: ["U1", "U2"], 3: ["U1", "U2", "U3"]}
LABELS_E = {2: ["E11", "E22", "E12"],
            3: ["E11", "E22", "E33", "E12", "E23", "E13"]}
LABELS_S = {2: ["S11", "S22", "S12"],
            3: ["S11", "S22", "S33", "S12", "S23", "S13"]}


def _fmt(v: float) -> str:
    s = f"{v: .4E}"
    return s


def round4(v: float) -> float:
    """Round through the log's 4-digit exponent format (the golden logs only
    carry 4 significant decimals, so comparisons must round both sides)."""
    return float(f"{v:.4E}")


def static_summaries(dim: int, u, nodal_strain, nodal_stress, nodal_mises,
                     elem_strain, elem_stress, elem_mises, node_count=None):
    """Global Summary max/min dicts over nodes (element-attached only — the
    reference skips nnumber==0 nodes) and elements.  Keys are normalized the
    way test_FrontISTR.rb does ("13" -> "31")."""
    if node_count is not None:
        sel = node_count > 0
    else:
        sel = np.ones(len(u), bool)
    node = {}
    for d in range(dim):
        a = u[sel, d]
        node[f"U{d+1}"] = (round4(a.max()), round4(a.min()))
    for k, lab in enumerate(LABELS_E[dim]):
        a = nodal_strain[sel, k]
        node[lab] = (round4(a.max()), round4(a.min()))
    for k, lab in enumerate(LABELS_S[dim]):
        a = nodal_stress[sel, k]
        node[lab] = (round4(a.max()), round4(a.min()))
    node["SMS"] = (round4(nodal_mises[sel].max()),
                   round4(nodal_mises[sel].min()))
    elem = {}
    for k, lab in enumerate(LABELS_E[dim]):
        a = elem_strain[:, k]
        elem[lab] = (round4(a.max()), round4(a.min()))
    for k, lab in enumerate(LABELS_S[dim]):
        a = elem_stress[:, k]
        elem[lab] = (round4(a.max()), round4(a.min()))
    elem["SMS"] = (round4(elem_mises.max()), round4(elem_mises.min()))
    node = {k.replace("13", "31"): v for k, v in node.items()}
    elem = {k.replace("13", "31"): v for k, v in elem.items()}
    return node, elem


def summary_lines(names: List[str], arrs: List[np.ndarray],
                  ids: np.ndarray) -> Tuple[List[str], List[str]]:
    """Returns (local_lines with ids, global_lines max/min)."""
    loc, glo = [], []
    for name, a in zip(names, arrs):
        imax = int(np.argmax(a))
        imin = int(np.argmin(a))
        loc.append(f"   //{name:<4s}{_fmt(a[imax])} {int(ids[imax]):9d} "
                   f"{_fmt(a[imin])} {int(ids[imin]):9d}")
        glo.append(f"   //{name:<4s}{_fmt(a[imax])} {_fmt(a[imin])}")
    return loc, glo


def write_static_log(path: str, step: int, dim: int,
                     u: np.ndarray, nodal_strain: np.ndarray,
                     nodal_stress: np.ndarray, nodal_mises: np.ndarray,
                     elem_strain: np.ndarray, elem_stress: np.ndarray,
                     elem_mises: np.ndarray, node_ids: np.ndarray,
                     elem_ids: np.ndarray, append: bool = False,
                     header: bool = True, node_count=None):
    if node_count is not None:
        sel = node_count > 0
        u, node_ids = u[sel], node_ids[sel]
        nodal_strain, nodal_stress = nodal_strain[sel], nodal_stress[sel]
        nodal_mises = nodal_mises[sel]
    names_n = (LABELS_U[dim] + LABELS_E[dim] + LABELS_S[dim] + ["SMS"])
    arrs_n = ([u[:, d] for d in range(dim)] +
              [nodal_strain[:, k] for k in range(nodal_strain.shape[1])] +
              [nodal_stress[:, k] for k in range(nodal_stress.shape[1])] +
              [nodal_mises])
    names_e = (LABELS_E[dim] + LABELS_S[dim] + ["SMS"])
    arrs_e = ([elem_strain[:, k] for k in range(elem_strain.shape[1])] +
              [elem_stress[:, k] for k in range(elem_stress.shape[1])] +
              [elem_mises])
    loc_n, glo_n = summary_lines(names_n, arrs_n, node_ids)
    loc_e, glo_e = summary_lines(names_e, arrs_e, elem_ids)
    mode = "a" if append else "w"
    with open(path, mode) as f:
        if header and not append:
            f.write(" fstr_setup: OK\n")
        f.write(f"#### Result step={step:6d}\n")
        f.write(" ##### Local Summary :Max/IdMax/Min/IdMin####\n")
        f.write("\n".join(loc_n) + "\n")
        f.write(" ##### @Element :Max/IdMax/Min/IdMin####\n")
        f.write("\n".join(loc_e) + "\n")
        f.write(" ##### Global Summary :Max/Min####\n")
        f.write("\n".join(glo_n) + "\n")
        f.write(" ##### @Element :Max/Min####\n")
        f.write("\n".join(glo_e) + "\n")


def _to_float(tok: str) -> float:
    # test_FrontISTR.rb to_float: allow "4.5412-317" style exponents
    m = re.match(r"^([0-9.+-]*[0-9.])([+-]\d+)$", tok)
    if m and "E" not in tok.upper():
        tok = m.group(1) + "E" + m.group(2)
    return float(tok)


def parse_log_summaries(path: str) -> Dict[str, Dict[str, Tuple[float, float]]]:
    """Parse Global Summary / @Element sections (last result step wins),
    mirroring test_FrontISTR.rb read_log."""
    data: Dict[str, Dict[str, Tuple[float, float]]] = {}
    with open(path) as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        line = lines[i]
        key = None
        four_col = False
        if re.search(r"Global Summary :Max/Min", line):
            key = "Node"
        elif re.search(r"@Element :Max/Min####", line):
            key = "Element"
        elif re.search(r"Global Summary @Node", line):
            key, four_col = "Node", True     # new format: Max/Id/Min/Id
        elif re.search(r"Global Summary @Element", line):
            key, four_col = "Element", True
        if key:
            sec: Dict[str, Tuple[float, float]] = {}
            i += 1
            while i < len(lines) and "//" in lines[i]:
                toks = lines[i].split()
                name = toks[0].replace("//", "")
                if not four_col:
                    name = name.replace("13", "31")
                    sec[name] = (_to_float(toks[1]), _to_float(toks[2]))
                else:
                    sec[name] = (_to_float(toks[1]), _to_float(toks[3]))
                i += 1
            data[key] = sec
            continue
        i += 1
    return data
