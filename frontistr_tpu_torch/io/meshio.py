"""HEC-MW native ``.msh`` (HECMW-ENTIRE) mesh reader.

Replicates the card grammar of the reference reader
(hecmw1/src/common/hecmw_io_hec.c:78-2119, flex lexer hecmw_heclex.l) for the
cards FrontISTR workloads use: !HEADER !NODE !ELEMENT !SECTION !MATERIAL
!NGROUP !EGROUP !SGROUP !AMPLITUDE !EQUATION !CONTACT PAIR !INITIAL CONDITION
!ZERO !END.  Output is a host-side ``Mesh`` of typed numpy arrays grouped by
element type (the analogue of hecmwST_local_mesh's elem_type_index blocks,
hecmw1/src/common/hecmw_util_f.F90:232-381) — the layout the TPU compute path
consumes directly.

Node connectivity is stored in FSTR kernel ordering (the reference applies
hecmw2fstr_connect_conv for types 232/342/352 at startup,
fistr1/src/common/hecmw2fstr_connect_conv.c:18-20); the original HEC-MW
ordering is kept for file output.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from frontistr_tpu_torch.elements.tables import HECMW2FSTR_ORDER


@dataclasses.dataclass
class Section:
    stype: str                 # SOLID / SHELL / BEAM / INTERFACE
    egrp: str
    material: str
    values: List[float]        # thickness etc.
    # sect_opt: 0=default(plane stress), 1=plane strain, 2=axisymmetric
    # (fstr_setup.f90:1012-1021 maps sect_opt->iset)
    opt: int = 0


@dataclasses.dataclass
class MaterialDef:
    name: str
    # items[k] = list of data rows; item index is 1-based in the file.
    # For structural meshes: item 1 = (E, nu, ...), item 2 = (rho,),
    # item 3 = (alpha,)  (fistr1/src/common/fstr_get_prop.f90:57-119).
    items: Dict[int, List[List[float]]] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Amplitude:
    name: str
    definition: str            # TABULAR
    time: np.ndarray           # abscissa  (VALUE column 2)
    value: np.ndarray          # ordinate  (VALUE column 1)


@dataclasses.dataclass
class Equation:
    """One MPC equation: sum coef_i * u(node_i, dof_i) = const."""
    nodes: np.ndarray          # 0-based node indices
    dofs: np.ndarray           # 1-based dof
    coefs: np.ndarray
    const: float = 0.0


@dataclasses.dataclass
class ElemBlock:
    etype: int
    elem_ids: np.ndarray       # (E,) global element ids
    conn: np.ndarray           # (E, nn) 0-based node indices, FSTR ordering
    conn_hecmw: np.ndarray     # (E, nn) original .msh ordering (for output)
    section_id: int = 0


@dataclasses.dataclass
class ContactPairDef:
    name: str
    ctype: str                 # NODE-SURF / SURF-SURF
    slave: str                 # node group (or slave surf group)
    master: str                # surface group


class GroupDict(dict):
    """Group-name dict with case-insensitive fallback.

    The reference upcases group names on both sides (hecmw mesh readers
    store upcased names; fstr_ctrl_util compares upcased), so a deck
    writing `_PickedSet5` finds the mesh's `_PICKEDSET5`.  Exact match
    wins; otherwise one case-insensitive scan."""

    def __missing__(self, k):
        if isinstance(k, str):
            ku = k.upper()
            for kk in self:
                if isinstance(kk, str) and kk.upper() == ku:
                    return dict.__getitem__(self, kk)
        raise KeyError(k)

    def get(self, k, default=None):
        try:
            return self[k]
        except KeyError:
            return default

    def __contains__(self, k):
        if dict.__contains__(self, k):
            return True
        if isinstance(k, str):
            ku = k.upper()
            return any(isinstance(kk, str) and kk.upper() == ku
                       for kk in self)
        return False


@dataclasses.dataclass
class Mesh:
    header: str
    coords: np.ndarray                       # (n_node, 3) float64
    node_ids: np.ndarray                     # (n_node,) int64 global ids
    id2idx: Dict[int, int]
    blocks: List[ElemBlock]
    sections: List[Section]
    materials: Dict[str, MaterialDef]
    node_groups: Dict[str, np.ndarray]       # 0-based node indices
    elem_groups: Dict[str, np.ndarray]       # global element ids
    surf_groups: Dict[str, np.ndarray]       # (n,2) [global elem id, face no]
    amplitudes: Dict[str, Amplitude]
    equations: List[Equation]
    contact_pairs: List[ContactPairDef]
    initial_conditions: Dict[str, np.ndarray]
    zero_temp: float = 0.0
    # (nx, ny, nz) when the mesh is a structured hex box in meshgen
    # ordering -- unlocks the gather-free stencil operator on TPU
    structured: tuple = None

    def __post_init__(self):
        # every construction path (native/Abaqus/NASTRAN/GEOFEM/DIST/
        # meshgen/refine) gets case-insensitive group resolution
        self.node_groups = GroupDict(self.node_groups or {})
        self.elem_groups = GroupDict(self.elem_groups or {})
        self.surf_groups = GroupDict(self.surf_groups or {})

    @property
    def n_node(self) -> int:
        return len(self.coords)

    @property
    def n_elem(self) -> int:
        return sum(len(b.elem_ids) for b in self.blocks)

    def elem_id_to_block(self) -> Dict[int, Tuple[int, int]]:
        out = {}
        for bi, b in enumerate(self.blocks):
            for k, eid in enumerate(b.elem_ids):
                out[int(eid)] = (bi, k)
        return out

    def material_for_block(self, block: ElemBlock) -> MaterialDef:
        sec = self.sections[block.section_id]
        return self.materials[sec.material]


_num_re = re.compile(r"[,\s]+")


def _split_data(line: str) -> List[str]:
    return [t for t in _num_re.split(line.strip().strip(",")) if t]


def _parse_header_line(line: str):
    body = line.strip()[1:]
    parts = [p.strip() for p in body.split(",")]
    card = parts[0].upper()
    params: Dict[str, str] = {}
    if "=" in card:  # e.g. "!ITEM=1, SUBITEM=2"
        card, v = card.split("=", 1)
        card = card.strip()
        params[card] = v.strip()
    for p in parts[1:]:
        if "=" in p:
            k, v = p.split("=", 1)
            params[k.strip().upper()] = v.strip()
        elif p:
            params[p.strip().upper()] = "1"
    return card, params


def read_mesh(path: str, native: bool = None) -> Mesh:
    """Parse a .msh deck.  With native=True (or FRONTISTR_TPU_NATIVE_IO=1)
    the data-heavy !NODE/!ELEMENT cards are scanned by the C++ tokenizer
    (native/meshscan.cpp) and the Python pass only handles the card tail;
    requires the deck's node groups to not be defined via multiple
    NGRP-tagged !NODE cards (falls back otherwise)."""
    import os as _os
    if native is None:
        native = _os.environ.get("FRONTISTR_TPU_NATIVE_IO", "0") == "1"
    fast = None
    if native:
        from frontistr_tpu_torch.io import fastmesh
        fast = fastmesh.scan(path)
    with open(path, errors="replace") as f:
        lines = f.readlines()
    if fast is not None:
        n_ngrp_node_cards = sum(
            1 for ln in lines
            if ln.lstrip().upper().startswith("!NODE") and "NGRP" in
            ln.upper())
        elem_egrp = any(ln.lstrip().upper().startswith("!ELEMENT") and
                        "EGRP" in ln.upper() for ln in lines)
        if n_ngrp_node_cards > 1 or elem_egrp:
            fast = None

    header_txt = ""
    node_ids: List[int] = []
    node_xyz: List[Tuple[float, float, float]] = []
    raw_elems: Dict[int, Tuple[List[int], List[List[int]], Optional[str]]] = {}
    sections: List[Section] = []
    materials: Dict[str, MaterialDef] = {}
    ngrp_raw: Dict[str, List[int]] = {}
    egrp_raw: Dict[str, List[int]] = {}
    sgrp_raw: Dict[str, List[Tuple[int, int]]] = {}
    amplitudes: Dict[str, Amplitude] = {}
    equations_raw: List[Tuple[int, List[Tuple[int, int, float]], float]] = []
    contact_pairs: List[ContactPairDef] = []
    initial_cond: Dict[str, List[Tuple[int, float]]] = {}
    zero_temp = 0.0

    i = 0
    card, params = None, {}
    cur_mat: Optional[MaterialDef] = None
    cur_item = 0
    eqn_pending: Optional[int] = None

    def data_lines_until_next_card(start):
        j = start
        out = []
        while j < len(lines):
            s = lines[j].strip()
            if s.startswith("!") and not s.startswith("!!"):
                break
            if s.startswith("*"):  # trailing Abaqus-style deck (ignored)
                break
            if s and not s.startswith("#") and not s.startswith("!!"):
                out.append(s)
            j += 1
        return out, j

    while i < len(lines):
        s = lines[i].strip()
        if not s or s.startswith("#") or s.startswith("!!"):
            i += 1
            continue
        if s.startswith("*"):
            break  # some fixtures append an Abaqus deck after !END
        if not s.startswith("!"):
            i += 1
            continue
        card, params = _parse_header_line(s)

        if card == "END":
            break

        if card == "HEADER":
            data, i = data_lines_until_next_card(i + 1)
            header_txt = "\n".join(data)
            continue

        if card == "NODE":
            data, i = data_lines_until_next_card(i + 1)
            if fast is not None:
                if "NGRP" in params:
                    ngrp_raw.setdefault(params["NGRP"], []).extend(
                        fast["node_ids"].tolist())
                continue
            ids = []
            for ln in data:
                t = _split_data(ln)
                ids.append(int(t[0]))
                x = float(t[1]) if len(t) > 1 else 0.0
                y = float(t[2]) if len(t) > 2 else 0.0
                z = float(t[3]) if len(t) > 3 else 0.0
                node_ids.append(ids[-1])
                node_xyz.append((x, y, z))
            if "NGRP" in params:
                ngrp_raw.setdefault(params["NGRP"], []).extend(ids)
            continue

        if card == "ELEMENT":
            etype = int(params["TYPE"])
            egrp = params.get("EGRP")
            data, i = data_lines_until_next_card(i + 1)
            if fast is not None:
                continue
            ids, conns = raw_elems.setdefault(etype, ([], [], egrp))[:2]
            pend: List[int] = []
            for ln in data:
                t = _split_data(ln)
                vals = [int(v) for v in t]
                if not pend:
                    eid, nodes = vals[0], vals[1:]
                else:
                    eid = pend[0]
                    nodes = pend[1:] + vals
                from frontistr_tpu_torch.elements.tables import ETYPE_INFO
                nn = ETYPE_INFO.get(etype, (0, len(nodes), 0, 0))[1]
                if len(nodes) < nn:
                    pend = [eid] + nodes
                    continue
                pend = []
                ids.append(eid)
                conns.append(nodes)
                if egrp:
                    egrp_raw.setdefault(egrp, []).append(eid)
            continue

        if card == "SECTION":
            data, i = data_lines_until_next_card(i + 1)
            vals: List[float] = []
            for ln in data:
                vals.extend(float(v) for v in _split_data(ln))
            opt = 0
            if "SECOPT" in params:
                opt = int(params["SECOPT"])
            sections.append(Section(
                stype=params.get("TYPE", "SOLID").upper(),
                egrp=params.get("EGRP", "ALL"),
                material=params.get("MATERIAL", ""),
                values=vals, opt=opt))
            continue

        if card == "MATERIAL":
            name = params.get("NAME", f"MAT{len(materials)+1}")
            cur_mat = materials.setdefault(name, MaterialDef(name))
            cur_item = 0
            i += 1
            continue

        if card == "ITEM":
            cur_item = int(params.get("ITEM", "1"))
            data, i = data_lines_until_next_card(i + 1)
            rows = [[float(v) for v in _split_data(ln)] for ln in data]
            if cur_mat is not None:
                cur_mat.items[cur_item] = rows
            continue

        if card == "NGROUP":
            grp = params["NGRP"]
            data, i = data_lines_until_next_card(i + 1)
            acc = ngrp_raw.setdefault(grp, [])
            if "GENERATE" in params:
                for ln in data:
                    t = [int(v) for v in _split_data(ln)]
                    start, end = t[0], t[1]
                    step = t[2] if len(t) > 2 else 1
                    acc.extend(range(start, end + 1, step))
            else:
                for ln in data:
                    acc.extend(int(v) for v in _split_data(ln))
            continue

        if card == "EGROUP":
            grp = params["EGRP"]
            data, i = data_lines_until_next_card(i + 1)
            acc = egrp_raw.setdefault(grp, [])
            if "GENERATE" in params:
                for ln in data:
                    t = [int(v) for v in _split_data(ln)]
                    step = t[2] if len(t) > 2 else 1
                    acc.extend(range(t[0], t[1] + 1, step))
            else:
                for ln in data:
                    acc.extend(int(v) for v in _split_data(ln))
            continue

        if card == "SGROUP":
            grp = params["SGRP"]
            data, i = data_lines_until_next_card(i + 1)
            acc = sgrp_raw.setdefault(grp, [])
            for ln in data:
                t = [int(v) for v in _split_data(ln)]
                for k in range(0, len(t) - 1, 2):
                    acc.append((t[k], t[k + 1]))
            continue

        if card == "AMPLITUDE":
            name = params["NAME"]
            data, i = data_lines_until_next_card(i + 1)
            vals: List[float] = []
            for ln in data:
                vals.extend(float(v) for v in _split_data(ln))
            va = np.asarray(vals[0::2])
            ta = np.asarray(vals[1::2])
            amplitudes[name] = Amplitude(name, params.get("DEFINITION", "TABULAR"),
                                         ta, va)
            continue

        if card == "EQUATION":
            data, i = data_lines_until_next_card(i + 1)
            k = 0
            while k < len(data):
                t = _split_data(data[k])
                neq = int(t[0])
                const = float(t[1]) if len(t) > 1 else 0.0
                terms: List[Tuple[int, int, float]] = []
                k += 1
                while len(terms) < neq and k < len(data):
                    t = _split_data(data[k])
                    for m in range(0, len(t) - 2, 3):
                        terms.append((int(t[m]), int(t[m + 1]), float(t[m + 2])))
                    k += 1
                equations_raw.append((neq, terms, const))
            continue

        if card == "CONTACT PAIR" or card == "CONTACT_PAIR":
            data, i = data_lines_until_next_card(i + 1)
            for ln in data:
                t = _split_data(ln)
                contact_pairs.append(ContactPairDef(
                    name=params.get("NAME", f"CP{len(contact_pairs)+1}"),
                    ctype=params.get("TYPE", "NODE-SURF").upper(),
                    slave=t[0], master=t[1]))
            continue

        if card == "INITIAL CONDITION" or card == "INITIAL_CONDITION":
            typ = params.get("TYPE", "TEMPERATURE").upper()
            data, i = data_lines_until_next_card(i + 1)
            acc2 = initial_cond.setdefault(typ, [])
            for ln in data:
                t = _split_data(ln)
                acc2.append((int(t[0]) if t[0].lstrip("-").isdigit() else t[0],
                             float(t[1])))
            continue

        if card == "ZERO":
            data, i = data_lines_until_next_card(i + 1)
            if data:
                zero_temp = float(_split_data(data[0])[0])
            continue

        # unknown card: skip its data
        _, i = data_lines_until_next_card(i + 1)

    # ---- finalize ---------------------------------------------------------
    if fast is not None:
        node_ids_a = fast["node_ids"]
        coords = fast["coords"]
        for et, ids, cn in fast["blocks"]:
            lst = raw_elems.setdefault(et, ([], [], None))
            lst[0].extend(ids.tolist())
            lst[1].extend(cn.tolist())
        node_ids = node_ids_a.tolist()
        node_xyz = coords
    else:
        node_ids_a = np.asarray(node_ids, dtype=np.int64)
        coords = np.asarray(node_xyz, dtype=np.float64)
    node_ids_a = np.asarray(node_ids_a, dtype=np.int64)
    coords = np.asarray(coords, dtype=np.float64)
    order = np.argsort(node_ids_a, kind="stable")
    node_ids_a = node_ids_a[order]
    coords = coords[order]
    id2idx = {int(g): k for k, g in enumerate(node_ids_a)}

    blocks: List[ElemBlock] = []
    for etype in sorted(raw_elems):
        ids, conns, _ = raw_elems[etype]
        conn_h = np.asarray(
            [[id2idx[g] for g in c] for c in conns], dtype=np.int32)
        perm = HECMW2FSTR_ORDER.get(etype)
        conn_f = conn_h[:, np.asarray(perm) - 1] if perm else conn_h
        blocks.append(ElemBlock(etype, np.asarray(ids, dtype=np.int64),
                                conn_f, conn_h))

    # map sections onto blocks via egroups
    egroups = {g: np.asarray(sorted(set(v)), dtype=np.int64)
               for g, v in egrp_raw.items()}
    all_ids = np.concatenate([b.elem_ids for b in blocks]) if blocks else \
        np.zeros(0, np.int64)
    egroups.setdefault("ALL", np.sort(all_ids))
    for b in blocks:
        b.section_id = 0
        for si, sec in enumerate(sections):
            grp = egroups.get(sec.egrp)
            if grp is not None and len(grp) and np.isin(b.elem_ids, grp).all():
                b.section_id = si
                break

    ngroups = {}
    for g, v in ngrp_raw.items():
        idx = [id2idx[int(n)] for n in v if int(n) in id2idx]
        ngroups[g] = np.unique(np.asarray(idx, dtype=np.int64))
    # implicit whole-mesh group (fstr_setup_util group resolution)
    ngroups.setdefault("ALL", np.arange(len(node_ids_a), dtype=np.int64))

    sgroups = {g: np.asarray(v, dtype=np.int64).reshape(-1, 2)
               for g, v in sgrp_raw.items()}

    equations = []
    for neq, terms, const in equations_raw:
        nd = np.asarray([id2idx[t[0]] for t in terms], dtype=np.int64)
        df = np.asarray([t[1] for t in terms], dtype=np.int64)
        cf = np.asarray([t[2] for t in terms], dtype=np.float64)
        equations.append(Equation(nd, df, cf, const))

    init_c = {}
    for typ, rows in initial_cond.items():
        arr = np.zeros((len(rows), 2))
        for k, (nid, val) in enumerate(rows):
            arr[k, 0] = id2idx.get(int(nid), -1) if isinstance(nid, int) else -1
            arr[k, 1] = val
        init_c[typ] = arr

    return Mesh(header_txt, coords, node_ids_a, id2idx, blocks, sections,
                materials, ngroups, egroups, sgroups, amplitudes, equations,
                contact_pairs, init_c, zero_temp)
