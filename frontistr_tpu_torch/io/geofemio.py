"""GEOFEM grid-file reader ('!MESH, TYPE=GEOFEM').

Replicates hecmw1/src/common/hecmw_io_geofem.c: a free-token stream of
  PE-ID NEIBPEtot [neighbors...]
  NODtot intNODtot  (id x y z)*
  ELMtot (type)*  (id conn...)*
  <import> <export>               (blank for single-PE grids)
  NODgrpTOT [index...] (name items...)*
  ELMgrpTOT [index...] (name items...)*
  SUFgrpTOT [index...] (name elems... surfs...)*
with GeoFEM element-type codes mapped to the HECMW/FSTR numbering
(HECMW_get_etype_GeoFEM2HECMW, hecmw_etype.c:324-380).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from frontistr_tpu_torch.io.meshio import (Mesh, ElemBlock, Section,
                                           MaterialDef)
from frontistr_tpu_torch.elements.tables import HECMW2FSTR_ORDER

# GeoFEM code -> (hecmw etype, nodes)  (hecmw_common_define.h:97-117)
GEOFEM2HECMW = {
    111: (111, 2), 112: (112, 3),
    211: (231, 3), 212: (232, 6),
    221: (241, 4), 222: (242, 8),
    311: (341, 4), 312: (342, 10), 3114: (3414, 4),
    321: (351, 6), 322: (352, 15),
    331: (361, 8), 332: (362, 20), 3314: (3614, 8),
}


class _Toks:
    def __init__(self, text: str):
        self.t = text.split()
        self.i = 0

    def num(self):
        v = self.t[self.i]
        self.i += 1
        return v

    def int_(self):
        return int(float(self.num()))

    def f(self):
        return float(self.num())

    def s(self):
        return self.num()


def read_geofem(path: str) -> Mesh:
    tk = _Toks(open(path).read())
    # PE header
    tk.int_()                              # PE-ID
    n_neib = tk.int_()
    for _ in range(n_neib):
        tk.int_()
    # nodes
    n_node = tk.int_()
    nn_int = tk.int_()
    assert n_node == nn_int, "GEOFEM single-PE grid expected"
    node_ids = np.zeros(n_node, np.int64)
    coords = np.zeros((n_node, 3))
    for i in range(n_node):
        node_ids[i] = tk.int_()
        coords[i] = (tk.f(), tk.f(), tk.f())
    id2idx = {int(g): i for i, g in enumerate(node_ids)}
    # elements
    n_elem = tk.int_()
    gtypes = [tk.int_() for _ in range(n_elem)]
    eids = np.zeros(n_elem, np.int64)
    conns: List[np.ndarray] = []
    for i in range(n_elem):
        eids[i] = tk.int_()
        het, nn = GEOFEM2HECMW[gtypes[i]]
        conns.append(np.asarray([id2idx[tk.int_()] for _ in range(nn)],
                                np.int64))
    # group by hecmw etype preserving first-seen order
    blocks: List[ElemBlock] = []
    order: Dict[int, List[int]] = {}
    for i, gt in enumerate(gtypes):
        order.setdefault(GEOFEM2HECMW[gt][0], []).append(i)
    for het, rows in order.items():
        conn_h = np.stack([conns[i] for i in rows])
        perm = HECMW2FSTR_ORDER.get(het)
        conn = conn_h[:, np.asarray(perm) - 1] \
            if perm is not None else conn_h
        blocks.append(ElemBlock(het, eids[rows], conn, conn_h))
    # import/export: nothing for single PE (the reference just expects
    # blank lines); group sections follow
    def read_grp(pairs=False):
        out = {}
        n = tk.int_()
        if n <= 0:
            return out
        idx = [0] + [tk.int_() for _ in range(n)]
        for g in range(n):
            name = tk.s()
            cnt = idx[g + 1] - idx[g]
            items = [tk.int_() for _ in range(cnt)]
            if pairs:
                surfs = [tk.int_() for _ in range(cnt)]
                out[name] = np.stack(
                    [np.asarray(items, np.int64),
                     np.asarray(surfs, np.int64)], axis=1)
            else:
                out[name] = np.asarray(items, np.int64)
        return out

    ngrp_raw = read_grp()
    egrp_raw = read_grp()
    sgrp = read_grp(pairs=True)
    # node groups: global ids -> local indices
    node_groups = {name: np.asarray(
        [id2idx[int(g)] for g in items if int(g) in id2idx], np.int64)
        for name, items in ngrp_raw.items()}
    node_groups.setdefault("ALL", np.arange(n_node))
    elem_groups = dict(egrp_raw)
    elem_groups.setdefault("ALL", eids.copy())
    # default single section+material (decks provide the real values via
    # the .cnt !MATERIAL cards, like the Abaqus reader)
    materials = {"M1": MaterialDef("M1", items={1: [[210000.0, 0.3]]})}
    sections = [Section("SOLID", "ALL", "M1", [1.0])]
    return Mesh(header="GEOFEM grid", coords=coords, node_ids=node_ids,
                id2idx=id2idx, blocks=blocks, sections=sections,
                materials=materials, node_groups=node_groups,
                elem_groups=elem_groups, surf_groups=sgrp,
                amplitudes={}, equations=[], contact_pairs=[],
                initial_conditions={})
