"""Adaptive mesh refinement: ZZ error marking + red/green tet bisection
(host numpy, copied from ``frontistr_tpu/adapt.py``; only the imports
differ).

Equivalent of HEC-MW's adaptation subsystem
(hecmw1/src/operations/adaptation/hecmw_adapt_proc.f90 pipeline:
EXTEMB pattern extension -> GRID_SMOOTH admissibility -> NEW_NODE /
NEW_CELL with the 341 embedding templates of
hecmw_adapt_new_cell_341.f90).  The reference marks elements, extends
the embedding so every cell carries an admissible split pattern, then
emits children per pattern; this module does the same with the standard
red/green taxonomy on tet4 meshes:

  red      all 6 edges split -> 8 children (matches io/refine.py)
  green-1  one split edge    -> 2 children
  green-2a two split edges on a common face -> 3 children
  green-2b opposite split edges             -> 4 children
  green-3  one fully-split face             -> 4 children
  (any other pattern is promoted to red and the closure re-iterated,
   the GRID_SMOOTH role)

and, per hecmw_adapt_new_cell_351.f90, on prism6 (351) blocks —
prisms refine IN PLANE only: the three triangle edge PAIRS (bottom
edge k + its top twin) are the splittable entities, vertical edges
never split (TYP-1/2/3 = one pair -> 2 children, TYP-4 = all three
pairs -> 4 children; two pairs is inadmissible and promotes to
TYP-4).  Mixed tet+prism meshes stay conforming when they meet at
triangle faces (the boundary-layer + tet-fill layout); a tet split
that would cut a prism's vertical edge raises.

Marking uses the Zienkiewicz-Zhu recovered-stress indicator: eta_e =
|sigma*(recovered nodal, averaged over the element) - sigma_e| sqrt(Ve)
— the recovery-based estimate the reference leaves to the user (its
adaptation API takes user marks).

Host-side numpy (mesh surgery is setup, not compute); the refined mesh
feeds straight back into ``build_struct_model``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from frontistr_tpu_torch.io.meshio import Mesh, ElemBlock

# tet edges in (local a, local b) order
_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
# faces as local vertex triples and their 3 edge ids
_FACES = [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]
_FACE_EDGES = [(0, 1, 3), (0, 2, 4), (1, 2, 5), (3, 4, 5)]


def zz_error(mesh: Mesh, res) -> np.ndarray:
    """Element ZZ indicator from a StaticResult: the recovered
    (nodal-averaged) stress minus the element stress, L2-ish weighted
    by sqrt(element volume).  Returns (n_elem_total,) in elem_ids
    order."""
    ns = np.asarray(res.nodal_stress)[:, :6]
    out = []
    k = 0
    for b in mesh.blocks:
        E = b.conn.shape[0]
        sig_e = np.asarray(res.elem_stress)[k:k + E, :6]
        k += E
        rec = ns[b.conn].mean(axis=1)                # (E, 6)
        x = mesh.coords[b.conn]
        if b.conn.shape[1] == 4 and b.etype == 341:
            vol = np.abs(np.linalg.det(x[:, 1:] - x[:, :1])) / 6.0
        else:
            vol = np.ones(E)
        out.append(np.linalg.norm(rec - sig_e, axis=1) * np.sqrt(vol))
    return np.concatenate(out)


def mark_fraction(eta: np.ndarray, elem_ids: np.ndarray,
                  fraction: float = 0.3) -> np.ndarray:
    """Element ids of the top-`fraction` error carriers."""
    n = max(1, int(round(fraction * len(eta))))
    order = np.argsort(eta)[::-1][:n]
    return np.asarray(elem_ids)[order]


# prism (351): bottom tri edges pair with their top twins; vertical
# edges are (0,3) (1,4) (2,5) and never split
_PEDGES = [((0, 1), (3, 4)), ((1, 2), (4, 5)), ((2, 0), (5, 3))]
_PVERT = [(0, 3), (1, 4), (2, 5)]


def _key(conn_row, a, b):
    u, v = int(conn_row[a]), int(conn_row[b])
    return (min(u, v), max(u, v))


def _closure(conn: np.ndarray, marked: np.ndarray, is_prism=None):
    """Split-edge closure over a mixed tet4/prism6 row set: marked
    elements split all their splittable edges; every element is then
    promoted to red until its pattern is admissible (tet: 0 / 1 edge /
    2 same-face / 2 opposite / 3 forming a face; prism: 0 / 1 / 3
    triangle-edge pairs)."""
    E = conn.shape[0]
    if is_prism is None:
        is_prism = np.zeros(E, bool)
    frozen = set()
    for e in np.flatnonzero(is_prism):
        for (a, b) in _PVERT:
            frozen.add(_key(conn[e], a, b))

    def tet_keys(e):
        return [_key(conn[e], *_EDGES[i]) for i in range(6)]

    def prism_pairs(e):
        return [(_key(conn[e], *lo), _key(conn[e], *hi))
                for lo, hi in _PEDGES]

    split = set()
    red = np.zeros(E, bool)
    red[marked] = True

    def paint(e):
        if is_prism[e]:
            for klo, khi in prism_pairs(e):
                split.add(klo)
                split.add(khi)
        else:
            for k in tet_keys(e):
                if k in frozen:
                    raise NotImplementedError(
                        "adapt_mesh: a tet split would cut a prism's "
                        "vertical edge — refine the prism layer "
                        "uniformly instead (hecmw GRID_SMOOTH scope)")
                split.add(k)

    for e in np.flatnonzero(red):
        paint(e)
    changed = True
    while changed:
        changed = False
        for e in range(E):
            if red[e]:
                continue
            if is_prism[e]:
                ns = sum((klo in split or khi in split)
                         for klo, khi in prism_pairs(e))
                ok = ns in (0, 1, 3)
                # pair conformity: both twins must split together
                for klo, khi in prism_pairs(e):
                    if (klo in split) != (khi in split):
                        ok = False
                if not ok:
                    red[e] = True
                    before = len(split)
                    paint(e)
                    changed |= len(split) > before
            else:
                pat = [i for i, k in enumerate(tet_keys(e))
                       if k in split]
                if _pattern(pat) is None:
                    red[e] = True
                    before = len(split)
                    paint(e)
                    changed |= len(split) > before
    return red, split


def _pattern(pat: List[int]):
    """Classify a split-edge id list; None = inadmissible (-> red)."""
    if len(pat) == 0:
        return ("none",)
    if len(pat) == 1:
        return ("g1", pat[0])
    if len(pat) == 2:
        i, j = pat
        for fe in _FACE_EDGES:
            if i in fe and j in fe:
                return ("g2a", i, j)
        # opposite pairs: (0,5) (1,4) (2,3)
        if {i, j} in ({0, 5}, {1, 4}, {2, 3}):
            return ("g2b", i, j)
        return None
    if len(pat) == 3:
        for f, fe in enumerate(_FACE_EDGES):
            if set(pat) == set(fe):
                return ("g3", f)
        return None
    if len(pat) == 6:
        return ("red",)
    return None


def _green_children(row, pat, mid):
    """Child connectivities (lists of global node ids) for a green
    pattern; `mid[(u,v)]` is the midpoint node of global edge (u,v)."""
    def m(i):
        a, b = _EDGES[i]
        u, v = int(row[a]), int(row[b])
        return mid[(min(u, v), max(u, v))]

    def key(i):
        a, b = _EDGES[i]
        u, v = int(row[a]), int(row[b])
        return (min(u, v), max(u, v))

    n = [int(x) for x in row]
    kind = pat[0]
    if kind == "g1":
        i = pat[1]
        a, b = _EDGES[i]
        # replace one endpoint with the midpoint: orientation preserved
        ch1 = n.copy()
        ch1[b] = m(i)
        ch2 = n.copy()
        ch2[a] = m(i)
        return [ch1, ch2]
    if kind == "g2a":
        i, j = pat[1], pat[2]
        # shared vertex a; face (a, b, c) holds both edges, d = apex
        sa = set(_EDGES[i]) & set(_EDGES[j])
        a = sa.pop()
        b = (set(_EDGES[i]) - {a}).pop()
        c = (set(_EDGES[j]) - {a}).pop()
        d = (set(range(4)) - {a, b, c}).pop()
        m1, m2 = m(i), m(j)
        A, B, C, D = n[a], n[b], n[c], n[d]
        # the quad (m1, B, C, m2) diagonal must match the neighbor
        # across the face: connect the midpoint of the GLOBALLY smaller
        # edge to the opposite face vertex (both sides compute the same)
        if key(i) < key(j):
            quad = [[m1, B, C, D], [m1, C, m2, D]]
        else:
            quad = [[m1, B, m2, D], [B, C, m2, D]]
        return [[A, m1, m2, D]] + quad
    if kind == "g2b":
        i, j = pat[1], pat[2]
        a, b = _EDGES[i]
        c, d = _EDGES[j]
        m1, m2 = m(i), m(j)
        out = []
        for (p, q) in ((a, c), (a, d), (b, c), (b, d)):
            ch = n.copy()
            ch[b if p == a else a] = m1
            ch[d if q == c else c] = m2
            out.append(ch)
        return out
    if kind == "g3":
        f = pat[1]
        va, vb, vc = _FACES[f]
        vd = (set(range(4)) - {va, vb, vc}).pop()
        iab = _EDGES.index((min(va, vb), max(va, vb)))
        ibc = _EDGES.index((min(vb, vc), max(vb, vc)))
        ica = _EDGES.index((min(va, vc), max(va, vc)))
        mab, mbc, mca = m(iab), m(ibc), m(ica)
        out = []
        for tri in ((n[va], mab, mca), (mab, n[vb], mbc),
                    (mca, mbc, n[vc]), (mab, mbc, mca)):
            ch = [0, 0, 0, 0]
            ch[va], ch[vb], ch[vc] = tri
            ch[vd] = n[vd]
            out.append(ch)
        return out
    raise ValueError(kind)


_RED = None


def _red_children(row, mid):
    """8-child red split (same template as io/refine.py tet path)."""
    from frontistr_tpu_torch.io.refine import _tet_children
    global _RED
    if _RED is None:
        _RED = _tet_children()
    out = []
    for ch in _RED:
        ids = []
        for key in ch:
            ks = sorted(int(row[i]) for i in key)
            if len(ks) == 1:
                ids.append(ks[0])
            else:
                ids.append(mid[(ks[0], ks[1])])
        out.append(ids)
    return out


def _prism_children(row, mid, n_pairs):
    """hecmw_adapt_new_cell_351 templates: n_pairs==1 -> TYP-1/2/3
    (2 children), n_pairs==3 -> TYP-4 (4 children).  row is the prism's
    global (n01,n02,n03,n11,n12,n13)."""
    n = [int(x) for x in row[:6]]

    def m(a, b):
        return mid.get((min(n[a], n[b]), max(n[a], n[b])))

    if n_pairs == 1:
        if m(0, 1) is not None:                         # TYP-1
            b4, t4 = m(0, 1), m(3, 4)
            return [[n[0], b4, n[2], n[3], t4, n[5]],
                    [b4, n[1], n[2], t4, n[4], n[5]]]
        if m(1, 2) is not None:                         # TYP-2
            b4, t4 = m(1, 2), m(4, 5)
            return [[n[0], b4, n[2], n[3], t4, n[5]],
                    [n[0], n[1], b4, n[3], n[4], t4]]
        b4, t4 = m(2, 0), m(5, 3)                       # TYP-3
        return [[n[0], n[1], b4, n[3], n[4], t4],
                [b4, n[1], n[2], t4, n[4], n[5]]]
    # TYP-4
    b4, b5, b6 = m(0, 1), m(1, 2), m(2, 0)
    t4, t5, t6 = m(3, 4), m(4, 5), m(5, 3)
    return [[n[0], b4, b6, n[3], t4, t6],
            [b4, n[1], b5, t4, n[4], t5],
            [b6, b5, n[2], t6, t5, n[5]],
            [b4, b5, b6, t4, t5, t6]]


def adapt_mesh(mesh: Mesh, marked_eids: Sequence[int]) -> Mesh:
    """Refine the marked tet4/prism6 elements with closure.
    Node/element groups propagate as in uniform refinement.

    Multi-block tet4(+prism6) meshes are supported (closure runs over
    the union so inter-block faces stay conforming; children return to
    their parent's block/section).  Other etypes raise (the reference's
    adaptation covers tet+prism, hecmw_adapt_proc)."""
    if not mesh.blocks or any(bb.etype not in (341, 351)
                              for bb in mesh.blocks):
        raise NotImplementedError("adapt_mesh: tet4/prism6 blocks only")
    rows = []
    for bb in mesh.blocks:
        c = np.asarray(bb.conn, np.int64)
        if c.shape[1] < 6:
            c = np.pad(c, ((0, 0), (0, 6 - c.shape[1])),
                       constant_values=-1)
        rows.append(c)
    conn = np.concatenate(rows)
    is_prism = np.concatenate([
        np.full(len(bb.elem_ids), bb.etype == 351, bool)
        for bb in mesh.blocks])
    row_block = np.concatenate([np.full(len(bb.elem_ids), bi, np.int64)
                                for bi, bb in enumerate(mesh.blocks)])
    all_eids = np.concatenate([np.asarray(bb.elem_ids)
                               for bb in mesh.blocks])
    eid2row = {int(e): i for i, e in enumerate(all_eids)}
    marked_rows = np.asarray([eid2row[int(e)] for e in marked_eids],
                             np.int64)
    red, split = _closure(conn, marked_rows, is_prism)

    coords = [c for c in mesh.coords]
    mid: Dict[Tuple[int, int], int] = {}
    for (u, v) in sorted(split):
        coords.append(0.5 * (mesh.coords[u] + mesh.coords[v]))
        mid[(u, v)] = len(coords) - 1

    conns: List[List[int]] = []
    parent_of: List[int] = []
    for e in range(conn.shape[0]):
        row = conn[e]
        if is_prism[e]:
            ns = sum((_key(row, *lo) in mid) for lo, hi in _PEDGES)
            if ns == 0:
                chs = [list(map(int, row[:6]))]
            else:
                chs = _prism_children(row, mid, ns)
        elif red[e]:
            chs = _red_children(row[:4], mid)
        else:
            pat = _pattern([i for i in range(6) if (
                min(row[_EDGES[i][0]], row[_EDGES[i][1]]),
                max(row[_EDGES[i][0]], row[_EDGES[i][1]])) in mid])
            if pat[0] == "none":
                chs = [list(map(int, row[:4]))]
            elif pat[0] == "red":
                # all 6 edges split by neighbors: full red even though
                # the element was never promoted explicitly
                chs = _red_children(row[:4], mid)
            else:
                chs = _green_children(row[:4], pat, mid)
        for ch in chs:
            conns.append(ch)
            parent_of.append(e)

    conn_new = np.asarray(
        [ch + [-1] * (6 - len(ch)) for ch in conns], np.int64)
    # enforce positive tet orientation (green templates can flip)
    x = np.asarray(coords)
    child_prism = is_prism[np.asarray(parent_of)]
    tsel = np.nonzero(~child_prism)[0]
    tc = conn_new[tsel][:, :4]
    det = np.linalg.det(x[tc[:, 1:]] - x[tc[:, :1]])
    flip = tsel[det < 0]
    conn_new[flip, 1], conn_new[flip, 2] = \
        conn_new[flip, 2].copy(), conn_new[flip, 1].copy()

    E2 = conn_new.shape[0]
    eids = np.arange(1, E2 + 1, dtype=np.int64)
    child_block = row_block[np.asarray(parent_of)]
    blocks = []
    for bi, bb in enumerate(mesh.blocks):
        sel = child_block == bi
        nn = 6 if bb.etype == 351 else 4
        cb = conn_new[sel][:, :nn]
        blocks.append(ElemBlock(bb.etype, eids[sel], cb, cb.copy(),
                                section_id=bb.section_id))
    node_ids = np.arange(1, len(coords) + 1, dtype=np.int64)
    id2idx = {int(i): int(i) - 1 for i in node_ids}

    node_groups = {}
    for name, idx in mesh.node_groups.items():
        mem = np.zeros(len(mesh.coords), bool)
        mem[idx] = True
        out = list(np.nonzero(mem)[0])
        for (u, v), nid in mid.items():
            if mem[u] and mem[v]:
                out.append(nid)
        node_groups[name] = np.asarray(sorted(out), np.int64)

    parent_of_a = np.asarray(parent_of)
    elem_groups = {}
    for name, eids_g in mesh.elem_groups.items():
        rows = {eid2row[int(e)] for e in eids_g if int(e) in eid2row}
        sel = np.isin(parent_of_a, list(rows))
        elem_groups[name] = eids[sel]

    return dataclasses.replace(
        mesh, coords=np.asarray(coords), node_ids=node_ids,
        id2idx=id2idx, blocks=blocks, node_groups=node_groups,
        elem_groups=elem_groups, surf_groups={})


def adapt_by_error(mesh: Mesh, res, fraction: float = 0.3) -> Mesh:
    """One ZZ-marked adaptation pass (mark -> closure -> refine)."""
    eta = zz_error(mesh, res)
    eids = np.concatenate([b.elem_ids for b in mesh.blocks])
    return adapt_mesh(mesh, mark_fraction(eta, eids, fraction))
