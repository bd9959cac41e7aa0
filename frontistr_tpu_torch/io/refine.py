"""Uniform mesh refinement (!MESH ... REFINE=n).

The reference refines the mesh at load time through the embedded
REVOCAP_Refiner (hecmw1/src/common/hecmw_dist_refine.c:401-475): each
element splits uniformly (hex8 -> 8 hexes, tet4 -> 8 tets, quad4 -> 4,
tri3 -> 4), node groups propagate to new nodes whose parent nodes all
belong to the group, element groups to all children, and surface groups
to the child faces lying on the parent face.

Host-side numpy, applied once per REFINE level, vectorised over the
elements: every child node of every element is listed by its parent
nodes in the JAX loop's order (``frontistr_tpu/io/refine.py:81-209``:
block, element, child, node), and one stable sort numbers the new nodes
by first occurrence, so the coordinates (the mean of the parents, summed
in the same order), the numbering and the groups are the JAX function's
bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from frontistr_tpu_torch.io.meshio import Mesh, ElemBlock


# child-corner lattice coordinates per etype; lattice index in {0,1,2}^dim
_HEX_CORNERS = [(0, 0, 0), (2, 0, 0), (2, 2, 0), (0, 2, 0),
                (0, 0, 2), (2, 0, 2), (2, 2, 2), (0, 2, 2)]
_QUAD_CORNERS = [(0, 0), (2, 0), (2, 2), (0, 2)]


def _hex_children():
    out = []
    for k in (0, 1):
        for j in (0, 1):
            for i in (0, 1):
                out.append([(i + di, j + dj, k + dk)
                            for (di, dj, dk) in
                            [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                             (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]])
    return out


def _quad_children():
    out = []
    for j in (0, 1):
        for i in (0, 1):
            out.append([(i, j), (i + 1, j), (i + 1, j + 1), (i, j + 1)])
    return out


def _tet_children():
    c = [[i] for i in range(4)]
    e = {(a, b): [a, b] for a in range(4) for b in range(a + 1, 4)}
    return [[c[0], e[(0, 1)], e[(0, 2)], e[(0, 3)]],
            [e[(0, 1)], c[1], e[(1, 2)], e[(1, 3)]],
            [e[(0, 2)], e[(1, 2)], c[2], e[(2, 3)]],
            [e[(0, 3)], e[(1, 3)], e[(2, 3)], c[3]],
            [e[(0, 1)], e[(1, 2)], e[(0, 2)], e[(2, 3)]],
            [e[(0, 1)], e[(1, 2)], e[(2, 3)], e[(1, 3)]],
            [e[(0, 1)], e[(0, 2)], e[(0, 3)], e[(2, 3)]],
            [e[(0, 1)], e[(0, 3)], e[(1, 3)], e[(2, 3)]]]


def _tri_children():
    c = [[i] for i in range(3)]
    e01, e12, e20 = [0, 1], [1, 2], [0, 2]
    return [[c[0], e01, e20], [e01, c[1], e12], [e20, e12, c[2]],
            [e01, e12, e20]]


def _child_parents(etype):
    """The children of one element: a list per child of the local parent
    corner indices of each of its nodes (in the JAX function's order)."""
    if etype in (361, 241, 731, 741):
        lat = _hex_children() if etype == 361 else _quad_children()
        corners = _HEX_CORNERS if etype == 361 else _QUAD_CORNERS
        dimn = len(corners[0])
        return [[[ci for ci, cc in enumerate(corners)
                  if all(abs(cc[d] - p[d]) <= 1 for d in range(dimn))]
                 for p in ch] for ch in lat]
    if etype in (341, 231):
        return _tet_children() if etype == 341 else _tri_children()
    raise NotImplementedError(f"uniform refinement for etype {etype}")


def refine_mesh(mesh: Mesh, levels: int = 1) -> Mesh:
    """``mesh`` split uniformly ``levels`` times (hex8, quad4 and the
    741 shell by the lattice children, tet4 and tri3 into 8 and 4); new
    nodes and elements numbered from 1 in order of first creation."""
    m = mesh
    for _ in range(max(0, int(levels))):
        m = _refine_once(m)
    return m


def _refine_once(mesh: Mesh) -> Mesh:
    """One level: new nodes at the mean of their parents (an edge's two
    ends, a face's four, a hex's eight), appended after the old nodes in
    order of first creation; node groups gain a new node when every
    parent is a member, element groups every child, surface groups the
    child faces on the parent face."""
    n_old = len(mesh.coords)
    # every child node of every element, in the traversal order of the
    # JAX loop (block, element, child, node): its parents (-1 padded,
    # the element's corner order)
    kids = [_child_parents(b.etype) for b in mesh.blocks]
    width = max(len(ps) for ch in kids for c in ch for ps in c)
    slots, shapes = [], []
    for b, ch in zip(mesh.blocks, kids):
        lat = np.full((len(ch), len(ch[0]), width), -1, np.int64)
        for c, nodes in enumerate(ch):
            for k, ps in enumerate(nodes):
                lat[c, k, :len(ps)] = ps
        conn = np.asarray(b.conn, np.int64)
        par = np.where(lat[None] >= 0, conn[:, np.maximum(lat, 0)], -1)
        slots.append(par.reshape(-1, width))
        shapes.append(par.shape[:3])
    par = np.concatenate(slots)                     # (S, width)
    multi = par[:, 1] >= 0                          # more than one parent
    # the distinct keys in order of first occurrence (a stable sort keeps
    # the first slot of each key in front)
    mslots = np.flatnonzero(multi)
    kk = np.sort(np.where(par[mslots] >= 0, par[mslots],
                          np.iinfo(np.int64).max), axis=1)
    srt = np.lexsort(kk.T[::-1])
    ks = kk[srt]
    head = np.ones(len(ks), bool)
    head[1:] = (ks[1:] != ks[:-1]).any(axis=1)
    group = np.cumsum(head) - 1                     # key of each sorted slot
    first = srt[head]                               # its first slot
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    node = par[:, 0].copy()
    node[mslots[srt]] = n_old + rank[group]
    creator = mslots[np.sort(first)]                # the slot that made it
    cpar = par[creator]
    coords_new = np.empty((len(first),) + mesh.coords.shape[1:])
    two = (cpar >= 0).sum(1) == 2
    c = np.asarray(mesh.coords)
    coords_new[two] = np.stack([c[cpar[two, 0]], c[cpar[two, 1]]]).mean(0)
    # a face or hex centre: the JAX loop sums the parents in the order of
    # the frozenset it built from the creating element's corners
    for i in np.flatnonzero(~two):
        ps = [int(v) for v in cpar[i] if v >= 0]
        coords_new[i] = np.stack([c[j] for j in frozenset(ps)]).mean(0)
    coords_a = np.concatenate([c, coords_new])

    blocks: List[ElemBlock] = []
    next_eid, pos = 1, 0
    for b, (E, nc, npc) in zip(mesh.blocks, shapes):
        conn = node[pos:pos + E * nc * npc].reshape(E * nc, npc)
        pos += E * nc * npc
        eid = np.arange(next_eid, next_eid + E * nc, dtype=np.int64)
        next_eid = int(eid[-1]) + 1
        blocks.append(ElemBlock(b.etype, eid, conn, conn.copy(),
                                section_id=b.section_id))
    # parent id -> its first child's id and its number of children
    pids = np.concatenate([np.asarray(b.elem_ids, np.int64)
                           for b in mesh.blocks])
    first_kid = np.concatenate([cb.elem_ids[::nc] for cb, (_, nc, _)
                                in zip(blocks, shapes)])
    n_kids = np.concatenate([np.full(E, nc, np.int64)
                             for (E, nc, _) in shapes])
    by_id = np.argsort(pids, kind="stable")
    node_ids = np.arange(1, len(coords_a) + 1)
    id2idx = {int(i): int(i) - 1 for i in node_ids}

    # node groups: a new node joins iff all its parents are members
    node_groups = {}
    for name, idx in mesh.node_groups.items():
        mem = np.zeros(n_old + 1, bool)
        mem[idx] = True
        inside = np.where(cpar >= 0, mem[np.where(cpar >= 0, cpar, n_old)],
                          True).all(1)
        out = np.concatenate([np.nonzero(mem[:n_old])[0],
                              n_old + np.flatnonzero(inside)])
        node_groups[name] = np.sort(out).astype(np.int64)

    elem_groups = {}
    for name, eids_g in mesh.elem_groups.items():
        g = np.asarray(eids_g, np.int64).reshape(-1)
        at = np.minimum(np.searchsorted(pids[by_id], g), len(pids) - 1)
        hit = by_id[at[pids[by_id][at] == g]]           # ids of no block
        cnt = n_kids[hit]                               # are skipped
        off = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        elem_groups[name] = np.sort(np.repeat(first_kid[hit], cnt) + off)

    # surface groups: child faces whose corners' parent sets lie within
    # the parent face's node set
    from frontistr_tpu_torch.assembly.loads import FACE_TABLES
    eid2loc_old = mesh.elem_id_to_block()
    surf_groups = {}
    # parents of every node, -1 padded: an old node is its own parent
    allpar = np.concatenate([
        np.concatenate([np.arange(n_old)[:, None],
                        np.full((n_old, width - 1), -1, np.int64)], 1), cpar])
    for name, pairs in mesh.surf_groups.items():
        pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
        loc = np.asarray([eid2loc_old[int(e)] for e in pairs[:, 0]],
                         np.int64).reshape(-1, 2)
        out = [np.zeros((0, 2), np.int64)] * len(pairs)
        for bi in np.unique(loc[:, 0]):
            ob, cb = mesh.blocks[bi], blocks[bi]
            ftab = FACE_TABLES.get(ob.etype)
            if ftab is None:
                continue
            sel = np.flatnonzero(loc[:, 0] == bi)
            k = loc[sel, 1]
            pset = np.full((len(sel), 4), -2, np.int64)
            for j, f in enumerate(pairs[sel, 1]):
                ln = ftab[int(f) - 1][1]
                pset[j, :len(ln)] = np.asarray(ob.conn)[k[j], ln]
            nc = shapes[bi][1]
            ck = k[:, None] * nc + np.arange(nc)            # (P, nc)
            ok = np.zeros((len(sel), nc, len(ftab)), bool)
            for cf, (_, cl) in enumerate(ftab):
                pars = allpar[cb.conn[ck][:, :, cl]]    # (P, nc, l, width)
                inside = (pars[..., None] ==
                          pset[:, None, None, None, :]).any(-1) | (pars < 0)
                ok[:, :, cf] = inside.all(axis=(2, 3))
            for j, p in enumerate(sel):
                c, f = np.nonzero(ok[j])
                out[p] = np.stack([cb.elem_ids[ck[j, c]], f + 1], axis=1)
        surf_groups[name] = np.concatenate(out).astype(np.int64).reshape(
            -1, 2) if len(out) else np.zeros((0, 2), np.int64)

    return dataclasses.replace(
        mesh, coords=coords_a, node_ids=node_ids, id2idx=id2idx,
        blocks=blocks, node_groups=node_groups, elem_groups=elem_groups,
        surf_groups=surf_groups)
