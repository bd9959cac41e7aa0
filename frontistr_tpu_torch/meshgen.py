"""Structured mesh generation.

The reference ships meshes for most fixtures but tutorials 01/02/04/15/16/18
omit theirs, and benchmarking needs arbitrary-size meshes (BASELINE.md
"1M DOF").  This generator produces ``Mesh`` objects directly (same dataclass
the .msh reader yields) for box domains in hex8 and tet4, plane boxes
of quad4 or tri3 (the 2-D heat decks), two hex8 cubes joined by 541
gap elements (the heat interface decks), two boxes in node-to-surface
contact (``contact_pair``, the contact decks), flat plates of MITC3,
MITC4 or MITC9 shells (``plate_shell``), straight 611 and 641 beams
(``beam_line``) and solid-shell strips (``solid_shell_strip``), the
shell and beam decks.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from frontistr_tpu_torch.io.meshio import (ContactPairDef, ElemBlock,
                                           MaterialDef, Mesh, Section)
from frontistr_tpu_torch.elements.tables import HECMW2FSTR_ORDER


def box_hex8(nx: int, ny: int, nz: int,
             lx: float = 1.0, ly: float = 1.0, lz: float = 1.0,
             youngs: float = 210e3, poisson: float = 0.3,
             density: float = 7.85e-6, etype: int = 361) -> Mesh:
    """Structured box of nx*ny*nz hex8 elements with face node groups
    (X0/X1/Y0/Y1/Z0/Z1) — the canonical bench/workload mesh."""
    assert etype == 361
    xs = np.linspace(0, lx, nx + 1)
    ys = np.linspace(0, ly, ny + 1)
    zs = np.linspace(0, lz, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    n_node = coords.shape[0]

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    I, J, K = I.ravel(), J.ravel(), K.ravel()
    # hex8 FSTR node ordering: bottom quad CCW then top (hex8n.f90)
    conn = np.stack([
        nid(I, J, K), nid(I + 1, J, K), nid(I + 1, J + 1, K),
        nid(I, J + 1, K),
        nid(I, J, K + 1), nid(I + 1, J, K + 1), nid(I + 1, J + 1, K + 1),
        nid(I, J + 1, K + 1),
    ], axis=1).astype(np.int32)
    E = conn.shape[0]
    elem_ids = np.arange(1, E + 1, dtype=np.int64)
    node_ids = np.arange(1, n_node + 1, dtype=np.int64)
    id2idx = {int(g): int(g) - 1 for g in node_ids}

    idx = np.arange(n_node).reshape(nx + 1, ny + 1, nz + 1)
    groups: Dict[str, np.ndarray] = {
        "ALL": np.arange(n_node, dtype=np.int64),
        "X0": idx[0].ravel().astype(np.int64),
        "X1": idx[-1].ravel().astype(np.int64),
        "Y0": idx[:, 0].ravel().astype(np.int64),
        "Y1": idx[:, -1].ravel().astype(np.int64),
        "Z0": idx[:, :, 0].ravel().astype(np.int64),
        "Z1": idx[:, :, -1].ravel().astype(np.int64),
    }
    mat = MaterialDef("M1", {1: [[youngs, poisson]], 2: [[density]]})
    structured = (nx, ny, nz)
    block = ElemBlock(etype, elem_ids, conn, conn, 0)
    return Mesh(
        header="generated box", coords=coords, node_ids=node_ids,
        id2idx=id2idx, blocks=[block],
        sections=[Section("SOLID", "ALL", "M1", [1.0])],
        materials={"M1": mat}, node_groups=groups,
        elem_groups={"ALL": elem_ids}, surf_groups={}, amplitudes={},
        equations=[], contact_pairs=[], initial_conditions={},
        structured=structured)


def box_tet4(nx: int, ny: int, nz: int, **kw) -> Mesh:
    """Box meshed with 6 tets per hex cell."""
    m = box_hex8(nx, ny, nz, **{k: v for k, v in kw.items()})
    hx = m.blocks[0].conn
    # Kuhn/Freudenthal 6-tet split around the 0-6 main diagonal: every
    # cube face gets the diagonal through its 0-nearest/6-nearest
    # corners, so diagonals MATCH across neighboring cubes (the mesh is
    # face-conforming, which adaptation's red/green closure relies on)
    t = []
    for tet in ([0, 1, 2, 6], [0, 2, 3, 6], [0, 1, 6, 5],
                [0, 4, 5, 6], [0, 4, 6, 7], [0, 3, 7, 6]):
        t.append(hx[:, tet])
    conn = np.concatenate(t, axis=0).astype(np.int32)
    E = conn.shape[0]
    block = ElemBlock(341, np.arange(1, E + 1, dtype=np.int64), conn, conn, 0)
    m.blocks = [block]
    m.elem_groups = {"ALL": block.elem_ids}
    m.structured = None          # tets take no stencil fast path
    return m


def box_plane(nx: int, ny: int, lx: float = 1.0, ly: float = 1.0,
              etype: int = 241, thick: float = 0.5, opt: int = 0) -> Mesh:
    """Plane box of nx*ny quad4 (241) elements in the x-y plane, or
    2*nx*ny tri3 (231), each quad split along its 0-2 diagonal; the
    quadratic 242 (quad8) and 232 (tri6) carry a node at the middle of
    every edge, shared by the elements around it.  A section of
    thickness ``thick`` and sect_opt ``opt`` (0 plane stress, 1 plane
    strain, 2 axisymmetric) and the node groups X0/X1/Y0/Y1/ALL."""
    assert etype in (231, 232, 241, 242)
    xs, ys = np.linspace(0, lx, nx + 1), np.linspace(0, ly, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), np.zeros(X.size)], axis=1)
    I, J = (a.ravel() for a in np.meshgrid(np.arange(nx), np.arange(ny),
                                           indexing="ij"))
    q = np.stack([I * (ny + 1) + J, (I + 1) * (ny + 1) + J,
                  (I + 1) * (ny + 1) + J + 1, I * (ny + 1) + J + 1], axis=1)
    conn = (np.concatenate([q[:, [0, 1, 2]], q[:, [0, 2, 3]]])
            if etype in (231, 232) else q).astype(np.int64)
    if etype in (232, 242):
        # the mid-edge nodes, FSTR order: edges (0,1), (1,2), (2,0) of a
        # triangle, (0,1), (1,2), (2,3), (3,0) of a quad
        nc = conn.shape[1]
        edges = np.stack([np.sort(conn[:, [k, (k + 1) % nc]], axis=1)
                          for k in range(nc)], 1)
        uniq, inv = np.unique(edges.reshape(-1, 2), axis=0,
                              return_inverse=True)
        conn = np.concatenate([conn, len(coords) + inv.reshape(-1, nc)], 1)
        coords = np.concatenate([coords, coords[uniq].mean(axis=1)])
    conn = conn.astype(np.int32)
    hecmw = conn.copy()          # the .msh order: fstr[k] = hecmw[T[k]-1]
    if etype in HECMW2FSTR_ORDER:
        hecmw[:, np.asarray(HECMW2FSTR_ORDER[etype]) - 1] = conn
    n_node = coords.shape[0]
    elem_ids = np.arange(1, len(conn) + 1, dtype=np.int64)
    node_ids = np.arange(1, n_node + 1, dtype=np.int64)
    groups = {"ALL": np.arange(n_node, dtype=np.int64)}
    for g, ax, x in (("X0", 0, 0.0), ("X1", 0, lx), ("Y0", 1, 0.0),
                     ("Y1", 1, ly)):
        groups[g] = np.flatnonzero(np.isclose(coords[:, ax], x)) \
            .astype(np.int64)
    return Mesh(
        header="generated plane box", coords=coords, node_ids=node_ids,
        id2idx={int(g): int(g) - 1 for g in node_ids},
        blocks=[ElemBlock(etype, elem_ids, conn, hecmw, 0)],
        sections=[Section("SOLID", "ALL", "M1", [thick], opt=opt)],
        materials={"M1": MaterialDef("M1", {})}, node_groups=groups,
        elem_groups={"ALL": elem_ids}, surf_groups={}, amplitudes={},
        equations=[], contact_pairs=[], initial_conditions={})


def plate_shell(nx: int, ny: Optional[int] = None, etype: int = 741,
                a: float = 1.0, b: Optional[float] = None,
                thick: float = 0.01, youngs: float = 210e3,
                poisson: float = 0.3, density: float = 7.85e-9,
                warp: float = 0.0, seed: int = 4) -> Mesh:
    """Flat plate of shells in the z = 0 plane over [0, a] x [0, b]:
    nx*ny MITC4 quads (741), 2*nx*ny MITC3 triangles (731, each quad
    split along its 0-2 diagonal) or nx*ny MITC9 quads (743, on a
    (2nx+1) x (2ny+1) node grid), all numbered counter-clockwise seen
    from +z.  A SHELL section of thickness ``thick``, the material M1
    (E, nu, rho), the node groups X0/X1/Y0/Y1, EDGE (the four edges) and
    ALL, and the element group ALL.  ``warp`` > 0 moves every node by up
    to ``warp`` times an element's width in each direction (numpy
    ``default_rng(seed)``), the edge nodes along their edges only:
    distorted, warped elements."""
    assert etype in (731, 741, 743)
    ny = nx if ny is None else ny
    b = a if b is None else b
    k = 2 if etype == 743 else 1       # grid points an element edge
    mx, my = k * nx + 1, k * ny + 1
    X, Y = np.meshgrid(np.linspace(0, a, mx), np.linspace(0, b, my),
                       indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), np.zeros(X.size)], axis=1)
    I, J = (v.ravel() * k for v in np.meshgrid(np.arange(nx), np.arange(ny),
                                               indexing="ij"))

    def nid(i, j):
        return i * my + j
    if etype == 743:
        # corners, edge midpoints (0,-),(+,0),(0,+),(-,0), centre
        conn = np.stack([nid(I, J), nid(I + 2, J), nid(I + 2, J + 2),
                         nid(I, J + 2), nid(I + 1, J), nid(I + 2, J + 1),
                         nid(I + 1, J + 2), nid(I, J + 1),
                         nid(I + 1, J + 1)], axis=1)
    else:
        conn = np.stack([nid(I, J), nid(I + 1, J), nid(I + 1, J + 1),
                         nid(I, J + 1)], axis=1)
        if etype == 731:
            conn = np.concatenate([conn[:, [0, 1, 2]], conn[:, [0, 2, 3]]])
    conn = conn.astype(np.int32)
    n_node = coords.shape[0]
    elem_ids = np.arange(1, len(conn) + 1, dtype=np.int64)
    node_ids = np.arange(1, n_node + 1, dtype=np.int64)
    groups = {"ALL": np.arange(n_node, dtype=np.int64)}
    for g, ax, x in (("X0", 0, 0.0), ("X1", 0, a), ("Y0", 1, 0.0),
                     ("Y1", 1, b)):
        groups[g] = np.flatnonzero(np.isclose(coords[:, ax], x)) \
            .astype(np.int64)
    groups["EDGE"] = np.unique(np.concatenate(
        [groups[g] for g in ("X0", "X1", "Y0", "Y1")]))
    if warp > 0.0:
        h = min(a / nx, b / ny)
        d = np.random.default_rng(seed).uniform(-warp * h, warp * h,
                                                (n_node, 3))
        for g, ax in (("X0", 0), ("X1", 0), ("Y0", 1), ("Y1", 1)):
            d[groups[g], ax] = 0.0
        coords = coords + d
    return Mesh(
        header="generated shell plate", coords=coords, node_ids=node_ids,
        id2idx={int(g): int(g) - 1 for g in node_ids},
        blocks=[ElemBlock(etype, elem_ids, conn, conn, 0)],
        sections=[Section("SHELL", "ALL", "M1", [thick, 3.0])],
        materials={"M1": MaterialDef("M1", {1: [[youngs, poisson]],
                                            2: [[density]]})},
        node_groups=groups, elem_groups={"ALL": elem_ids}, surf_groups={},
        amplitudes={}, equations=[], contact_pairs=[],
        initial_conditions={})


def _single_block(coords, etype, conn, section: Section, items: dict,
                  groups: dict, header: str) -> Mesh:
    conn = np.asarray(conn, np.int32)
    eids = np.arange(1, len(conn) + 1, dtype=np.int64)
    nids = np.arange(1, len(coords) + 1, dtype=np.int64)
    return Mesh(
        header=header, coords=np.asarray(coords, np.float64), node_ids=nids,
        id2idx={int(g): int(g) - 1 for g in nids},
        blocks=[ElemBlock(etype, eids, conn, conn, 0)], sections=[section],
        materials={"M1": MaterialDef("M1", items)},
        node_groups={k: np.asarray(v, np.int64) for k, v in groups.items()},
        elem_groups={"ALL": eids}, surf_groups={}, amplitudes={},
        equations=[], contact_pairs=[], initial_conditions={})


def beam_line(etype: int = 611, ne: int = 4, length: float = 10.0,
              section=(0.0, 0.0, 1.0, 1.0, 2.0, 2.0, 1.0),
              elastic=(1000.0, 0.3), density: float = 1.0) -> Mesh:
    """A straight beam along x of ``ne`` elements: 611 (two 6-dof nodes
    an element) or 641 (the ne + 1 line nodes, then their rotation
    carriers at the same places; element i is (i, i+1, carrier i,
    carrier i+1)).  The BEAM section's seven values (reference vector,
    area, Iyy, Izz, Jx); ``elastic`` the material's ELASTIC row (E, nu,
    and for 641 optionally the fiber radius and six angles).  Node
    groups FIX (x = 0, its carrier too), TIP (the line node at x =
    length) and ALL."""
    assert etype in (611, 641)
    xs = np.linspace(0.0, length, ne + 1)
    line = np.stack([xs, 0 * xs, 0 * xs], 1)
    if etype == 611:
        coords, conn, fix = line, [[i, i + 1] for i in range(ne)], [0]
    else:
        coords = np.concatenate([line, line])
        conn = [[i, i + 1, ne + 1 + i, ne + 2 + i] for i in range(ne)]
        fix = [0, ne + 1]
    return _single_block(coords, etype, conn,
                         Section("BEAM", "ALL", "M1", list(section)),
                         {1: [list(elastic)], 2: [[density]]},
                         {"FIX": fix, "TIP": [ne],
                          "ALL": np.arange(len(coords))},
                         "generated beam")


def solid_shell_strip(etype: int = 781, nx: int = 4, thick: float = 0.1,
                      youngs: float = 1.0e6, poisson: float = 0.0,
                      density: float = 1.0) -> Mesh:
    """A cantilever strip of nx solid-shells (781: quads, 761: one
    triangle a cell) over 2 x 0.25: each element's lower-face nodes,
    then its upper-face twins at the same places (the rotation
    carriers).  A SHELL section of thickness ``thick``; node groups FIX
    (the x = 0 nodes, upper and lower; for 761 also the next row), TIP
    (the free end's lower nodes) and ALL."""
    assert etype in (761, 781)
    nid, coords = {}, []
    for up in (0, 1):
        for i in range(nx + 1):
            for j in range(2):
                nid[(i, j, up)] = len(coords)
                coords.append((i * 2.0 / nx, j * 0.25, 0.0))
    conn = []
    for i in range(nx):
        ring = [(i, 0), (i + 1, 0), (i + 1, 1), (i, 1)][
            :4 if etype == 781 else 3]
        conn.append([nid[p + (0,)] for p in ring] +
                    [nid[p + (1,)] for p in ring])
    fix = [nid[(i, j, z)] for i in range(1 if etype == 781 else 2)
           for j in range(2) for z in (0, 1)]
    return _single_block(coords, etype, conn,
                         Section("SHELL", "ALL", "M1", [thick, 3.0]),
                         {1: [[youngs, poisson]], 2: [[density]]},
                         {"FIX": fix,
                          "TIP": [nid[(nx, 0, 0)], nid[(nx, 1, 0)]],
                          "ALL": np.arange(len(coords))},
                         "generated solid-shell strip")


def hex8_pair_541(n: int, gap_section=(0.05, 2.0, 5.67e-11, 5.67e-11)
                  ) -> Mesh:
    """Two ``box_hex8(n, n, n)`` unit cubes side by side along x (the
    right one on [1, 2]), the nodes of their touching faces apart and
    joined by n*n 541 gap elements: nodes 1-4 a face of the left cube,
    5-8 the matching nodes of the right one.  Element groups SOLID (both
    cubes, section 1) and GAP (section 2, ``!SECTION, TYPE=INTERFACE``
    with ``gap_section`` = thickness, conductance, rr1, rr2); node groups
    X0 (x = 0), X1 (x = 2) and ALL."""
    a = box_hex8(n, n, n)
    na = a.n_node
    coords = np.concatenate([a.coords, a.coords + [1.0, 0.0, 0.0]])
    ca = a.blocks[0].conn.astype(np.int64)
    face = [1, 2, 6, 5]                 # the +x face of an FSTR hex8
    left = ca[np.isclose(a.coords[ca[:, face], 0], 1.0).all(axis=1)][:, face]
    # the right cube's node at a left node's (y, z) is the node at x = 0
    # with the same grid index: box_hex8 numbers x slowest
    right = left - n * (n + 1) ** 2 + na
    gap = np.concatenate([left, right], axis=1).astype(np.int32)
    E = len(ca)
    ids = [np.arange(1, E + 1), np.arange(E + 1, 2 * E + 1),
           np.arange(2 * E + 1, 2 * E + 1 + len(gap))]
    nn = len(coords)
    x = coords[:, 0]
    node_ids = np.arange(1, nn + 1, dtype=np.int64)
    return Mesh(
        header="generated 541 pair", coords=coords, node_ids=node_ids,
        id2idx={int(g): int(g) - 1 for g in node_ids},
        blocks=[ElemBlock(361, ids[0], ca.astype(np.int32),
                          ca.astype(np.int32), 0),
                ElemBlock(361, ids[1], (ca + na).astype(np.int32),
                          (ca + na).astype(np.int32), 0),
                ElemBlock(541, ids[2], gap, gap, 1)],
        sections=[Section("SOLID", "SOLID", "M1", [1.0]),
                  Section("INTERFACE", "GAP", "M1", list(gap_section))],
        materials={"M1": MaterialDef("M1", {})},
        node_groups={"ALL": np.arange(nn, dtype=np.int64),
                     "X0": np.flatnonzero(np.isclose(x, 0.0)),
                     "X1": np.flatnonzero(np.isclose(x, 2.0))},
        elem_groups={"SOLID": np.concatenate(ids[:2]), "GAP": ids[2]},
        surf_groups={}, amplitudes={}, equations=[], contact_pairs=[],
        initial_conditions={})


def contact_pair(lower: Tuple[int, ...], upper: Tuple[int, ...],
                 lower_size: Tuple[float, ...], upper_size: Tuple[float, ...],
                 gap: float = 0.0, etype: int = 361) -> Mesh:
    """Two boxes in node-to-surface contact: the lower (master) box of
    ``lower`` = (nx, ny, nz) hex8 elements over ``lower_size`` = (lx,
    ly, lz) from the origin, the upper (slave) box of ``upper`` elements
    over ``upper_size`` standing on it (its bottom at z = lz + ``gap``),
    both in one block; ``etype`` 241 makes them plane quad4 boxes (nx,
    ny) in the x-y plane, the upper one above y = ly.  Node groups ALL,
    BOT (the lower box's bottom), TOP (the upper box's top), SLAVE (its
    bottom), X0, Y0 (both boxes; 3-D) and LOW (the lower box); surface
    group MAST (the lower box's top faces); contact pair CP1 = (SLAVE,
    MAST).  Where the two meshes do not match, no slave sits on a face
    edge inside the master surface."""
    if etype == 361:
        make = box_hex8
        up_axis = 2
    elif etype == 241:
        def make(nx, ny, lx=1.0, ly=1.0):
            m = box_plane(nx, ny, lx=lx, ly=ly, etype=241, thick=1.0, opt=1)
            m.materials["M1"] = MaterialDef("M1", {1: [[210e3, 0.3]],
                                                   2: [[7.85e-6]]})
            return m
        up_axis = 1
    else:
        raise ValueError(f"contact_pair: element type {etype}")
    dim = len(lower)
    keys = ("lx", "ly", "lz")[:dim]
    lo = make(*lower, **dict(zip(keys, lower_size)))
    hi = make(*upper, **dict(zip(keys, upper_size)))
    shift = np.zeros(3)
    shift[up_axis] = lower_size[up_axis] + gap
    coords = np.concatenate([lo.coords, hi.coords + shift])
    n_lo = lo.n_node
    cl = lo.blocks[0].conn.astype(np.int64)
    conn = np.concatenate([cl, hi.blocks[0].conn + n_lo]).astype(np.int32)
    hecmw = np.concatenate([lo.blocks[0].conn_hecmw,
                            hi.blocks[0].conn_hecmw + n_lo]).astype(np.int32)
    E = len(conn)
    elem_ids = np.arange(1, E + 1, dtype=np.int64)
    nn = len(coords)
    node_ids = np.arange(1, nn + 1, dtype=np.int64)
    idx = np.arange(nn, dtype=np.int64)
    h = coords[:, up_axis]
    top_lo = lower_size[up_axis]
    groups = {"ALL": idx, "LOW": idx[:n_lo],
              "BOT": idx[:n_lo][np.isclose(h[:n_lo], 0.0)],
              "TOP": idx[n_lo:][np.isclose(h[n_lo:], top_lo + gap +
                                           upper_size[up_axis])],
              "SLAVE": idx[n_lo:][np.isclose(h[n_lo:], top_lo + gap)]}
    for g, ax in (("X0", 0), ("Y0", 1))[:dim - 1]:
        groups[g] = idx[np.isclose(coords[:, ax], 0.0)]
    # the master surface: the lower box's faces whose corners all lie on
    # its top
    from frontistr_tpu_torch.assembly.loads import FACE_TABLES
    on_top = np.isclose(h, top_lo)
    on_top[n_lo:] = False
    rows = []
    for f, (_, ln) in enumerate(FACE_TABLES[etype], start=1):
        hit = on_top[cl[:, ln[:4]]].all(axis=1)
        rows.extend((int(e), f) for e in elem_ids[:len(cl)][hit])
    return Mesh(
        header="generated contact pair", coords=coords, node_ids=node_ids,
        id2idx={int(g): int(g) - 1 for g in node_ids},
        blocks=[ElemBlock(etype, elem_ids, conn, hecmw, 0)],
        sections=[Section("SOLID", "ALL", "M1", lo.sections[0].values,
                          opt=lo.sections[0].opt)],
        materials={"M1": lo.materials["M1"]}, node_groups=groups,
        elem_groups={"ALL": elem_ids},
        surf_groups={"MAST": np.asarray(sorted(rows), np.int64)},
        amplitudes={}, equations=[],
        contact_pairs=[ContactPairDef("CP1", "NODE-SURF", "SLAVE", "MAST")],
        initial_conditions={})
