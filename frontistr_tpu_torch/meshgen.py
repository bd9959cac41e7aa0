"""Structured mesh generation.

The reference ships meshes for most fixtures but tutorials 01/02/04/15/16/18
omit theirs, and benchmarking needs arbitrary-size meshes (BASELINE.md
"1M DOF").  This generator produces ``Mesh`` objects directly (same dataclass
the .msh reader yields) for box domains in hex8/hex20/tet4/prism6.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from frontistr_tpu_torch.io.meshio import Mesh, Section, MaterialDef, ElemBlock


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
