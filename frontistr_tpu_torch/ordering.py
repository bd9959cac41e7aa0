"""Production node reordering (RCM) for the TPU fast paths.

The cluster-ELL operator (assembly/bell.py) clusters nodes as ``n // G``
and the AMG aggregates (solver/amg.py) are chunks of consecutive nodes —
both assume band-ordered numbering.  Generated box meshes are naturally
banded, but FEMAP/Abaqus-numbered production meshes are not: a wild
numbering blows up the cluster width Wc (memory + matvec time) and
degrades AMG aggregates to spatial noise.

This module is the TPU equivalent of the reference's matrix orderings
(hecmw1/src/solver/matrix/hecmw_matrix_ordering_CM.f90 — (reverse)
Cuthill-McKee): permute the node axis of the whole ``Mesh`` ONCE right
after reading, so every downstream consumer (model build, cluster-ELL,
AMG, heat/eigen/dynamic drivers) sees banded numbering.  All file output
is keyed by ``mesh.node_ids``, which travels with the permutation, so
emitted logs/results stay labeled with the original ids.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np


def _adjacency(conns: Sequence[np.ndarray], n_node: int):
    """Symmetric node-adjacency CSR from element connectivity."""
    from scipy.sparse import coo_matrix
    rows_l, cols_l = [], []
    for c in conns:
        if c.size == 0:
            continue
        E, nn = c.shape
        ct = np.asarray(c, dtype=np.int64).T
        rows_l.append(np.repeat(ct[:, None, :], nn, axis=1).reshape(-1))
        cols_l.append(np.broadcast_to(ct[None, :, :],
                                      (nn, nn, E)).reshape(-1))
    if not rows_l:
        return None
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    A = coo_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                   shape=(n_node, n_node)).tocsr()
    A.sum_duplicates()
    return A


def bandwidth(conns: Sequence[np.ndarray], n_node: int,
              order: Optional[np.ndarray] = None) -> int:
    """Max |i - j| over element node pairs (the cluster-width driver)."""
    bw = 0
    inv = None
    if order is not None:
        inv = np.empty(n_node, np.int64)
        inv[order] = np.arange(n_node)
    for c in conns:
        if c.size == 0:
            continue
        cc = inv[np.asarray(c, np.int64)] if inv is not None else c
        bw = max(bw, int((cc.max(axis=1) - cc.min(axis=1)).max()))
    return bw


def rcm_order(conns: Sequence[np.ndarray], n_node: int) -> np.ndarray:
    """Reverse Cuthill-McKee ordering: returns ``order`` with
    ``order[new] = old`` (scipy convention: A[order][:, order] banded)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    A = _adjacency(conns, n_node)
    if A is None:
        return np.arange(n_node, dtype=np.int64)
    return np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True),
                      dtype=np.int64)


def _median_edge(coords: np.ndarray, conns: Sequence[np.ndarray]) -> float:
    """Median first-edge length over (a sample of) elements."""
    ls = []
    for c in conns:
        if c.size == 0 or c.shape[1] < 2:
            continue
        cc = c[:: max(1, c.shape[0] // 50000)]
        d = coords[cc[:, 1]] - coords[cc[:, 0]]
        ls.append(np.linalg.norm(d, axis=1))
    if not ls:
        return 1.0
    m = float(np.median(np.concatenate(ls)))
    return m if m > 0 else 1.0


def band_order(coords: np.ndarray, conns: Sequence[np.ndarray]) -> np.ndarray:
    """Geometric column ordering: bucket nodes into edge-length-wide
    columns along the two longest bounding-box axes and sort each column
    by the third coordinate.  Consecutive nodes form spatial columns, so
    G-node clusters see only the ~9 neighboring columns — on grids this
    reproduces the lexicographic numbering cluster-ELL likes best (often
    tighter than RCM, whose level sets fatten the max cluster width)."""
    c = np.asarray(coords, float)
    ext = c.max(axis=0) - c.min(axis=0)
    ax = np.argsort(ext)[::-1]               # longest first
    h = _median_edge(c, conns)
    q0 = np.round((c[:, ax[0]] - c[:, ax[0]].min()) / h).astype(np.int64)
    q1 = np.round((c[:, ax[1]] - c[:, ax[1]].min()) / h).astype(np.int64)
    third = c[:, ax[2]] if c.shape[1] > 2 else np.zeros(len(c))
    return np.lexsort((third, q1, q0)).astype(np.int64)


def cluster_width(conns: Sequence[np.ndarray], n_node: int,
                  order: Optional[np.ndarray] = None, G: int = 8) -> int:
    """Wc of the cluster-ELL profile under ``order`` — the quantity that
    sets matvec bytes and HBM footprint (bell.py), without building the
    full profile."""
    C = (n_node + G - 1) // G
    inv = None
    if order is not None:
        inv = np.empty(n_node, np.int64)
        inv[order] = np.arange(n_node)
    keys = []
    for c in conns:
        if c.size == 0:
            continue
        cc = np.asarray(c, np.int64)
        if inv is not None:
            cc = inv[cc]
        g = cc // G
        nn = g.shape[1]
        r = np.repeat(g.T[:, None, :], nn, axis=1).reshape(-1)
        q = np.broadcast_to(g.T[None, :, :], (nn, nn, g.shape[0])) \
            .reshape(-1)
        keys.append(r * C + q)
    if not keys:
        return 1
    uniq = np.unique(np.concatenate(keys))
    cnt = np.bincount(uniq // C, minlength=C)
    return max(int(cnt.max()), 1)


def permute_mesh(mesh, order: np.ndarray):
    """New ``Mesh`` with the node axis permuted by ``order`` (new->old).

    Element ids/order are untouched; only node indices inside conn,
    groups, equations, and initial conditions are remapped.  node_ids
    travel with the permutation, so id-keyed I/O stays correct.
    """
    from frontistr_tpu_torch.io.meshio import Mesh, ElemBlock, Equation
    n = mesh.n_node
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    blocks = [ElemBlock(b.etype, b.elem_ids,
                        inv[np.asarray(b.conn, np.int64)].astype(np.int32),
                        inv[np.asarray(b.conn_hecmw,
                                       np.int64)].astype(np.int32),
                        b.section_id)
              for b in mesh.blocks]
    node_ids = np.asarray(mesh.node_ids)[order]
    ngroups = {g: np.sort(inv[np.asarray(v, np.int64)])
               for g, v in mesh.node_groups.items()}
    equations = [Equation(inv[np.asarray(e.nodes, np.int64)], e.dofs,
                          e.coefs, e.const)
                 for e in mesh.equations]
    init_c = {}
    for typ, arr in mesh.initial_conditions.items():
        a2 = np.asarray(arr, float).copy()
        if a2.ndim == 2 and a2.shape[1] >= 2:
            ok = a2[:, 0] >= 0
            a2[ok, 0] = inv[a2[ok, 0].astype(np.int64)]
        init_c[typ] = a2
    out = Mesh(mesh.header, np.asarray(mesh.coords)[order], node_ids,
               {int(g): k for k, g in enumerate(node_ids)}, blocks,
               mesh.sections, mesh.materials, ngroups, mesh.elem_groups,
               mesh.surf_groups, mesh.amplitudes, equations,
               mesh.contact_pairs, init_c, mesh.zero_temp,
               structured=None)
    out.node_perm = order                 # new -> old (for diagnostics)
    return out


def maybe_reorder(mesh, min_nodes: int = 2048, verbose: bool = True):
    """Auto-RCM: reorder unless disabled, structured, tiny, or already
    near-optimally banded.

    ``FRONTISTR_TPU_REORDER=0`` disables; ``=1`` forces (any size).
    Returns the (possibly reordered) mesh.
    """
    env = os.environ.get("FRONTISTR_TPU_REORDER", "auto").lower()
    if env in ("0", "off", "no", "false"):
        return mesh
    force = env in ("1", "on", "yes", "force")
    if getattr(mesh, "structured", None) is not None and not force:
        return mesh                       # lexicographic box: keep stencil
    if mesh.n_node < min_nodes and not force:
        return mesh
    conns = [b.conn for b in mesh.blocks]
    wc0 = cluster_width(conns, mesh.n_node)
    cands = {"rcm": rcm_order(conns, mesh.n_node),
             "geom": band_order(mesh.coords, conns)}
    best, order, wc_best = None, None, wc0
    for name, o in cands.items():
        wc = cluster_width(conns, mesh.n_node, o)
        if wc < 0.95 * wc_best:           # identity wins ties: file order
            best, order, wc_best = name, o, wc
    if best is None:
        return mesh                       # already banded: keep file order
    if verbose:
        print(f"### node reordering ({best}): cluster width {wc0} -> "
              f"{wc_best} ({mesh.n_node} nodes)")
    return permute_mesh(mesh, order)


def partition_reorder(mesh, partinfo, verbose: bool = True):
    """Partition-aware ordering for sharded runs: nodes grouped by
    their DIST partition rank (so the contiguous GSPMD shard splits
    fall on partition boundaries — each device owns one subdomain's
    rows, the way each reference MPI rank owns its subdomain), RCM
    within each rank's segment for cluster-ELL bandwidth."""
    node_rank = np.asarray([partinfo["node_rank"][int(g)]
                            for g in mesh.node_ids])
    conns = [b.conn for b in mesh.blocks]
    rcm = rcm_order(conns, mesh.n_node)     # new->old
    pos = np.empty(mesh.n_node, np.int64)   # old->rcm position
    pos[rcm] = np.arange(mesh.n_node)
    order = np.lexsort((pos, node_rank))    # by (rank, rcm pos)
    if verbose:
        sizes = np.bincount(node_rank, minlength=partinfo["n_ranks"])
        print(f"### partition-aware ordering: {partinfo['n_ranks']} "
              f"rank segments {list(sizes)}, RCM within each")
    return permute_mesh(mesh, order)
