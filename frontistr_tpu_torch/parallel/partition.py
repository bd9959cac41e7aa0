"""Mesh partitioning: node-based overlapped domains.

The TPU equivalent of hecmw_part1 (hecmw1/tools/partitioner, methods
RCB/KMETIS/PMETIS, hecmw_part_define.h:27-31): recursive coordinate
bisection over nodes, then the reference's overlap rule — every element
touching an owned node joins the domain, every non-owned node of those
elements becomes a ghost — plus import/export communication tables
(the analogue of hecmwST_local_mesh's neighbor_pe/import_index/export_index,
hecmw_util_f.F90:296-312).  These tables drive both the file-based workflow
(per-rank submesh export) and the in-memory jax.sharding layout.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


def rcb_partition(coords: np.ndarray, n_parts: int) -> np.ndarray:
    """Recursive coordinate bisection: (n_node,) -> part id."""
    assert n_parts >= 1
    part = np.zeros(len(coords), dtype=np.int32)

    def split(idx, pids):
        if len(pids) == 1:
            part[idx] = pids[0]
            return
        c = coords[idx]
        axis = np.argmax(c.max(axis=0) - c.min(axis=0))
        order = np.argsort(c[:, axis], kind="stable")
        half_parts = len(pids) // 2
        cut = len(idx) * half_parts // len(pids)
        left = idx[order[:cut]]
        right = idx[order[cut:]]
        split(left, pids[:half_parts])
        split(right, pids[half_parts:])

    split(np.arange(len(coords)), list(range(n_parts)))
    return part


@dataclasses.dataclass
class Subdomain:
    rank: int
    nodes: np.ndarray            # global node indices, internal first
    nn_internal: int
    elems: Dict[int, np.ndarray] # etype -> element rows (into block conn)
    # communication tables (indices into this domain's local node list)
    import_from: Dict[int, np.ndarray]   # neighbor -> local ghost indices
    export_to: Dict[int, np.ndarray]     # neighbor -> local internal indices


def node_graph(mesh):
    """Symmetric node-adjacency CSR of the mesh (the graph hecmw_part1
    hands to METIS, hecmw_partition.c:2140-2165)."""
    import scipy.sparse as sp
    rows, cols = [], []
    for b in mesh.blocks:
        c = b.conn
        nn = c.shape[1]
        for i in range(nn):
            for j in range(i + 1, nn):
                rows.append(c[:, i])
                cols.append(c[:, j])
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    n = mesh.n_node
    A = sp.coo_matrix((np.ones(len(r)), (r, c)), shape=(n, n))
    A = ((A + A.T) > 0).astype(float).tocsr()
    A.setdiag(0)
    A.eliminate_zeros()
    return A


def spectral_partition(mesh, n_parts: int) -> np.ndarray:
    """Graph-quality K-way partition (the KMETIS-slot method): recursive
    spectral bisection by the Fiedler vector of each subgraph's
    Laplacian.  Cuts follow the connectivity, not the bounding box —
    the reference gets this from METIS_PartGraphKway; here it is
    computed directly (multilevel matching buys speed METIS-style, but
    eigsh on the ~1e5-node graphs the tools handle is fast enough)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    A = node_graph(mesh)
    part = np.zeros(mesh.n_node, np.int32)

    def bisect(idx, pids):
        if len(pids) == 1:
            part[idx] = pids[0]
            return
        half = len(pids) // 2
        frac = half / len(pids)
        sub = A[idx][:, idx]
        d = np.asarray(sub.sum(axis=1)).reshape(-1)
        L = sp.diags(d) - sub
        # deterministic start vector (eigsh defaults to a RANDOM v0,
        # which made the cut quality flap run-to-run): the demeaned
        # longest-axis coordinate is a good Fiedler approximation
        c = mesh.coords[idx]
        ax = np.argmax(c.max(axis=0) - c.min(axis=0))
        v0 = c[:, ax] - c[:, ax].mean()
        nv = np.linalg.norm(v0)
        v0 = v0 / nv if nv > 0 else None
        try:
            # Fiedler vector: 2nd-smallest eigenvector, shift-invert
            # about 0 (L is PSD); fall back to coordinates on failure
            vals, vecs = spla.eigsh(L + 1e-8 * sp.eye(len(idx)),
                                    k=2, sigma=0, which="LM", v0=v0)
            f = vecs[:, np.argsort(vals)[1]]
        except Exception:
            f = c[:, ax]
        order = np.argsort(f, kind="stable")
        cut = int(round(len(idx) * frac))
        left = np.zeros(len(idx), bool)
        left[order[:cut]] = True
        left = _kl_refine(sub, left)
        bisect(idx[left], pids[:half])
        bisect(idx[~left], pids[half:])

    bisect(np.arange(mesh.n_node), list(range(n_parts)))
    return part


def _kl_refine(A, left, max_swaps=None):
    """Balanced Kernighan-Lin boundary refinement of one bisection:
    greedily swap the highest-gain (left, right) node pair while the
    cut shrinks (the refinement step METIS runs after each coarse
    bisection).  A is the subgraph CSR; left the side mask."""
    n = A.shape[0]
    if max_swaps is None:
        max_swaps = max(n // 8, 8)
    side = left.copy()
    sgn = np.where(side, 1.0, -1.0)
    # D[v] = ext(v) - int(v) = -sgn_v * sum_u A[v,u] * sgn_u
    for _ in range(max_swaps):
        ext_int = A @ sgn
        D = -sgn * ext_int
        li = np.nonzero(side)[0]
        ri = np.nonzero(~side)[0]
        bl = li[np.argmax(D[li])]
        br = ri[np.argmax(D[ri])]
        gain = D[bl] + D[br] - 2.0 * A[bl, br]
        if gain <= 1e-12:
            break
        side[bl] = False
        side[br] = True
        sgn[bl] = -1.0
        sgn[br] = 1.0
    return side


def edge_cut(mesh, part) -> int:
    """Number of graph edges crossing partition boundaries."""
    A = node_graph(mesh).tocoo()
    m = A.row < A.col
    return int((part[A.row[m]] != part[A.col[m]]).sum())


def partition_mesh(mesh, n_parts: int, method: str = "RCB"):
    """Node-based overlapping decomposition of a Mesh.

    method: RCB (coordinate bisection), BLOCK (node-index blocks),
    KMETIS (spectral graph K-way — the METIS-quality option).
    Returns (part (n_node,), [Subdomain]).
    """
    method = (method or "RCB").upper()
    if method == "KMETIS":
        part = spectral_partition(mesh, n_parts)
    elif method == "BLOCK":
        part = np.minimum(
            np.arange(mesh.n_node) * n_parts // max(mesh.n_node, 1),
            n_parts - 1).astype(np.int32)
    else:
        part = rcb_partition(mesh.coords, n_parts)
    subs: List[Subdomain] = []
    # node -> owner
    for r in range(n_parts):
        internal = np.nonzero(part == r)[0]
        own = np.zeros(mesh.n_node, bool)
        own[internal] = True
        elems: Dict[int, np.ndarray] = {}
        ghost_set = set()
        for bi, b in enumerate(mesh.blocks):
            touch = own[b.conn].any(axis=1)
            rows = np.nonzero(touch)[0]
            elems[bi] = rows
            for nidx in np.unique(b.conn[rows]):
                if not own[nidx]:
                    ghost_set.add(int(nidx))
        ghosts = np.asarray(sorted(ghost_set), dtype=np.int64)
        nodes = np.concatenate([internal, ghosts])
        loc = {int(g): i for i, g in enumerate(nodes)}
        import_from: Dict[int, List[int]] = {}
        for g in ghosts:
            owner = int(part[g])
            import_from.setdefault(owner, []).append(loc[int(g)])
        subs.append(Subdomain(
            r, nodes, len(internal), elems,
            {k: np.asarray(v, dtype=np.int64)
             for k, v in import_from.items()}, {}))
    # export tables: mirror of imports
    g2l = [ {int(g): i for i, g in enumerate(s.nodes)} for s in subs ]
    for s in subs:
        for nb, ghost_loc in s.import_from.items():
            glob = s.nodes[ghost_loc]
            subs[nb].export_to[s.rank] = np.asarray(
                [g2l[nb][int(g)] for g in glob], dtype=np.int64)
    return part, subs


def halo_exchange_reference(subs, local_vecs):
    """Host-side halo update (semantics of hecmw_update_m_R): overwrite each
    domain's ghost entries with the owner's internal values.  Used to verify
    the sharded compute path and by the file-based tools."""
    out = [v.copy() for v in local_vecs]
    for s in subs:
        for nb, imp_loc in s.import_from.items():
            exp_loc = subs[nb].export_to[s.rank]
            out[s.rank][imp_loc] = local_vecs[nb][exp_loc]
    return out


def partition_to_files(mesh, n_parts: int, out_base: str,
                       method: str = "RCB"):
    """File-based partitioner (the hecmw_part1 tool surface): write one
    HECMW-DIST file per rank as '<out_base>.<rank>'."""
    from frontistr_tpu_torch.io.distio import dist_from_subdomain, write_dist
    part, subs = partition_mesh(mesh, n_parts, method)
    paths = []
    for r in range(n_parts):
        dm = dist_from_subdomain(mesh, subs, r, part=part)
        p = f"{out_base}.{r}"
        write_dist(dm, p)
        paths.append(p)
    return paths
