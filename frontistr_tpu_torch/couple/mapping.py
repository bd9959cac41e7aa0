"""Inter-mesh interface mapping + staggered coupling driver (host
numpy, copied from ``frontistr_tpu/couple/mapping.py``; only the imports
differ).

Rebuild of the hecmw coupler's geometric core (hecmw1/src/couple/):
  - hecmw_couple_background_cell.c / hecmw_couple_judge.c: locate each
    destination point in the source mesh (here: brute-force candidate
    search by centroid distance, then isoparametric inversion — meshes at
    coupling interfaces are small, O(n_src * n_dst) distances are a single
    batched numpy op)
  - hecmw_couple_interpolate_info.c: interpolation weights = shape
    functions at the located natural coordinates
  - hecmw_couple_f.f90 hecmw_couple(boundary_id): staggered exchange —
    here `StaggeredCoupling.transfer` applies the stored weights.

The reference couples separate MPI applications; here both fields run in
one process and exchange host arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from frontistr_tpu_torch.elements.tables import get_table, ETYPE_INFO


@dataclasses.dataclass
class InterfaceMap:
    """dst_value = sum_k weights[i,k] * src_value[src_nodes[i,k]]"""
    src_nodes: np.ndarray      # (n_dst, max_nn)
    weights: np.ndarray        # (n_dst, max_nn)
    outside: np.ndarray        # (n_dst,) bool: clamped extrapolation

    def transfer(self, field: np.ndarray) -> np.ndarray:
        """field (n_src_node,) or (n_src_node, k) -> (n_dst, ...)"""
        return np.einsum("ik,ik...->i...", self.weights,
                         np.asarray(field)[self.src_nodes])


def build_map(src_mesh, dst_points: np.ndarray,
              clamp: bool = True) -> InterfaceMap:
    """Locate each dst point in the source mesh and store shape-function
    weights."""
    blocks = [b for b in src_mesh.blocks if b.etype in ETYPE_INFO]
    n_dst = len(dst_points)
    max_nn = max(b.conn.shape[1] for b in blocks)
    src_nodes = np.zeros((n_dst, max_nn), np.int64)
    weights = np.zeros((n_dst, max_nn))
    outside = np.zeros(n_dst, bool)

    # candidate elements by centroid distance (all blocks pooled)
    cents, owners = [], []
    for bi, b in enumerate(blocks):
        cents.append(src_mesh.coords[b.conn].mean(axis=1))
        owners.extend([(bi, k) for k in range(len(b.conn))])
    cents = np.concatenate(cents)
    dim = cents.shape[1]
    d2 = ((dst_points[:, None, :dim] - cents[None]) ** 2).sum(-1)
    cand = np.argsort(d2, axis=1)[:, :8]

    for i, p in enumerate(dst_points):
        best = None
        for c in cand[i]:
            bi, k = owners[int(c)]
            b = blocks[bi]
            xe = src_mesh.coords[b.conn[k]][:, :dim]
            xi = _newton_xi(b.etype, xe, p[:dim])
            N = _shape_at(b.etype, xi)
            inside = _inside(b.etype, xi, tol=1e-8)
            score = _outside_dist(b.etype, xi)
            if best is None or score < best[0]:
                best = (score, bi, k, N, inside)
            if inside:
                break
        score, bi, k, N, inside = best
        b = blocks[bi]
        nn = b.conn.shape[1]
        src_nodes[i, :nn] = b.conn[k]
        weights[i, :nn] = N
        outside[i] = not inside
        if clamp and not inside:
            # renormalize clipped shape functions
            w = np.clip(N, 0.0, None)
            s = w.sum()
            weights[i, :nn] = w / (s if s > 0 else 1.0)
    return InterfaceMap(src_nodes, weights, outside)


_SIMPLEX = {231, 232, 341, 342}
_PRISM = {351, 352}


def _center_of(etype, dim):
    if etype in _SIMPLEX:
        return np.full(dim, 1.0 / (dim + 1.0))
    if etype in _PRISM:
        return np.asarray([1.0 / 3.0, 1.0 / 3.0, 0.0])
    return np.zeros(dim)


def _newton_xi(etype, xe, p, iters=15):
    from frontistr_tpu_torch.elements.tables import shape_func, shape_deriv
    dim = xe.shape[1]
    xi = _center_of(etype, dim)
    for _ in range(iters):
        N = np.asarray(shape_func(etype, xi))
        dN = np.asarray(shape_deriv(etype, xi))
        r = N @ xe - p
        J = dN.T @ xe                      # (dim_xi, dim_x)
        try:
            dxi = np.linalg.solve(J.T, r)
        except np.linalg.LinAlgError:
            break
        xi = xi - dxi
        if np.linalg.norm(dxi) < 1e-13:
            break
    return xi


def _shape_at(etype, xi):
    from frontistr_tpu_torch.elements.tables import shape_func
    return np.asarray(shape_func(etype, xi))


def _inside(etype, xi, tol=1e-8):
    if etype in _SIMPLEX:
        return bool((xi >= -tol).all() and xi.sum() <= 1.0 + tol)
    if etype in _PRISM:
        return bool((xi[:2] >= -tol).all() and xi[:2].sum() <= 1 + tol
                    and abs(xi[2]) <= 1 + tol)
    return bool((np.abs(xi) <= 1.0 + tol).all())


def _outside_dist(etype, xi):
    if etype in _SIMPLEX:
        v = np.concatenate([np.minimum(xi, 0.0),
                            [max(xi.sum() - 1.0, 0.0)]])
        return float(np.abs(v).sum())
    if etype in _PRISM:
        v = [max(-xi[0], 0), max(-xi[1], 0),
             max(xi[0] + xi[1] - 1, 0), max(abs(xi[2]) - 1, 0)]
        return float(sum(v))
    return float(np.clip(np.abs(xi) - 1.0, 0.0, None).sum())


class StaggeredCoupling:
    """Two-field staggered driver (the in-process analogue of
    hecmw_couple's unit/pair control + fstr_rcap_io exchange loop)."""

    def __init__(self, src_mesh, dst_mesh,
                 dst_nodes: Optional[np.ndarray] = None):
        pts = dst_mesh.coords if dst_nodes is None \
            else dst_mesh.coords[dst_nodes]
        self.map = build_map(src_mesh, pts)
        self.dst_nodes = dst_nodes

    def transfer(self, field: np.ndarray, n_dst_total=None):
        vals = self.map.transfer(field)
        if self.dst_nodes is None:
            return vals
        out = np.zeros((n_dst_total,) + vals.shape[1:])
        out[self.dst_nodes] = vals
        return out
