"""Multicolor block-SSOR preconditioner (torch port of
``frontistr_tpu/solver/ssor.py``).

The reference's sweep preconditioners are sequential forward/backward
block-SOR sweeps (hecmw1/src/solver/precond/33/hecmw_precond_SSOR_33.f90:
55-174) with an optional multicolor node ordering to expose parallelism
(hecmw1/src/matrix/hecmw_matrix_ordering_MC.f90).  Nodes of one color
share no edge, so a whole color updates at once: one gather of the
current iterate by the color's ELL columns, one batched block-row
product, one batched nd x nd solve.  A forward plus backward sweep reads
every ELL block twice, in ``2 * ncolors`` such steps.

The Newton driver takes it for !SOLVER PRECOND=10/11/12/20/21 (the
reference's BILU, SAINV and RIF ids, sweep-class methods) or
FRONTISTR_TPU_PRECOND=ssor, as the JAX package does.  In linear STATIC
the JAX package's AMG eligibility turns ``ssor`` into block-Jacobi.

M^{-1} = omega (2-omega) (D/omega + U)^{-1} D (D/omega + L)^{-1} in the
color ordering: SPD for SPD K and 0 < omega < 2, hence CG-safe (L/U are
the strict lower/upper parts with respect to the color order, a
reordered SSOR).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

OMEGA = 1.0     # the relaxation factor (the JAX package's default)


@dataclasses.dataclass
class SSORMaps:
    """Static multicolor maps, built on the host once.  rows[c, :] lists
    the nodes of color c, padded with n_node (the JAX package's layout,
    a phantom row); ``colors(device)`` gives each color's nodes without
    the padding."""
    ncol: int
    n_node: int
    rows: np.ndarray        # (ncol, Rmax) int32, pad = n_node

    def colors(self, device) -> List[torch.Tensor]:
        cache = self.__dict__.setdefault("_colors", {})
        key = str(torch.device(device))
        if key not in cache:
            cache[key] = [torch.as_tensor(r[r < self.n_node], dtype=torch.int64,
                                          device=device)
                          for r in self.rows]
        return cache[key]


def build_color_maps(cols: np.ndarray, n_node: int) -> SSORMaps:
    """Greedy smallest-available coloring of the node graph (host numpy,
    bit-equal to the JAX package's).

    Jones-Plassmann rounds over the ELL adjacency: each round colors the
    uncolored nodes whose random priority is the least among their
    uncolored neighbors, each with the smallest color absent among its
    colored neighbors, so the count stays near greedy's max degree + 1;
    whole-array numpy, no per-node Python loop.
    """
    N, W = cols.shape
    colsc = cols.astype(np.int64)
    color = np.full(N, -1, np.int64)
    self_m = colsc == np.arange(N)[:, None]
    # random priorities: index order degenerates on band-ordered meshes
    # (a path graph would color one node per round)
    pri = np.random.default_rng(7).permutation(N).astype(np.int64)
    while True:
        unc = color < 0
        if not unc.any():
            break
        nb_unc = unc[colsc] & ~self_m
        nb_pri = np.where(nb_unc, pri[colsc], np.int64(2 * N))
        sel = np.flatnonzero(unc & (pri < nb_pri.min(axis=1)))
        nbc = color[colsc[sel]]                      # (s, W), -1 = none
        s = len(sel)
        used = np.zeros((s, W + 2), bool)
        valid = nbc >= 0
        used[np.repeat(np.arange(s), W)[valid.ravel()],
             nbc.ravel()[valid.ravel()]] = True
        color[sel] = np.argmax(~used, axis=1)
    ncol = int(color.max()) + 1
    counts = np.bincount(color, minlength=ncol)
    Rmax = int(counts.max())
    Rmax = max(-(-Rmax // 128) * 128, 128)
    rows = np.full((ncol, Rmax), N, np.int32)
    order = np.argsort(color, kind="stable")
    off = 0
    for k in range(ncol):
        rows[k, :counts[k]] = order[off:off + counts[k]]
        off += counts[k]
    return SSORMaps(ncol=ncol, n_node=n_node, rows=rows)


def _block_inv(D: torch.Tensor) -> torch.Tensor:
    """Inverse nodal blocks, a unit diagonal where an entry is 0, in
    float64."""
    nd = D.shape[-1]
    ar = torch.arange(nd, device=D.device)
    D = D.clone()
    dd = D[:, ar, ar]
    D[:, ar, ar] = dd + (dd == 0.0).to(D.dtype)
    return torch.linalg.inv(D.to(torch.float64)).to(D.dtype)


def setup_ssor(maps: SSORMaps, blocks: torch.Tensor, cols: torch.Tensor,
               diag: torch.Tensor, free_mask: torch.Tensor,
               ndof: int) -> Callable:
    """M(r) ~= K^{-1} r by one multicolor SSOR sweep (forward, then
    backward), relaxation ``OMEGA``.

    blocks: the scalar ELL blocks as nd*nd planes (nd*nd, N, W) (the
    cluster path's ``extract_scalar_blocks``) or as (N, W, nd, nd); cols
    (N, W); diag (N, nd, nd) the nodal diagonal blocks; free_mask
    (N*nd,).  Each color's block rows, columns and inverse diagonal
    blocks are gathered once here, so a color's step reads them in
    order."""
    nd = ndof
    N = maps.n_node
    if blocks.dim() == 3:
        W = blocks.shape[2]
        rows = blocks.reshape(nd, nd, N, W).permute(2, 0, 3, 1)
    else:
        W = blocks.shape[1]
        rows = blocks.permute(0, 2, 1, 3)
    f = blocks.dtype
    rows = rows.reshape(N, nd, W * nd)
    fm = free_mask.reshape(N, nd).to(f)
    Dm = diag.to(f) * (fm[:, :, None] * fm[:, None, :])
    Dinv = _block_inv(Dm) * OMEGA
    cols = cols.to(torch.int64)
    per = []
    for rc in maps.colors(blocks.device):
        cg = cols[rc]                                # (Rc, W)
        per.append((rc, cg, fm[cg].reshape(len(rc), W * nd, 1),
                    rows[rc], Dinv[rc]))

    def _half(rn, order):
        """(D/omega + L)^-1 rn (forward order) or (D/omega + U)^-1 rn
        (backward): each color solves its rows against the colors done
        before it (z is 0 on its own rows)."""
        z = rn.new_zeros((N, nd))
        for c in order:
            rc, cg, fg, rr, di = per[c]
            zg = z[cg].reshape(len(rc), W * nd, 1) * fg
            rhs = rn[rc] - torch.bmm(rr, zg).squeeze(2)
            z[rc] = torch.bmm(di, rhs.unsqueeze(2)).squeeze(2)
        return z

    fwd = list(range(maps.ncol))
    bwd = fwd[::-1]

    def M(r):
        fr = free_mask.to(f)
        rn = (r.to(f) * fr).reshape(N, nd)
        z1 = _half(rn, fwd)                    # (D/omega + L)^-1 r
        w = torch.bmm(Dm, z1.unsqueeze(2)).squeeze(2) / OMEGA
        x = OMEGA * (2.0 - OMEGA) * _half(w, bwd)
        return x.reshape(-1) * fr + r.to(f) * (1.0 - fr)

    return M


def eligible_maps(profile, policy: Optional[str]) -> Optional[SSORMaps]:
    """The color maps of an ELL profile when ``policy`` is ``ssor``
    (cached on the profile, as ``amg.eligible_maps`` caches its maps),
    else None."""
    if policy != "ssor":
        return None
    maps = profile.__dict__.get("_ssor_maps")
    if maps is None:
        maps = build_color_maps(np.asarray(profile.cols), profile.n_node)
        profile.__dict__["_ssor_maps"] = maps
    return maps
