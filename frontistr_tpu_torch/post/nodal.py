"""Nodal stress/strain smoothing (torch port of
``frontistr_tpu/post/nodal.py``; reference fstr_NodalStress3D /
fstr_NodalStress2D, fistr1/src/analysis/static/fstr_NodalStress.f90).

One precomputed extrapolation matrix per element type maps gauss values
to element-node values; a global sum per node (K1's planes entry, in a
fixed order) and a per-node count then average them, exactly as the
reference does:
  - tri3/tet4/prism6: gauss mean broadcast to all nodes (NodalStress_C2/C3)
  - quad4/tri6/quad8/tet10/hex8/prism15/hex20: inverse shape-function
    extrapolation on corner gauss subsets, midside nodes = average of
    the adjacent corners (NodalStress_INV2/INV3)
  - element value = plain gauss mean (ElementStress_C2/C3)
The sums run on the device of the gauss values.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List

import numpy as np
import torch

from frontistr_tpu_torch.assembly.segsum import (SegsumPlan, make_plan,
                                                 segsum_planes)
from frontistr_tpu_torch.elements.tables import (ETYPE_INFO, get_table,
                                                 shape_func)

# midside-node -> (cornerA, cornerB) tables, FSTR ordering (0-based)
_MIDS = {
    232: {3: (0, 1), 4: (1, 2), 5: (2, 0)},
    242: {4: (0, 1), 5: (1, 2), 6: (2, 3), 7: (3, 0)},
    342: {4: (0, 1), 5: (1, 2), 6: (2, 0), 7: (0, 3), 8: (1, 3), 9: (2, 3)},
    352: {6: (0, 1), 7: (1, 2), 8: (2, 0), 9: (3, 4), 10: (4, 5),
          11: (5, 3), 12: (0, 3), 13: (1, 4), 14: (2, 5)},
    362: {8: (0, 1), 9: (1, 2), 10: (2, 3), 11: (3, 0),
          12: (4, 5), 13: (5, 6), 14: (6, 7), 15: (7, 4),
          16: (0, 4), 17: (1, 5), 18: (2, 6), 19: (3, 7)},
}

# gauss subset used for corner extrapolation and the lower-order "corner
# element" providing the shape functions (fstr_NodalStress.f90:69-106)
_CORNER_RULE = {
    232: (231, [0, 1, 2]),
    241: (241, [0, 1, 2, 3]),
    242: (241, [0, 2, 6, 8]),
    342: (341, [0, 1, 2, 3]),
    361: (361, [0, 1, 2, 3, 4, 5, 6, 7]),
    352: (351, [0, 1, 2, 6, 7, 8]),
    362: (361, [0, 2, 6, 8, 18, 20, 24, 26]),
}


@lru_cache(maxsize=None)
def extrapolation_matrix(etype: int) -> np.ndarray:
    """(nn, nq) matrix mapping gauss values to nodal values."""
    table = get_table(etype)
    nn, nq = table.nn, table.nq
    if etype not in _CORNER_RULE:
        return np.full((nn, nq), 1.0 / nq)
    corner_etype, subset = _CORNER_RULE[etype]
    nc = ETYPE_INFO[corner_etype][1]
    A = np.stack([shape_func(corner_etype, p)
                  for p in table.points[subset]])
    Ainv = np.linalg.inv(A)
    E = np.zeros((nn, nq))
    for col, q in enumerate(subset):
        E[:nc, q] = Ainv[:, col]
    for mid, (a, b) in _MIDS.get(etype, {}).items():
        E[mid] = 0.5 * (E[a] + E[b])
    return E


def mises_3d(s: torch.Tensor) -> torch.Tensor:
    """von Mises from 6-component stress (get_mises,
    fstr_NodalStress.f90:483-499)."""
    s11, s22, s33 = s[..., 0], s[..., 1], s[..., 2]
    s12, s23, s13 = s[..., 3], s[..., 4], s[..., 5]
    ps = (s11 + s22 + s33) / 3.0
    sm = 0.5 * ((s11 - ps) ** 2 + (s22 - ps) ** 2 + (s33 - ps) ** 2) \
        + s12 ** 2 + s23 ** 2 + s13 ** 2
    return torch.sqrt(3.0 * sm)


def mises_2d(s: torch.Tensor) -> torch.Tensor:
    """2D von Mises (fstr_NodalStress2D)."""
    s11, s22, s12 = s[..., 0], s[..., 1], s[..., 2]
    return torch.sqrt(0.5 * ((s11 - s22) ** 2 + s11 ** 2 + s22 ** 2)
                      + 3.0 * s12 ** 2)


def node_plan(conn: np.ndarray, n_node: int, device) -> SegsumPlan:
    """Segment-sum plan of element-node entries onto nodes: a stable sort
    of the flat connectivity ``conn`` on ``device``, so each node sums
    its entries in their order."""
    seg, perm = torch.sort(torch.as_tensor(conn, device=device),
                           stable=True)
    return make_plan(perm, seg, n_node, (conn.size,), device)


def skip_block(block, dim: int, device) -> dict:
    """The ``smooth`` entry of a block without continuum stress (a
    solid-shell or beam beside solids): zero element rows, no nodal
    contribution."""
    z = torch.zeros((len(block.elem_ids), 1, 6 if dim == 3 else 3),
                    dtype=torch.float64, device=device)
    return dict(etype=block.etype, conn=block.conn[:, :0], gauss_strain=z,
                gauss_stress=z, skip=True)


def smooth(n_node: int, block_data: List[dict], dim: int):
    """Average per-element nodal values onto mesh nodes.

    Args:
      block_data: per block a dict with 'etype', 'conn' (E, nn) numpy,
        'gauss_strain' / 'gauss_stress' (E, nq, ns) tensors, and 'skip'
        for a block without continuum stress (``skip_block``).
      dim: 2 or 3.

    Returns a dict of numpy arrays: nodal 'strain', 'stress', 'mises',
    'count' and per-block element means ('estrain', 'estress', 'emises'
    lists).
    """
    ns = 6 if dim == 3 else 3
    dev = block_data[0]["gauss_strain"].device
    dt = block_data[0]["gauss_strain"].dtype
    mises = mises_3d if dim == 3 else mises_2d
    est, ess, ems = [], [], []
    planes, conns = [], []
    for bd in block_data:
        conn = np.asarray(bd["conn"], np.int64)
        geps = bd["gauss_strain"][..., :ns]
        gsig = bd["gauss_stress"][..., :ns]
        if bd.get("skip"):
            z = np.zeros((len(geps), ns))
            est.append(z)
            ess.append(z)
            ems.append(np.zeros(len(geps)))
            continue
        Ex = torch.as_tensor(extrapolation_matrix(bd["etype"]), dtype=dt,
                             device=dev)
        nd_eps = torch.einsum("nq,eqs->ens", Ex, geps)
        nd_sig = torch.einsum("nq,eqs->ens", Ex, gsig)
        planes.append(torch.cat([nd_eps.reshape(-1, ns).T,
                                 nd_sig.reshape(-1, ns).T,
                                 nd_eps.new_ones((1, conn.size))]))
        conns.append(conn.reshape(-1))
        e_sig = gsig.mean(dim=1)
        est.append(geps.mean(dim=1).cpu().numpy())
        ess.append(e_sig.cpu().numpy())
        ems.append(mises(e_sig).cpu().numpy())
    # strains, stresses and counts of every block's element nodes summed
    # per node in one K1 planes launch, in the entries' order
    acc = segsum_planes(torch.cat(planes, dim=1),
                        node_plan(np.concatenate(conns), n_node, dev)) \
        if planes else torch.zeros((2 * ns + 1, n_node), dtype=dt,
                                   device=dev)
    acc_eps, acc_sig, count = acc[:ns].T, acc[ns:2 * ns].T, acc[2 * ns]
    cnt = torch.where(count == 0, torch.ones_like(count), count)
    nd_eps = acc_eps / cnt[:, None]
    nd_sig = acc_sig / cnt[:, None]
    return dict(strain=nd_eps.cpu().numpy(), stress=nd_sig.cpu().numpy(),
                mises=mises(nd_sig).cpu().numpy(),
                count=count.cpu().numpy(),
                estrain=est, estress=ess, emises=ems)
