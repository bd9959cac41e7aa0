"""Batched small-strain solid element kernels (torch port of the
``stiffness_linear`` / ``strains_at_gauss`` arms of
``frontistr_tpu/fem/solid.py``; reference STF_C3 / UPDATE_C3,
fistr1/src/lib/static_LIB_3d.f90:47-205), and of its incompatible-mode
hex8 arm (``stiffness_hex8ic`` / ``strains_at_gauss_hex8ic``; reference
STF_C3D8IC / UpdateST_C3D8IC, static_LIB_3dIC.f90).

Each element block is one batched product chain.  The JAX package cuts
large blocks into ``lax.map`` chunks to bound TPU temporaries; a card
holds the whole block (tet4 has one quadrature point, so B is
E x 6 x 12), so the port runs it in one pass.
"""

from __future__ import annotations

import numpy as np
import torch

from frontistr_tpu_torch.elements.tables import ElementTable, shape_deriv
from frontistr_tpu_torch.fem.isoparam import (det_inv_small, jacobians,
                                              strain_selector_2d,
                                              strain_selector_3d)


def _selector(dim: int, like: torch.Tensor) -> torch.Tensor:
    S = strain_selector_3d() if dim == 3 else strain_selector_2d()
    return torch.as_tensor(S, dtype=like.dtype, device=like.device)


def _table_tensor(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def stiffness_linear(table: ElementTable, coords_e: torch.Tensor,
                     D_e: torch.Tensor, thick: float = 1.0) -> torch.Tensor:
    """Small-strain elastic stiffness for a block of elements.

    Args:
      table: static element tables.
      coords_e: (E, nn, dim).
      D_e: (E, ns, ns) elastic matrices, or (1, ns, ns) for a
        block-constant material.
      thick: section thickness (2D only; STF_C2 PARAM1).

    Returns: (E, nn*dim, nn*dim) element stiffness.
    """
    E, nn, _ = coords_e.shape
    det, gderiv = jacobians(_table_tensor(table.dN, coords_e), coords_e)
    S = _selector(table.dim, coords_e)
    w = _table_tensor(table.weights, coords_e)
    scale = thick if table.dim == 2 else 1.0
    ns = S.shape[0]
    m = nn * table.dim
    nq = table.nq
    B = torch.einsum("kdj,eqnj->eqknd", S, gderiv).reshape(E, nq, ns, m)
    # DB[e,q,k,j] = D[e,k,l] B[e,q,l,j] as one (E, ns, nq*m) batched matmul
    B2 = B.transpose(1, 2).reshape(E, ns, nq * m)
    DB = torch.matmul(D_e, B2).reshape(E, ns, nq, m).transpose(1, 2)
    wdet = (w * scale)[None, :] * det                       # (E, nq)
    DB = DB * wdet[:, :, None, None]
    # k[e,i,j] = sum_{q,k} B[e,q,k,i] DB[e,q,k,j]
    Bt = B.reshape(E, nq * ns, m)
    DBt = DB.reshape(E, nq * ns, m)
    return torch.matmul(Bt.transpose(1, 2), DBt)


def strains_at_gauss(table: ElementTable, coords_e: torch.Tensor,
                     u_e: torch.Tensor) -> torch.Tensor:
    """Small strain at every gauss point: eps = B u (UPDATE_C3 linear
    arm).  Returns (E, nq, ns)."""
    _, gderiv = jacobians(_table_tensor(table.dN, coords_e), coords_e)
    S = _selector(table.dim, coords_e)
    return torch.einsum("kdj,eqnj,end->eqk", S, gderiv, u_e)


def _hex8ic_gderivs(table: ElementTable, coords_e: torch.Tensor):
    """Global derivatives of the hex8 incompatible-mode (Wilson) element:
    8 real nodes + 3 enhanced bending modes, gderiv(nn+k, :) =
    -2 xi_k J0^{-1}(k, :) det0 / det_q with J0 the Jacobian at the
    centre (static_LIB_3dIC.f90:100-103).

    Returns det (E, nq) and g_full (E, nq, 11, 3)."""
    dN0 = _table_tensor(shape_deriv(361, np.zeros(3)), coords_e)   # (8, 3)
    # XJ0[i, j] = sum_n x_i dN0[n, j] (the reference's getJacobian)
    det0, XJ0inv = det_inv_small(torch.einsum("eni,nj->eij", coords_e,
                                              dN0))
    det, gderiv = jacobians(_table_tensor(table.dN, coords_e), coords_e)
    pts = _table_tensor(table.points, coords_e)                   # (nq, 3)
    g_enh = (-2.0 * pts[None, :, :, None] * XJ0inv[:, None, :, :]
             * (det0[:, None] / det)[..., None, None])
    return det, torch.cat([gderiv, g_enh], dim=2)


def _hex8ic_k_full(table: ElementTable, coords_e: torch.Tensor,
                   D_e: torch.Tensor):
    """(E, 33, 33) stiffness over the 24 real and 9 enhanced dofs, and
    g_full."""
    det, g_full = _hex8ic_gderivs(table, coords_e)
    E = coords_e.shape[0]
    S = _selector(3, coords_e)
    nq, m = table.nq, 11 * 3
    B = torch.einsum("kdj,eqnj->eqknd", S, g_full).reshape(E, nq, 6, m)
    wdet = _table_tensor(table.weights, coords_e)[None, :] * det  # (E, nq)
    DB = torch.matmul(D_e[:, None], B) * wdet[:, :, None, None]
    k = torch.matmul(B.reshape(E, nq * 6, m).transpose(1, 2),
                     DB.reshape(E, nq * 6, m))
    return k, g_full


def stiffness_hex8ic(table: ElementTable, coords_e: torch.Tensor,
                     D_e: torch.Tensor) -> torch.Tensor:
    """Statically condensed incompatible-mode hex8 stiffness (STF_C3D8IC):
    K = Kdd - Kda Kaa^{-1} Kad, with Kaa (9 x 9) factorized by
    ``torch.linalg.solve``.  D_e: (E, 6, 6) or (1, 6, 6)."""
    k, _ = _hex8ic_k_full(table, coords_e, D_e)
    nd = 24
    Kda = k[:, :nd, nd:]
    return k[:, :nd, :nd] - torch.matmul(
        Kda, torch.linalg.solve(k[:, nd:, nd:], k[:, nd:, :nd]))


def strains_at_gauss_hex8ic(table: ElementTable, coords_e: torch.Tensor,
                            u_e: torch.Tensor,
                            D_e: torch.Tensor) -> torch.Tensor:
    """Strains of the IC element (UpdateST_C3D8IC): the enhanced dofs
    a = -Kaa^{-1} Kad u, then eps = B_full [u; a] at every gauss point.
    Returns (E, nq, 6)."""
    k, g_full = _hex8ic_k_full(table, coords_e, D_e)
    E, nn, dim = coords_e.shape
    nd = nn * dim
    u_flat = u_e.reshape(E, nd)
    a = -torch.linalg.solve(
        k[:, nd:, nd:], torch.matmul(k[:, nd:, :nd], u_flat[:, :, None]))
    ua = torch.cat([u_flat, a[:, :, 0]], dim=1).reshape(E, 11, dim)
    S = _selector(3, coords_e)
    return torch.einsum("kdj,eqnj,end->eqk", S, g_full, ua)
