"""Batched small-strain solid element kernels (torch port of the
``stiffness_linear`` / ``strains_at_gauss`` arms of
``frontistr_tpu/fem/solid.py``; reference STF_C3 / UPDATE_C3,
fistr1/src/lib/static_LIB_3d.f90:47-205).

Each element block is one batched product chain.  The JAX package cuts
large blocks into ``lax.map`` chunks to bound TPU temporaries; a card
holds the whole block (tet4 has one quadrature point, so B is
E x 6 x 12), so the port runs it in one pass.
"""

from __future__ import annotations

import torch

from frontistr_tpu_torch.elements.tables import ElementTable
from frontistr_tpu_torch.fem.isoparam import (jacobians,
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
