"""Batched solid element kernels (torch port of
``frontistr_tpu/fem/solid.py``): the small-strain arms
(``stiffness_linear``, its isotropic closed form ``stiffness_linear_iso``,
``strains_at_gauss``, ``internal_force``; reference STF_C3 / UPDATE_C3,
fistr1/src/lib/static_LIB_3d.f90:47-205), the geometrically nonlinear
tangent (``stiffness_nlgeom``, TOTALLAG and UPDATELAG without B-bar;
STF_C3:137-204) and the incompatible-mode hex8 arm (``stiffness_hex8ic``
/ ``strains_at_gauss_hex8ic``; reference STF_C3D8IC / UpdateST_C3D8IC,
static_LIB_3dIC.f90).

Each element block is one batched product chain.  The JAX package cuts
large blocks into ``lax.map`` chunks to bound TPU temporaries; a card
holds the whole block (the float64 tangent of 1,971,054 tets is
2.27 GB), so the port runs it in one pass.
"""

from __future__ import annotations

import numpy as np
import torch

from frontistr_tpu_torch.elements.tables import ElementTable, shape_deriv
from frontistr_tpu_torch.fem.isoparam import (b_matrix, det_inv_small,
                                              jacobians, strain_selector_2d,
                                              strain_selector_3d)
from frontistr_tpu_torch.fem.material import TOTALLAG, UPDATELAG


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


def stiffness_linear_iso(table: ElementTable, coords_e: torch.Tensor,
                         lam: float, mu: float) -> torch.Tensor:
    """Isotropic small-strain stiffness in closed form (3D only):
        ke[(a,i),(b,j)] = int lam g_ai g_bj + mu (d_ij g_a.g_b + g_aj g_bi)
    one gram product of sqrt(w det)-scaled derivatives per element.
    Matches ``stiffness_linear(table, x, elastic_D(E, nu, D3))`` to f64
    rounding (same quadrature)."""
    det, g = jacobians(_table_tensor(table.dN, coords_e), coords_e)
    wg = _table_tensor(table.weights, coords_e)[None, :] * det
    gs = g * torch.sqrt(wg)[..., None, None]
    E, q, n, _ = g.shape
    G = gs.reshape(E, q, n * 3)
    M5 = torch.matmul(G.transpose(1, 2), G).reshape(E, n, 3, n, 3)
    S = torch.einsum("eakbk->eab", M5)                  # grad . grad
    ke = lam * M5 + mu * M5.permute(0, 1, 4, 3, 2)
    eye = torch.eye(3, dtype=coords_e.dtype, device=coords_e.device)
    ke = ke + mu * S[:, :, None, :, None] * eye[None, None, :, None, :]
    return ke.reshape(E, n * 3, n * 3)


def _stress_tensor(sig: torch.Tensor) -> torch.Tensor:
    """Voigt stress (11, 22, 33, 12, 23, 13) -> full 3x3 tensor."""
    s11, s22, s33, s12, s23, s13 = (sig[..., i] for i in range(6))
    return torch.stack([torch.stack([s11, s12, s13], -1),
                        torch.stack([s12, s22, s23], -1),
                        torch.stack([s13, s23, s33], -1)], -2)


def stiffness_nlgeom(table: ElementTable, coords_e: torch.Tensor,
                     u_e: torch.Tensor, D_e: torch.Tensor,
                     stress_e: torch.Tensor, flag: int) -> torch.Tensor:
    """Tangent stiffness with geometric terms (STF_C3 TOTALLAG /
    UPDATELAG arms, static_LIB_3d.f90:137-204; 3D, no B-bar).

    Args:
      u_e: (E, nn, dim) total displacement at the element nodes.
      D_e: (E, ns, ns), (1, ns, ns) for a block-constant material, or
        (E, nq, ns, ns) per quadrature point.
      stress_e: (E, nq, ns) 2nd PK (TL) / Cauchy (UL) stress.
      flag: ``material.TOTALLAG`` or ``material.UPDATELAG``.
    """
    dt = coords_e.dtype
    elem = coords_e + u_e if flag == UPDATELAG else coords_e
    det, gderiv = jacobians(_table_tensor(table.dN, coords_e), elem)
    S = _selector(table.dim, coords_e)
    w = _table_tensor(table.weights, coords_e)
    E, nn, dim = coords_e.shape
    m = nn * dim
    eye = torch.eye(dim, dtype=dt, device=coords_e.device)
    k = torch.zeros((E, m, m), dtype=dt, device=coords_e.device)
    for q in range(table.nq):
        g = gderiv[:, q]                                  # (E, nn, dim)
        wg = w[q] * det[:, q]
        B = b_matrix(S, g)
        if flag == TOTALLAG:
            # BL1: B1[k, (n, d)] = sum_ij S[k, i, j] dudx[d, i] g[n, j]
            dudx = torch.einsum("end,enj->edj", u_e, g)
            B1 = torch.einsum("kij,edi,enj->eknd", S, dudx, g)
            B = B + B1.reshape(E, B.shape[1], m)
        Dq = D_e if D_e.dim() == 3 else D_e[:, q]
        DB = torch.matmul(Dq, B) * wg[:, None, None]
        k += torch.matmul(B.transpose(1, 2), DB)
        # initial-stress stiffness: delta_ij g[a]^T sigma g[b]
        Sm = _stress_tensor(stress_e[:, q])
        gsg = torch.matmul(torch.matmul(g, Sm), g.transpose(1, 2)) \
            * wg[:, None, None]                           # (E, nn, nn)
        k += (gsg[:, :, None, :, None] * eye[None, None, :, None, :]) \
            .reshape(E, m, m)
    return k


def internal_force(table: ElementTable, coords_e: torch.Tensor,
                   stress_e: torch.Tensor) -> torch.Tensor:
    """Equivalent nodal force qf = sum_q w det B^T sigma (UPDATE_C3
    tail).  stress_e: (E, nq, ns).  Returns (E, nn*dim)."""
    det, gderiv = jacobians(_table_tensor(table.dN, coords_e), coords_e)
    S = _selector(table.dim, coords_e)
    w = _table_tensor(table.weights, coords_e)
    E, nn, dim = coords_e.shape
    wdet = w[None, :] * det
    qf = torch.einsum("kdj,eqnj,eqk,eq->end", S, gderiv, stress_e, wdet)
    return qf.reshape(E, nn * dim)


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
