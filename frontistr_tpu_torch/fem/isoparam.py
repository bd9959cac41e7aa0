"""Batched isoparametric geometry (torch port of
``frontistr_tpu/fem/isoparam.py``).

Every quantity carries a leading element axis ``E``.  Conventions match
the reference (fistr1/src/lib/element/element.f90 getGlobalDeriv):
  J[i, j]      = d x_j / d xi_i = sum_n dN[n, i] * x[n, j]
  gderiv[n, j] = d N_n / d x_j  = (dN @ J^{-T})[n, j]
"""

from __future__ import annotations

import numpy as np
import torch


def det_inv_small(J: torch.Tensor):
    """Closed-form determinant + inverse for batched 2x2 / 3x3 matrices
    (the same cofactor arithmetic as the JAX package, so the two agree
    to the last bits); larger matrices go to ``torch.linalg``."""
    d = J.shape[-1]
    if d == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, e = J[..., 1, 0], J[..., 1, 1]
        det = a * e - b * c
        inv_det = 1.0 / det
        inv = torch.stack([
            torch.stack([e, -b], -1),
            torch.stack([-c, a], -1),
        ], -2) * inv_det[..., None, None]
        return det, inv
    if d == 3:
        a00, a01, a02 = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
        a10, a11, a12 = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
        a20, a21, a22 = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
        c00 = a11 * a22 - a12 * a21
        c01 = a12 * a20 - a10 * a22
        c02 = a10 * a21 - a11 * a20
        det = a00 * c00 + a01 * c01 + a02 * c02
        inv_det = 1.0 / det
        inv = torch.stack([
            torch.stack([c00, a02 * a21 - a01 * a22,
                         a01 * a12 - a02 * a11], -1),
            torch.stack([c01, a00 * a22 - a02 * a20,
                         a02 * a10 - a00 * a12], -1),
            torch.stack([c02, a01 * a20 - a00 * a21,
                         a00 * a11 - a01 * a10], -1),
        ], -2) * inv_det[..., None, None]
        return det, inv
    return torch.linalg.det(J), torch.linalg.inv(J)


def jacobians(dN: torch.Tensor, coords_e: torch.Tensor):
    """Per-quadrature-point Jacobians for a batch of elements.

    Args:
      dN: (nq, nn, dim) natural shape derivatives (static table).
      coords_e: (E, nn, dim) element node coordinates.

    Returns:
      det: (E, nq) Jacobian determinants.
      gderiv: (E, nq, nn, dim) global shape derivatives.
    """
    J = torch.einsum("qni,enj->eqij", dN, coords_e)
    det, Jinv = det_inv_small(J)
    gderiv = torch.einsum("qni,eqji->eqnj", dN, Jinv)
    return det, gderiv


def strain_selector_3d() -> np.ndarray:
    """B = S . gderiv; 3D Voigt order (e11,e22,e33,g12,g23,g13),
    static_LIB_3d.f90:124-135."""
    S = np.zeros((6, 3, 3))
    S[0, 0, 0] = 1.0
    S[1, 1, 1] = 1.0
    S[2, 2, 2] = 1.0
    S[3, 0, 1] = S[3, 1, 0] = 1.0
    S[4, 1, 2] = S[4, 2, 1] = 1.0
    S[5, 0, 2] = S[5, 2, 0] = 1.0
    return S


def strain_selector_2d() -> np.ndarray:
    """2D order (e11,e22,g12,e_theta), static_LIB_2d.f90:63-71."""
    S = np.zeros((4, 2, 2))
    S[0, 0, 0] = 1.0
    S[1, 1, 1] = 1.0
    S[2, 0, 1] = S[2, 1, 0] = 1.0
    return S
