"""Geometric two-grid preconditioner for structured hex boxes (torch
port of ``frontistr_tpu/solver/mg.py``).

Transfers are separable trilinear interpolation: one dense 1-D weight
contraction per direction on dof-major grids.  Symmetric V(1,1) cycle,
usable as a stationary SPD preconditioner in CG:

  x  = w D^-1 r                      (damped-Jacobi pre-smooth)
  ec = Cheb_k(Ac, Dc)(R (r - A x))   (fixed-degree coarse solve)
  x += P ec
  x += w D^-1 (r - A x)              (post-smooth)

with Ac re-discretized on the coarse box and R = P^T.  The operators are
``assembly/structured.StructuredHexOperatorD`` (K2 on the card).
"""

from __future__ import annotations

import numpy as np
import torch


def interp1d_weights(n_f: int, n_c: int, factor: int) -> np.ndarray:
    """(n_f+1, n_c+1) corner-aligned linear interpolation weights for a
    1D grid coarsened by `factor` (n_f = factor * n_c)."""
    assert n_f == factor * n_c
    W = np.zeros((n_f + 1, n_c + 1))
    for f in range(n_f + 1):
        c, rem = divmod(f, factor)
        t = rem / factor
        if rem == 0:
            W[f, c] = 1.0
        else:
            W[f, c] = 1.0 - t
            W[f, c + 1] = t
    return W


def make_transfers(nx, ny, nz, factor=3, dtype=torch.float32,
                   device="cpu"):
    """(prolong, restrict) between the dof-major fine grid of the box and
    its coarse box of (nx, ny, nz) / factor."""
    Wx, Wy, Wz = (torch.as_tensor(interp1d_weights(n, n // factor, factor),
                                  dtype=dtype, device=device)
                  for n in (nx, ny, nz))

    def prolong(vc):
        """(3 * coarse nodes,) dof-major -> fine."""
        v = vc.reshape(3, Wx.shape[1], Wy.shape[1], Wz.shape[1])
        v = torch.einsum("fi,dijk->dfjk", Wx, v)
        v = torch.einsum("gj,dfjk->dfgk", Wy, v)
        v = torch.einsum("hk,dfgk->dfgh", Wz, v)
        return v.reshape(-1)

    def restrict(vf):
        v = vf.reshape(3, Wx.shape[0], Wy.shape[0], Wz.shape[0])
        v = torch.einsum("fi,dfgh->digh", Wx, v)
        v = torch.einsum("gj,digh->dijh", Wy, v)
        v = torch.einsum("hk,dijh->dijk", Wz, v)
        return v.reshape(-1)

    return prolong, restrict


def chebyshev_apply(A, Dinv_apply, lmax, degree, r, kappa=100.0):
    """z ~= A^-1 r via Chebyshev on the D^-1-preconditioned operator,
    spectrum in [lmax/kappa, lmax] (stationary: safe inside CG)."""
    lmin = lmax / kappa
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    b = Dinv_apply(r)
    d = b / theta
    z = d
    sigma = theta / delta
    rho_old = 1.0 / sigma
    resid = b - Dinv_apply(A(z))
    for _ in range(degree - 1):
        rho = 1.0 / (2.0 * sigma - rho_old)
        d = rho * rho_old * d + (2.0 * rho / delta) * resid
        z = z + d
        resid = resid - Dinv_apply(A(d))
        rho_old = rho
    return z


def make_twogrid(op_f, op_c, prolong, restrict, lmax_c,
                 omega=0.6, cheb_degree=20, kappa=100.0):
    """Symmetric V(1,1) two-grid preconditioner for CG.

    op_f/op_c: operators with apply_constrained + block_jacobi; the
    coarse free_mask must correspond to the restriction of the fine one.
    """
    Df = op_f.block_jacobi()
    Dc = op_c.block_jacobi()
    A = op_f.apply_constrained
    Ac = op_c.apply_constrained
    fm_f = op_f.free_mask
    fm_c = op_c.free_mask

    def M(r):
        r = r * fm_f
        x = omega * Df(r)
        rr = r - A(x)
        rc = restrict(rr) * fm_c
        ec = chebyshev_apply(Ac, Dc, lmax_c, cheb_degree, rc,
                             kappa=kappa)
        x = x + prolong(ec * fm_c) * fm_f
        rr2 = r - A(x)
        x = x + omega * Df(rr2)
        return x

    return M
