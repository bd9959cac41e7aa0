"""Chebyshev polynomial preconditioner (torch port of
``frontistr_tpu/solver/cheby.py``).

A fixed-degree Chebyshev polynomial in the block-Jacobi-preconditioned
operator, z = p_k(M_J A) M_J r with p_k fitted to 1/lambda on
[alpha*lmax, lmax]: only products, no sweep.  lmax comes once a solve
from a power iteration (the analogue of the reference's auto-sigma
logic in hecmw_solver_Iterative.f90).  Linear STATIC takes it with
FRONTISTR_TPU_PRECOND=cheby, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

DEGREE = 8              # the polynomial's degree (the JAX package's)
ALPHA = 1.0 / 30.0      # the spectrum taken in [ALPHA * lmax, lmax]


def estimate_lmax(A, M, n: int, device) -> float:
    """Power iteration on M A (SPD in the M^-1 inner product), 12 steps
    from the JAX package's start vector, ``np.random.default_rng(7)``."""
    rng = np.random.default_rng(7)
    v = torch.as_tensor(rng.standard_normal(n), device=device)
    v = v / torch.linalg.vector_norm(v)
    lam = 1.0
    for _ in range(12):
        w = M(A(v))
        lam = float(torch.linalg.vector_norm(w))
        v = w / lam
    return lam


def chebyshev_precond(A, M, lmax: float):
    """z = p(M A) M r ~= (M A)^-1 M r: ``DEGREE`` steps of the Chebyshev
    semi-iteration for B = M A with its spectrum taken in
    [ALPHA * lmax, lmax], from z0 = 0.  Returns ``apply(r)``."""
    lmin = ALPHA * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)

    def apply(r):
        b = M(r)
        d = b / theta
        z = d
        sigma = theta / delta
        rho_old = 1.0 / sigma
        resid = b - M(A(z))
        for _ in range(DEGREE - 1):
            rho = 1.0 / (2.0 * sigma - rho_old)
            d = rho * rho_old * d + (2.0 * rho / delta) * resid
            z = z + d
            resid = resid - M(A(d))
            rho_old = rho
        return z

    return apply
