"""Preconditioned MINRES for symmetric indefinite systems (torch port of
``frontistr_tpu/solver/minres.py``; Paige & Saunders 1975).

The contact saddle system [K B^T; B 0] (the reference's
``solve_no_eliminate`` arm, solve_LINEQ_iter_contact.f90:46-109) is
indefinite, so CG breaks down on it; MINRES minimises the residual over
the Krylov space with a three-term Lanczos recurrence.  The
preconditioner must be symmetric positive definite.  A Python loop over
device tensors; the convergence test reads one scalar per iteration.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from frontistr_tpu_torch.solver.cg import CGResult


def _identity(x):
    return x


def minres(A: Callable, b: torch.Tensor, M: Optional[Callable] = None,
           tol: float = 1.0e-8, maxiter: int = 10000) -> CGResult:
    """Left-preconditioned MINRES (the JAX package's recurrences).
    Solves A x = b, A symmetric (possibly indefinite), M an SPD
    approximation of A^-1 applied as a function.  ``relres`` is the
    preconditioned residual-norm estimate relative to ||b||_M (the
    quantity MINRES minimises)."""
    M = M or _identity
    eps = torch.tensor(1e-30, dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)

    def clamp(v):
        return torch.maximum(v, eps)

    r1 = b
    y = M(r1)
    beta1 = torch.sqrt(torch.clamp(torch.dot(r1, y), min=0.0))
    beta1s = torch.where(beta1 == 0.0, torch.ones_like(beta1), beta1)
    x = torch.zeros_like(b)
    w = torch.zeros_like(b)
    w2 = torch.zeros_like(b)
    r2 = r1
    oldb, beta, dbar, epsln, phibar = zero, beta1, zero, zero, beta1
    cs, sn = -torch.ones_like(zero), zero
    itn, resid = 0, 1.0
    while resid > tol and itn < maxiter:
        itn += 1
        v = (1.0 / clamp(beta)) * y
        y = A(v)
        if itn >= 2:
            y = y - (beta / clamp(oldb)) * r1
        alfa = torch.dot(v, y)
        y = y - (alfa / clamp(beta)) * r2
        r1, r2 = r2, y
        y = M(r2)
        oldb = beta
        beta = torch.sqrt(torch.clamp(torch.dot(r2, y), min=0.0))
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = clamp(torch.sqrt(gbar * gbar + beta * beta))
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = sn * phibar
        w1, w2 = w2, w
        w = (v - oldeps * w1 - delta * w2) / gamma
        x = x + phi * w
        resid = float(phibar / beta1s)
    return CGResult(x, itn, resid, resid <= tol, None)
