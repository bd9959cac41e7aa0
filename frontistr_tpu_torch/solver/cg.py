"""Preconditioned conjugate gradients and BiCGSTAB (torch port of
``pcg`` and ``bicgstab`` in ``frontistr_tpu/solver/cg.py``; reference
hecmw_solver_CG.f90, hecmw_solver_BiCGSTAB.f90).

The JAX package runs each iteration as one ``lax.while_loop``; here it
is a Python loop over device tensors whose convergence test reads one
scalar per iteration.  The recurrences are the JAX package's, so the
iteration counts match.  Convergence: ||r||_2 / ||b||_2 <= tol.
BiCGSTAB is the solve of a nonsymmetric system: contact with Coulomb
friction, whose slip tangent is nonsymmetric.

One deviation from the JAX package: BiCGSTAB stops at a breakdown
(rho = (r~, r) falls to 0 when the residual stagnates near the rounding
floor, and the next iterate is NaN) and returns its last finite iterate,
not converged.  The JAX package carries the NaN on into the Newton
update, and the substep fails (ROADMAP, queue 3, fault 7).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    relres: float
    converged: bool
    hist: Optional[np.ndarray] = None   # (hist_len,) per-iter relres


def _identity(r):
    return r


def pcg(A: Callable, b: torch.Tensor, M: Optional[Callable] = None,
        x0: Optional[torch.Tensor] = None, tol: float = 1.0e-8,
        maxiter: int = 10000, hist_len: int = 0) -> CGResult:
    """Preconditioned CG (Fletcher-Reeves rho update, the recurrences of
    hecmw_solve_CG).  hist_len > 0 records the per-iteration relative
    residual for ITERLOG; unused slots hold -1, and iterations past the
    buffer overwrite its last slot, as in the JAX package."""
    M = M or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    bnrm2 = torch.dot(b, b)
    bnrm2 = torch.where(bnrm2 == 0.0, torch.ones_like(bnrm2), bnrm2)
    r = b - A(x)
    p = M(r)
    rho = torch.dot(r, p)
    hist = np.full(hist_len, -1.0, np.float32) if hist_len else None
    resid = float(torch.sqrt(torch.dot(r, r) / bnrm2))
    k = 0
    while resid > tol and k < maxiter:
        q = A(p)
        alpha = rho / torch.dot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        z = M(r)
        rho_new = torch.dot(r, z)
        beta = rho_new / rho
        p = z + beta * p
        rho = rho_new
        resid = float(torch.sqrt(torch.dot(r, r) / bnrm2))
        if hist is not None:
            hist[min(k, hist_len - 1)] = resid
        k += 1
    return CGResult(x, k, resid, resid <= tol, hist)


def bicgstab(A: Callable, b: torch.Tensor, M: Optional[Callable] = None,
             x0: Optional[torch.Tensor] = None, tol: float = 1.0e-8,
             maxiter: int = 10000) -> CGResult:
    """Right-preconditioned BiCGSTAB (the recurrences of
    hecmw_solver_BiCGSTAB.f90 and the JAX package's ``bicgstab``)."""
    M = M or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    bnrm2 = torch.dot(b, b)
    bnrm2 = torch.where(bnrm2 == 0.0, torch.ones_like(bnrm2), bnrm2)
    r = b - A(x)
    rt = r
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho, alpha, omega = one, one, one
    resid = float(torch.sqrt(torch.dot(r, r) / bnrm2))
    k = 0
    while resid > tol and k < maxiter:
        rho_new = torch.dot(rt, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        ph = M(p)
        v = A(ph)
        alpha = rho_new / torch.dot(rt, v)
        s = r - alpha * v
        sh = M(s)
        t = A(sh)
        omega = torch.dot(t, s) / torch.dot(t, t)
        x_new = x + alpha * ph + omega * sh
        r = s - omega * t
        rho = rho_new
        resid_new = float(torch.sqrt(torch.dot(r, r) / bnrm2))
        if not np.isfinite(resid_new):
            return CGResult(x, k, resid, False)
        x, resid = x_new, resid_new
        k += 1
    return CGResult(x, k, resid, resid <= tol)
