"""Preconditioned Krylov solvers (torch port of ``frontistr_tpu/solver/
cg.py``: ``pcg``, ``bicgstab``, ``gmres``, ``gpbicg`` and the dispatcher
``solve``; reference hecmw_solver_CG.f90, hecmw_solver_BiCGSTAB.f90,
hecmw_solver_GMRES.f90, hecmw_solver_GPBiCG.f90).

The JAX package runs each iteration as one ``lax.while_loop``; here it
is a Python loop over device tensors whose convergence test reads one
scalar per iteration (GMRES: per restart cycle).  The recurrences are
the JAX package's, so the iteration counts match.  Convergence:
||r||_2 / ||b||_2 <= tol.  ``solve`` picks the method of a deck's
``!SOLVER, METHOD=`` (CG, BICGSTAB, GMRES, GPBICG or the numeric ids
1-4); BiCGSTAB is also the solve of a nonsymmetric system: contact with
Coulomb friction, whose slip tangent is nonsymmetric.

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

from frontistr_tpu_torch.solver.direct import METHODS

GMRES_RESTART = 30      # the Krylov basis of a GMRES cycle


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
        maxiter: int = 10000, hist_len: int = 0,
        dot: Callable = torch.dot) -> CGResult:
    """Preconditioned CG (Fletcher-Reeves rho update, the recurrences of
    hecmw_solve_CG).  hist_len > 0 records the per-iteration relative
    residual for ITERLOG; unused slots hold -1, and iterations past the
    buffer overwrite its last slot, as in the JAX package.  ``dot`` is
    every inner product: a row-sharded solve (``parallel/shard.py``)
    passes the rank's partial sum all-reduced over the ranks."""
    M = M or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    bnrm2 = dot(b, b)
    bnrm2 = torch.where(bnrm2 == 0.0, torch.ones_like(bnrm2), bnrm2)
    r = b - A(x)
    p = M(r)
    rho = dot(r, p)
    hist = np.full(hist_len, -1.0, np.float32) if hist_len else None
    resid = float(torch.sqrt(dot(r, r) / bnrm2))
    k = 0
    while resid > tol and k < maxiter:
        q = A(p)
        alpha = rho / dot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        z = M(r)
        rho_new = dot(r, z)
        beta = rho_new / rho
        p = z + beta * p
        rho = rho_new
        resid = float(torch.sqrt(dot(r, r) / bnrm2))
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


def gmres(A: Callable, b: torch.Tensor, M: Optional[Callable] = None,
          x0: Optional[torch.Tensor] = None, tol: float = 1.0e-8,
          maxiter: int = 10000) -> CGResult:
    """Restarted GMRES(m), m = ``GMRES_RESTART``, right-preconditioned,
    the Arnoldi basis by
    modified Gram-Schmidt, the least-squares problem by Givens rotations
    and back substitution (hecmw_solver_GMRES.f90; the JAX package's
    ``gmres``).  Every cycle runs all m steps; ``iters`` counts m a
    cycle, as the JAX package does.  The (m+1, m) Hessenberg matrix is
    read to the host once a cycle, where the rotations run in float64."""
    M = M or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    n, m = b.shape[0], GMRES_RESTART
    bnrm = float(torch.sqrt(torch.dot(b, b)))
    bnrm = 1.0 if bnrm == 0.0 else bnrm

    def cycle(x):
        r = b - A(x)
        beta = torch.sqrt(torch.dot(r, r))
        V = b.new_zeros((m + 1, n))
        H = b.new_zeros((m + 1, m))
        V[0] = r / torch.where(beta == 0, torch.ones_like(beta), beta)
        for j in range(m):
            w = A(M(V[j]))
            for i in range(j + 1):
                hij = torch.dot(V[i], w)
                H[i, j] = hij
                w = w - hij * V[i]
            hj1 = torch.sqrt(torch.dot(w, w))
            H[j + 1, j] = hj1
            V[j + 1] = w / torch.where(hj1 == 0, torch.ones_like(hj1), hj1)
        Hr = H.cpu().numpy().astype(np.float64)
        g = np.zeros(m + 1)
        g[0] = float(beta)
        for j in range(m):
            a, bb = Hr[j, j], Hr[j + 1, j]
            rr = np.sqrt(a * a + bb * bb)
            c = 1.0 if rr == 0 else a / rr
            s = 0.0 if rr == 0 else bb / rr
            rj, rj1 = Hr[j].copy(), Hr[j + 1].copy()
            Hr[j] = c * rj + s * rj1
            Hr[j + 1] = -s * rj + c * rj1
            gj, gj1 = g[j], g[j + 1]
            g[j] = c * gj + s * gj1
            g[j + 1] = -s * gj + c * gj1
        y = np.zeros(m)
        for j in range(m - 1, -1, -1):
            d = 1.0 if Hr[j, j] == 0 else Hr[j, j]
            y[j] = (g[j] - np.dot(Hr[j, :m], y)) / d
        yt = torch.as_tensor(y, dtype=b.dtype, device=b.device)
        x_new = x + M(V[:m].T @ yt)
        r_new = b - A(x_new)
        return x_new, float(torch.sqrt(torch.dot(r_new, r_new))) / bnrm

    r0 = b - A(x)
    res = float(torch.sqrt(torch.dot(r0, r0))) / bnrm
    k = 0
    while res > tol and k < maxiter:
        x, res = cycle(x)
        k += m
    return CGResult(x, k, res, res <= tol)


def gpbicg(A: Callable, b: torch.Tensor, M: Optional[Callable] = None,
           x0: Optional[torch.Tensor] = None, tol: float = 1.0e-8,
           maxiter: int = 10000) -> CGResult:
    """GPBiCG (hecmw_solver_GPBiCG.f90; Zhang's recurrences, as the JAX
    package's ``gpbicg`` writes them but for one term: the update of u
    takes t_{k-1}, the previous t, where the JAX package takes t_{k-2}.
    With t_{k-2} the iterate drifts from the recurrence's residual: the
    JAX package's answer to a 240-dof tet box has a true relres of 34
    while its recurrence reports 6e-9 (ROADMAP, queue 3, fault 9)."""
    M = M or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    bnrm2 = torch.dot(b, b)
    bnrm2 = torch.where(bnrm2 == 0.0, torch.ones_like(bnrm2), bnrm2)
    r = b - A(x)
    rt = r
    zero = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)

    def safe(v):
        return torch.where(v == 0, one, v)

    t = w = p = u = z = zero
    rho = torch.dot(rt, r)
    beta = torch.zeros((), dtype=b.dtype, device=b.device)
    resid = float(torch.sqrt(torch.dot(r, r) / bnrm2))
    k = 0
    while resid > tol and k < maxiter:
        Mr = M(r)
        p = Mr + beta * (p - u)
        Ap = A(p)
        alpha = rho / torch.dot(rt, Ap)
        y = t - r - alpha * w + alpha * Ap
        t_new = r - alpha * Ap
        Att = A(M(t_new))
        ydy = torch.dot(y, y)
        zeta_num = torch.dot(Att, t_new)
        zeta_den = torch.dot(Att, Att)
        if k == 0:
            zeta = zeta_num / safe(zeta_den)
            eta = torch.zeros_like(zeta)
        else:
            # the general step: a 2 x 2 solve
            yt = torch.dot(y, t_new)
            ay = torch.dot(Att, y)
            det = safe(zeta_den * ydy - ay * ay)
            zeta = (ydy * zeta_num - yt * ay) / det
            eta = (zeta_den * yt - ay * zeta_num) / det
        u = zeta * M(Ap) + eta * (M(t) - Mr + beta * u)
        z = zeta * Mr + eta * z - alpha * u
        x = x + alpha * p + z
        r_new = t_new - eta * y - zeta * Att
        rho_new = torch.dot(rt, r_new)
        beta = (alpha / zeta) * (rho_new / safe(rho))
        w = Att + beta * Ap
        t = t_new
        r, rho = r_new, rho_new
        resid = float(torch.sqrt(torch.dot(r, r) / bnrm2))
        k += 1
    return CGResult(x, k, resid, resid <= tol)


SOLVERS = {
    "CG": pcg,
    "BICGSTAB": bicgstab,
    "GMRES": gmres,
    "GPBICG": gpbicg,
    # numeric codes as in hecmw Iarray(1) (hecmw_matrix_misc.f90 ids)
    "1": pcg,
    "2": bicgstab,
    "3": gmres,
    "4": gpbicg,
}


def solve(method: str, A, b, M=None, x0=None, tol=1.0e-8, maxiter=10000,
          hist_len: int = 0) -> CGResult:
    """The Krylov method a deck names (``SOLVERS``); the ITERLOG history
    (``hist_len``) is CG's only.  A direct method or any other name
    raises ``ValueError``, as in the JAX package."""
    method = method.upper()
    if method in METHODS:
        raise ValueError("direct solvers are dispatched in solver.direct")
    if method not in SOLVERS:
        raise ValueError(f"unknown solver METHOD={method!r}; "
                         f"expected one of {sorted(SOLVERS)}")
    fn = SOLVERS[method]
    kw = dict(hist_len=hist_len) if fn is pcg else {}
    return fn(A, b, M=M, x0=x0, tol=tol, maxiter=maxiter, **kw)
