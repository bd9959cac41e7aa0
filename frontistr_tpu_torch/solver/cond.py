"""Condition-number estimate (the ESTCOND option of the reference's
iterative solvers, hecmw_solver_CG.f90:89 + hecmw_estimate_condition;
torch port of ``frontistr_tpu/solver/cond.py``).

A k-step Lanczos on the (preconditioned) operator M A, with the JAX
package's start vector (numpy ``default_rng(seed)``), its absolute 1e-14
breakdown test and its ratio of the extreme positive eigenvalues of the
tridiagonal T (numpy ``eigvalsh`` on the host).
"""

from __future__ import annotations

import numpy as np
import torch


def estimate_condition(A, n: int, M=None, k: int = 40, seed: int = 0,
                       device="cpu") -> float:
    """Extreme-eigenvalue ratio of (M A) by k-step Lanczos."""
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.standard_normal(n), device=device)
    q = q / torch.linalg.norm(q)
    op = (lambda x: M(A(x))) if M is not None else A
    alphas, betas = [], []
    q_prev = torch.zeros_like(q)
    beta = 0.0
    for _ in range(k):
        w = op(q)
        a = float(torch.dot(q, w))
        w = w - a * q - beta * q_prev
        beta_new = float(torch.linalg.norm(w))
        alphas.append(a)
        betas.append(beta_new)
        if beta_new < 1e-14:
            break
        q_prev = q
        q = w / beta_new
        beta = beta_new
    T = np.diag(alphas)
    if len(alphas) > 1:
        off = np.asarray(betas[:len(alphas) - 1])
        T += np.diag(off, 1) + np.diag(off, -1)
    ev = np.linalg.eigvalsh(T)
    ev = ev[ev > 0]
    if len(ev) == 0:
        return float("inf")
    return float(ev.max() / ev.min())
