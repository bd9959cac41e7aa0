"""Mixed-precision solve: f32 CG iterations + f64 iterative refinement
(torch port of ``frontistr_tpu/solver/mixed.py``).

    repeat:  r = b - A_f64 x          (one f64 operator apply per pass)
             d = CG_f32(A_f32, r)     (hot loop entirely f32)
             x = x + d

Each pass recovers ~6-7 digits, so few passes reach FrontISTR's 1e-8
relative residual while the Krylov loop runs in float32.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from frontistr_tpu_torch.solver.cg import pcg


class RefinedResult(NamedTuple):
    x: torch.Tensor
    iters: int
    relres: float
    converged: bool
    passes: int
    hist: Optional[np.ndarray] = None   # (passes, hist_len) inner relres


def _rel(r: torch.Tensor, bnrm: torch.Tensor,
         dot: Callable = torch.dot) -> torch.Tensor:
    return torch.sqrt(dot(r, r)) / bnrm


def refined_cg(A64: Callable, A32: Callable, M32: Callable,
               b: torch.Tensor, tol: float = 1e-10,
               inner_tol: float = 1e-6, maxiter: int = 10000,
               max_passes: int = 4, hist_len: int = 0,
               x0: Optional[torch.Tensor] = None,
               dot: Callable = torch.dot) -> RefinedResult:
    """Iteratively-refined CG.  b is f64; returns the f64 solution with
    the TRUE residual ||b - A64 x|| / ||b|| <= tol (or max_passes).
    ``dot`` is every inner product (``pcg``'s hook)."""
    x = torch.zeros_like(b) if x0 is None else x0
    bnrm = torch.sqrt(dot(b, b))
    bnrm = torch.where(bnrm == 0, torch.ones_like(bnrm), bnrm)

    if hist_len:
        # fixed pass count keeps the per-pass history (ITERLOG)
        total_iters = 0
        hists = []
        for p in range(max_passes):
            r = b if (p == 0 and x0 is None) else b - A64(x)
            res = pcg(A32, r.to(torch.float32), M=M32, tol=inner_tol,
                      maxiter=maxiter, hist_len=hist_len, dot=dot)
            x = x + res.x.to(b.dtype)
            total_iters += res.iters
            hists.append(res.hist)
        relres = float(_rel(b - A64(x), bnrm, dot))
        return RefinedResult(x, total_iters, relres, relres <= tol,
                             max_passes, np.stack(hists))

    # adaptive: refine until the true f64 residual meets tol
    r = b if x0 is None else b - A64(x)
    relres = float(_rel(r, bnrm, dot))
    total_iters = 0
    passes = 0
    while relres > tol and passes < max_passes:
        res = pcg(A32, r.to(torch.float32), M=M32, tol=inner_tol,
                  maxiter=maxiter, dot=dot)
        x = x + res.x.to(b.dtype)
        r = b - A64(x)
        relres = float(_rel(r, bnrm, dot))
        total_iters += res.iters
        passes += 1
    return RefinedResult(x, total_iters, relres, relres <= tol, passes,
                         None)
