"""Eigenvalue analysis: shift-invert Lanczos for K phi = lambda M phi
(torch port of ``frontistr_tpu/analysis/eigen.py``; reference
fstr_solve_lanczos, fistr1/src/analysis/dynamic/mode/fstr_EIG_lanczos.f90).

Each Lanczos step applies w = K^{-1}(M q) by a block-Jacobi PCG (tol
1e-10, maxiter NIER) on the matrix-free ``femop.FEOperator``, then
M-orthogonalises w against every kept vector by one modified Gram-Schmidt
pass, in the JAX package's order.  The basis is one preallocated
(m + 1, n) float64 tensor on the model's device; the step's two scalars
(alpha, beta) are read on the host, where the small tridiagonal
eigenproblem is solved (numpy ``eigh``, in place of the QL decomposition
of fstr_EIG_tridiag.f90:183-302).  The start vector is the JAX package's
own numpy draw, ``default_rng(0)``, masked to the active dofs.
Participation factors and effective masses as in
fstr_EIG_output.f90:44-86.

K keeps the zero-mass dofs: only Dirichlet dofs and the dofs of nodes no
element touches are pinned, and Lanczos runs in the M-seminorm over the
dofs that carry mass.  !EQUATION is eliminated inside each apply (the
reduced pencil T^T K T, T^T M T, every vector kept in range(T)).
METHOD=DIRECT factors the constrained K once on the host (SuperLU,
``solver/direct.py``), or with FRONTISTR_TPU_DIRECT=band on the device
(the band Cholesky of ``solver/band.py``), and back-substitutes at every
apply; with !EQUATION it takes the eliminated CG, as in the JAX package.
In a sharded run (``parallel/dist.py``) each shift-invert apply is the
row-sharded CG of ``shard.RowSolver`` (the rank's rows of K assembled by
K1 from its elements, block-Jacobi, full float64); the Lanczos vectors
stay whole on every rank; a direct method there raises
``NotImplementedError`` naming itself. So does !SPRING, which the JAX
package's eigen analysis leaves out of K without a word (ROADMAP, queue
3, fault 2).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

from frontistr_tpu_torch.analysis.dynamic import lumped_mass_vector
from frontistr_tpu_torch.analysis.static import compute_element_stiffness
from frontistr_tpu_torch.assembly import extras, femop
from frontistr_tpu_torch.assembly import operators as old_ops
from frontistr_tpu_torch.assembly.model import StructModel
from frontistr_tpu_torch.device import synchronize
from frontistr_tpu_torch.parallel import dist
from frontistr_tpu_torch.parallel import shard as shardmod
from frontistr_tpu_torch.solver import direct
from frontistr_tpu_torch.solver.band import BandCholesky
from frontistr_tpu_torch.solver.cg import pcg

F64 = torch.float64


@dataclasses.dataclass
class EigenResult:
    eigenvalues: np.ndarray       # (nget,)
    ang_freq: np.ndarray
    freq: np.ndarray
    eigenvectors: np.ndarray      # (n_dof, nget)
    partfactor: np.ndarray        # (nget, ndof)
    effmass: np.ndarray           # (nget, ndof)
    total_mass: float
    iters: int
    # one dict per shift-invert apply: "cg" iterations, "s" seconds
    history: List[dict] = dataclasses.field(default_factory=list)
    # the band factor's "factor_s", "band" (dofs), "nb" and "bytes"
    factor: dict = dataclasses.field(default_factory=dict)


def _check_request(model: StructModel) -> None:
    if dist.current() is not None and \
            model.cfg.solver.method.upper() in direct.METHODS:
        raise NotImplementedError("!SOLVER METHOD=DIRECT in EIGEN under "
                                  "FRONTISTR_TPU_SHARDS")
    if model.cfg.springs:
        raise NotImplementedError("!SPRING in eigen analysis")


def run_eigen(model: StructModel, log_path: Optional[str] = None,
              kes=None, log_append: bool = False) -> EigenResult:
    """Lowest !EIGEN NGET pairs on ``model.device``.  ``kes`` overrides
    the element stiffness (STATICEIGEN passes the tangent about the
    converged deformed state)."""
    _check_request(model)
    cfg = model.cfg
    ec = cfg.eigen
    nget = ec.nget if ec else 5
    tol = ec.tolerance if ec else 1e-8
    maxiter = ec.maxiter if ec else 60
    dev = model.device

    n = model.n_dof_total
    if kes is None:
        kes = compute_element_stiffness(model)
    gather = femop.incidence_gather(model, dev)
    free = old_ops.make_free_mask(n, model.fixed_dofs)
    mass = lumped_mass_vector(model, gather)
    mass_np = mass.cpu().numpy()
    # Lanczos runs in the M-seminorm over mass-carrying dofs; K however
    # must stay unconstrained on zero-mass dofs.  Only Dirichlet dofs and
    # dofs of nodes untouched by any element are pinned.
    used = np.zeros(model.n_node, bool)
    for b in model.blocks:
        used[np.unique(b.conn)] = True
    k_active = (free > 0) & np.repeat(used, model.ndof)
    active = k_active & (mass_np > 0)
    k_act = torch.as_tensor(k_active.astype(np.float64), device=dev)

    op = femop.FEOperator(
        kes=list(kes),
        dofs=[torch.as_tensor(b.dofs, dtype=torch.int64, device=dev)
              for b in model.blocks],
        gather=gather, n_node=model.n_node, ndof=model.ndof,
        free_mask=k_act)
    nier = cfg.solver.nier
    history: List[dict] = []
    # !EQUATION: the dependent-dof elimination inside the apply
    mpc = extras.mpc_arrays(model.mesh, model.ndof, n, dev)
    precond = extras.mpc_precond(mpc, op.block_jacobi())
    A = op.apply_constrained if mpc is None else \
        extras.mpc_wrap(mpc, op.apply_constrained)
    direct_solve = None
    band = None
    split = shardmod.current_split(model.n_node, model.ndof)
    if split is not None:
        # a sharded run: each K^{-1} (M q) by the rank's rows of K
        # assembled by K1 from its elements, block-Jacobi, full f64 (the
        # JAX package's eigen.py:103-118)
        row = shardmod.RowSolver(model, shardmod.local_model(model, split),
                                 split, k_act, False, {},
                                 policy="jacobi", select=True, tol=1e-10)
        zero = torch.zeros(n, dtype=torch.float64, device=dev)
    if cfg.solver.method.upper() in direct.METHODS and mpc is None:
        if os.environ.get("FRONTISTR_TPU_DIRECT", "").lower() == "band":
            # the band Cholesky of the constrained K on the device
            band = BandCholesky(op.kes, op.dofs, n,
                                k_active.astype(np.float64),
                                [b.conn for b in model.blocks],
                                model.n_node, device=dev)
        else:
            # METHOD=DIRECT: one host factor of the constrained K, back-
            # substituted at every apply (set_arrays_DirectSolver)
            direct_solve = direct.factor_constrained(
                direct.assemble_csr(op.kes, op.dofs, n), k_active)

    def shift_invert(q):
        """w = K^{-1} (M q) on the Dirichlet-constrained system."""
        t0 = time.perf_counter()
        b = (mass * q) * k_act
        if band is not None:
            x = band.solve(b)
            iters = 0
        elif direct_solve is not None:
            x = torch.as_tensor(direct_solve(b), device=dev)
            iters = 0
        elif split is not None:
            x, iters = row(kes, b, zero, 0.0), row.last_iters
        else:
            if mpc is not None:
                b = extras.mpc_Tt(mpc, b)
            res = pcg(A, b, M=precond, tol=1e-10, maxiter=nier)
            x, iters = res.x, res.iters
            if mpc is not None:
                x = extras.mpc_recover(mpc, x)
        x = x * k_act
        synchronize(dev)
        history.append(dict(cg=iters, s=time.perf_counter() - t0))
        return x

    # --- Lanczos with full reorthogonalization (M-inner product) ----------
    rng = np.random.default_rng(0)
    q = torch.as_tensor(active.astype(np.float64) * rng.standard_normal(n),
                        device=dev)
    if mpc is not None:
        # the start vector inside the constraint subspace range(T)
        q = extras.mpc_recover(mpc, q) * torch.as_tensor(
            active.astype(np.float64), device=dev)
    q = q / torch.sqrt(torch.dot(mass * q, q))
    m_iter = min(maxiter, int(active.sum()))
    V = torch.zeros((m_iter + 1, n), dtype=F64, device=dev)
    V[0] = q
    alphas: List[float] = []
    betas: List[float] = []
    it_used = m_iter
    for j in range(m_iter):
        w = shift_invert(V[j])
        a = float(torch.dot(mass * w, V[j]))
        w = w - a * V[j]
        if j > 0:
            w = w - betas[-1] * V[j - 1]
        # full M-reorthogonalization, one modified Gram-Schmidt pass
        for i in range(j + 1):
            w = w - torch.dot(mass * w, V[i]) * V[i]
        b = float(torch.sqrt(torch.dot(mass * w, w)))
        alphas.append(a)
        betas.append(b)
        # convergence check on the largest nget Ritz values of T
        if j + 1 >= nget:
            T = np.diag(alphas) + np.diag(betas[:-1], 1) + \
                np.diag(betas[:-1], -1)
            theta, S = np.linalg.eigh(T)
            idx = np.argsort(theta)[::-1][:nget]   # largest 1/lambda
            resid = np.abs(b * S[-1, idx])
            if np.all(resid < tol * np.maximum(np.abs(theta[idx]), 1e-30)) \
                    or b < 1e-14:
                it_used = j + 1
                break
        if b < 1e-14:
            it_used = j + 1
            break
        V[j + 1] = w / b

    T = np.diag(alphas) + np.diag(betas[:-1], 1) + np.diag(betas[:-1], -1)
    theta, S = np.linalg.eigh(T)
    order = np.argsort(theta)[::-1]
    theta = theta[order][:nget]
    S = S[:, order][:, :nget]
    lam = 1.0 / theta
    k = len(alphas)
    phi = (V[:k].T @ torch.as_tensor(S, device=dev)).cpu().numpy()

    ndof = model.ndof
    pf = np.zeros((nget, ndof))
    em = np.zeros((nget, ndof))
    mm = mass_np.reshape(model.n_node, ndof)
    for i in range(phi.shape[1]):
        p = phi[:, i].reshape(model.n_node, ndof)
        gm = float((mm * p * p).sum())
        for d in range(ndof):
            r = float((mm[:, d] * p[:, d]).sum())
            pf[i, d] = r / gm
            em[i, d] = r * r / gm

    total_mass = float(mass_np.sum() / min(ndof, 3))
    res = EigenResult(
        eigenvalues=lam, ang_freq=np.sqrt(np.abs(lam)),
        freq=np.sqrt(np.abs(lam)) / (2 * np.pi), eigenvectors=phi,
        partfactor=pf, effmass=em, total_mass=total_mass, iters=it_used,
        history=history, factor={} if band is None else band.stats())
    if log_path:
        write_eigen_log(log_path, res, ndof, append=log_append)
    return res


def write_eigen_log(path: str, res: EigenResult, ndof: int,
                    append: bool = False):
    """RESULT OF EIGEN VALUE ANALYSIS block (EGLIST format,
    fstr_EIG_output.f90)."""
    with open(path, "a" if append else "w") as f:
        f.write(" fstr_setup: OK\n \n")
        f.write("********************************\n")
        f.write("*RESULT OF EIGEN VALUE ANALYSIS*\n")
        f.write("********************************\n\n")
        f.write(f"NUMBER OF ITERATIONS = {res.iters:8d}\n")
        f.write(f"TOTAL MASS = {res.total_mass:12.4E}\n\n")
        f.write("                   ANGLE       FREQUENCY   "
                "PARTICIPATION FACTOR                EFFECTIVE MASS\n")
        f.write("  NO.  EIGENVALUE  FREQUENCY   (HZ)        "
                "X           Y           Z           X           Y"
                "           Z\n")
        f.write("  ---  ----------  ----------  ----------  ----------  "
                "----------  ----------  ----------  ----------  "
                "----------\n")
        for i in range(len(res.eigenvalues)):
            # a 2-D deck has no Z column: written as 0 (the JAX package's
            # writer fails there, ROADMAP queue 3)
            p = np.pad(res.partfactor[i][:3], (0, max(0, 3 - ndof)))
            e = np.pad(res.effmass[i][:3], (0, max(0, 3 - ndof)))
            f.write(f"{i+1:5d}  {res.eigenvalues[i]:10.4E}  "
                    f"{res.ang_freq[i]:10.4E}  {res.freq[i]:10.4E}  "
                    f"{p[0]:10.4E}  {p[1]:10.4E}  {p[2]:10.4E}  "
                    f"{e[0]:10.4E}  {e[1]:10.4E}  {e[2]:10.4E}\n")
