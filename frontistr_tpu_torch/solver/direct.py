"""Direct linear solves (!SOLVER METHOD=DIRECT, DIRECTMKL, MUMPS, MKL,
DIRECTLAG): ``assemble_csr``, ``solve_direct`` and the contact arms
``solve_direct_lag`` and ``solve_direct_al`` copied from
``frontistr_tpu/solver/direct.py``.

The reference wraps three sparse factorisations (hecmw1/src/solver/
solver_direct* multifrontal LDL, MUMPS, ClusterMKL); the JAX package
answers all three with one host SuperLU (scipy) on the element blocks
assembled into CSR, on the TPU as everywhere.  The port keeps those
semantics: the element matrices are computed on the card, copied to the
host once for each factorisation, factored and back-substituted there,
and the solution returns to the model's device.  The factor is host
work by the JAX package's own design, not a way round the card.
"""

from __future__ import annotations

import numpy as np
import torch

# the direct methods; DIRECTLAG is plain DIRECT too, and every one of
# them takes the Lagrange rows on a SLAGRANGE contact deck
METHODS = ("DIRECT", "DIRECTMKL", "MUMPS", "MKL", "DIRECTLAG")


def host(a) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def assemble_csr(kes, dofs_list, n_dof):
    """Element blocks (E, m, m) with their dofs (E, m) -> scipy CSR."""
    import scipy.sparse as sp
    rows, cols, vals = [], [], []
    for ke, dofs in zip(kes, dofs_list):
        ke, dofs = host(ke), host(dofs)
        E, m, _ = ke.shape
        rows.append(np.repeat(dofs, m, axis=1).reshape(-1))
        cols.append(np.tile(dofs[:, None, :], (1, m, 1)).reshape(-1))
        vals.append(ke.reshape(-1))
    return sp.coo_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(n_dof, n_dof)).tocsr()


def factor(Ac):
    """SuperLU factor of a constrained CSR matrix."""
    import scipy.sparse.linalg as spla
    return spla.splu(Ac.tocsc())


def _constrained(A, free):
    """P A P + (I - P), identity on free dofs with a zero row."""
    import scipy.sparse as sp
    Ac = sp.diags(free) @ A @ sp.diags(free) + sp.diags(1.0 - free)
    zero = Ac.diagonal() == 0.0
    if zero.any():
        Ac = Ac + sp.diags(zero.astype(float))
    return Ac


def _moved_rhs(A, free, b, u_fix):
    """The constrained right-hand side with the Dirichlet values
    ``u_fix`` moved over (host arrays)."""
    b = host(b).astype(np.float64)
    if u_fix is None:
        return b
    u_fix = host(u_fix)
    return (b - A @ (u_fix * (1.0 - free))) * free + u_fix * (1.0 - free)


def factor_constrained(A, free):
    """Factor P A P + (I - P) of the host CSR ``A`` and the free mask
    ``free`` (identity on free dofs with a zero row); returns
    ``solve(b, u_fix=None)``, the constrained solve with the Dirichlet
    values ``u_fix`` moved to the right-hand side, as a host array."""
    free = host(free).astype(np.float64)
    lu = factor(_constrained(A, free))

    def solve(b, u_fix=None):
        return lu.solve(_moved_rhs(A, free, b, u_fix))
    return solve


def solve_direct(op, b, u_fix=None) -> np.ndarray:
    """The constrained direct solve of ``FEOperator.apply_constrained``'s
    system, P A P + (I - P), by SuperLU; ``b`` the load, ``u_fix`` the
    Dirichlet values (host arrays or tensors).  Returns a host array."""
    A = assemble_csr(op.kes, op.dofs, op.n_dof)
    return factor_constrained(A, op.free_mask)(b, u_fix)


def solve_direct_lag(kes, dofs_list, n_dof, free, b, Blag, g, u_fix=None):
    """The saddle-point direct solve with contact Lagrange rows
    (solve_LINEQ_direct_serial_lag.f90):

        [ Ac  B^T ] [du ]   [ b ]
        [ B    0  ] [lam] = [ g ]

    Ac the Dirichlet-constrained operator P A P + (I - P); the columns
    of fixed dofs in B already masked (``contact.slag.lag_rows``).
    All-zero rows (fully released or fully fixed slots) are dropped:
    they would make the system singular.  SuperLU raises
    ``RuntimeError`` on a singular factor.  Returns (du, lam), host
    arrays."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    A = assemble_csr(kes, dofs_list, n_dof)
    free = host(free).astype(np.float64)
    Ac = _constrained(A, free)
    b = _moved_rhs(A, free, b, u_fix)
    keep = np.diff(Blag.indptr) > 0
    if not keep.all():
        Blag, g = Blag[keep], g[keep]
    if Blag.shape[0] == 0:
        return spla.splu(Ac.tocsc()).solve(b), np.zeros(0)
    K = sp.bmat([[Ac, Blag.T], [Blag, None]], format="csc")
    sol = spla.splu(K).solve(np.concatenate([b, g]))
    return sol[:n_dof], sol[n_dof:]


def solve_direct_al(kes, dofs_list, n_dof, free, b, cdofs, cke,
                    u_fix=None) -> np.ndarray:
    """The direct solve with the augmented-Lagrange penalty blocks
    ``cke`` on ``cdofs`` assembled like extra elements (the reference's
    direct arm under ALAGRANGE).  Returns a host array."""
    A = assemble_csr(list(kes) + [cke], list(dofs_list) + [cdofs], n_dof)
    free = host(free).astype(np.float64)
    return factor(_constrained(A, free)).solve(
        _moved_rhs(A, free, b, u_fix))
