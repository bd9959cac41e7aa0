"""Direct linear solves (!SOLVER METHOD=DIRECT, DIRECTMKL, MUMPS, MKL):
``assemble_csr`` and ``solve_direct`` copied from
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

# the direct methods; without contact DIRECTLAG is plain DIRECT too
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


def factor_constrained(A, free):
    """Factor P A P + (I - P) of the host CSR ``A`` and the free mask
    ``free`` (identity on free dofs with a zero row); returns
    ``solve(b, u_fix=None)``, the constrained solve with the Dirichlet
    values ``u_fix`` moved to the right-hand side, as a host array."""
    import scipy.sparse as sp
    free = host(free).astype(np.float64)
    Ac = sp.diags(free) @ A @ sp.diags(free) + sp.diags(1.0 - free)
    zero = Ac.diagonal() == 0.0
    if zero.any():
        Ac = Ac + sp.diags(zero.astype(float))
    lu = factor(Ac)

    def solve(b, u_fix=None):
        b = host(b)
        if u_fix is not None:
            u_fix = host(u_fix) * (1.0 - free)
            b = (b - A @ u_fix) * free + u_fix
        return lu.solve(b)
    return solve


def solve_direct(op, b, u_fix=None) -> np.ndarray:
    """The constrained direct solve of ``FEOperator.apply_constrained``'s
    system, P A P + (I - P), by SuperLU; ``b`` the load, ``u_fix`` the
    Dirichlet values (host arrays or tensors).  Returns a host array."""
    A = assemble_csr(op.kes, op.dofs, op.n_dof)
    return factor_constrained(A, op.free_mask)(b, u_fix)
