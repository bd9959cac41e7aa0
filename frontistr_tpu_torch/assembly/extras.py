"""Extra linear stiffness contributions: !SPRING and !EQUATION (MPC)
(torch port of ``frontistr_tpu/assembly/extras.py``).

- Springs (fstr_AddSPRING, fistr1/src/analysis/static/fstr_Spring.f90):
  one-node blocks with k on the (dof, dof) diagonal, host numpy on the
  model (``model.extras``), appended to the element blocks of the
  operators and profiles (``femop``, ``ell``, ``bell``).
- !EQUATION by dependent-dof elimination: u = T u_r + g, K_r = T^T K T,
  b_r = T^T (b - K g), the dependent dof being the equation's first
  (node, dof) (HEC-MW's T K T^t, hecmw_local_matrix.f90 trimatmul;
  fstr_Update_NDForce_MPC).  ``MPCEliminator`` holds the tables on one
  device; ``mpc_T``/``mpc_Tt``/``mpc_g``/``mpc_wrap``/``mpc_reduce_rhs``/
  ``mpc_recover`` are the JAX package's functions of the same names.

``mpc_Tt`` adds each dependent row into its masters.  On a rigid plate
thousands of dependents share one master, and a scatter-add by CUDA
atomics would sum them in a different order on each run.  So the sum
goes through K1's planes entry (``segsum.IndexAdd``) over a plan built
once: each master sums its own value first, then the dependents' terms
in equation order, the order of the JAX package's ``.at[].add``; a
relaunch on the card is bit-equal.

One deliberate deviation (ROADMAP, queue 3, fault 5): the JAX package
preconditions the eliminated system with the preconditioner of the
whole K, which couples the dependent rows (the identity of the reduced
operator) to the rest; CG then takes about nine times the iterations on
a tied plate (586 against 64 at 3,675 hex20 dofs).  ``mpc_precond``
restricts it to the reduced space, P M P + (I - P), and every analysis
solves with that.  The answer is the same to the solve's tolerance.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from frontistr_tpu_torch.assembly import segsum as segmod


def spring_blocks(mesh, cfg, ndof: int, grpid_filter=None):
    """[(conn (E, 1), ke (E, ndof, ndof))] of the !SPRING cards."""
    from frontistr_tpu_torch.assembly.model import _resolve_node_group
    out = []
    for c in cfg.springs:
        gid = c.iparam("GRPID", 1)
        if grpid_filter is not None and gid not in grpid_filter:
            continue
        for row in c.data:
            grp, d, val = row[0], int(float(row[1])), float(row[2])
            nodes = _resolve_node_group(mesh, grp)
            if len(nodes) == 0 or d > ndof:
                continue
            E = len(nodes)
            ke = np.zeros((E, ndof, ndof))
            ke[:, d - 1, d - 1] = val
            out.append((nodes.reshape(E, 1).astype(np.int32), ke))
    return out


def collect_extras(model, grpid_filter=None):
    """(conns, dofs, kes, nns) of the spring blocks, host numpy."""
    ndof = model.ndof
    conns, dofs, kes, nns = [], [], [], []
    for conn, ke in spring_blocks(model.mesh, model.cfg, ndof,
                                  grpid_filter):
        E, nn = conn.shape
        d = (conn[:, :, None] * ndof +
             np.arange(ndof)[None, None, :]).reshape(E, nn * ndof)
        conns.append(conn)
        dofs.append(d.astype(np.int32))
        kes.append(ke)
        nns.append(nn)
    return conns, dofs, kes, nns


def extra_tensors(model, device, dtype=torch.float64):
    """(kes, dofs) of ``model.extras`` as tensors on ``device``."""
    _, dofs, kes, _ = getattr(model, "extras", ([], [], [], []))
    return ([torch.as_tensor(k, dtype=dtype, device=device) for k in kes],
            [torch.as_tensor(d, dtype=torch.int64, device=device)
             for d in dofs])


@dataclasses.dataclass(eq=False)
class MPCEliminator:
    """!EQUATION elimination tables on one device (``mpc_arrays``)."""
    dep: torch.Tensor          # (K,) int64 dependent dof of each equation
    mast: torch.Tensor         # (K, maxm) int64 masters, padded with 0
    coef: torch.Tensor         # (K, maxm) float64, padded with 0
    const: torch.Tensor        # (K,) float64 const / c0
    mask: torch.Tensor         # (n,) float64: 0 on dependent dofs
    src_k: torch.Tensor        # (R,) int64 equation of each master term
    src_c: torch.Tensor        # (R,) float64 its coefficient
    add: segmod.IndexAdd       # the R terms into their masters


def mpc_arrays(mesh, ndof: int, n_dof_total: int, device):
    """The elimination tables of the mesh's !EQUATION cards on
    ``device`` (None without equations)."""
    deps, masters, coefs, consts = [], [], [], []
    for eq in mesh.equations:
        if len(eq.nodes) == 0:
            continue
        if int(np.max(eq.dofs)) > ndof:
            # e.g. structural-dof equations on a heat (ndof=1) run
            print("### WARNING: !EQUATION references dof "
                  f"{int(np.max(eq.dofs))} > ndof {ndof}; skipped")
            continue
        c0 = float(eq.coefs[0])
        deps.append(int(eq.nodes[0]) * ndof + int(eq.dofs[0]) - 1)
        masters.append([int(n) * ndof + int(d) - 1
                        for n, d in zip(eq.nodes[1:], eq.dofs[1:])])
        coefs.append([-float(c) / c0 for c in eq.coefs[1:]])
        consts.append(float(eq.const) / c0)
    if not deps:
        return None
    K = len(deps)
    maxm = max(1, max(len(m) for m in masters))
    m_arr = np.zeros((K, maxm), np.int64)
    c_arr = np.zeros((K, maxm))
    for k in range(K):
        m_arr[k, :len(masters[k])] = masters[k]
        c_arr[k, :len(coefs[k])] = coefs[k]
    mask = np.ones(n_dof_total)
    mask[np.asarray(deps)] = 0.0
    # the reduction: the master terms in (equation, term) order
    src_k = np.concatenate([np.full(len(m), k, np.int64)
                            for k, m in enumerate(masters)])
    src_m = np.concatenate([np.asarray(m, np.int64) for m in masters])
    src_c = np.concatenate([np.asarray(c, float) for c in coefs])

    def t(a, dtype=torch.float64):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return MPCEliminator(
        dep=t(deps, torch.int64), mast=t(m_arr, torch.int64), coef=t(c_arr),
        const=t(consts), mask=t(mask), src_k=t(src_k, torch.int64),
        src_c=t(src_c), add=segmod.IndexAdd.build(src_m, device))


def mpc_T(m: MPCEliminator, x: torch.Tensor) -> torch.Tensor:
    """Expand: set the dependent dofs from their masters (u = T u_r)."""
    vals = (m.coef.to(x.dtype) * x[m.mast]).sum(dim=1)
    return x.index_put((m.dep,), vals)


def mpc_Tt(m: MPCEliminator, y: torch.Tensor) -> torch.Tensor:
    """Reduce: add the dependent rows into their masters (through K1's
    planes entry, in a fixed order), zero the dependent rows."""
    if m.src_k.numel():
        y = m.add(y, m.src_c.to(y.dtype) * y[m.dep][m.src_k])
    return y * m.mask.to(y.dtype)


def mpc_g(m: MPCEliminator, x_like: torch.Tensor, factor) -> torch.Tensor:
    """The constant part g: const * factor on the dependent dofs."""
    return torch.zeros_like(x_like).index_put(
        (m.dep,), m.const.to(x_like.dtype) * factor)


def mpc_wrap(m: MPCEliminator, A):
    """A_r(x) = T^T A T (x masked) + identity on the dependent dofs."""
    if m is None:
        return A

    def apply(x):
        mask = m.mask.to(x.dtype)
        return mpc_Tt(m, A(mpc_T(m, x * mask))) + x * (1.0 - mask)
    return apply


def restricted(M, mask: torch.Tensor):
    """The preconditioner M restricted to the reduced space of an
    elimination, P M P + (I - P), P = diag(mask) (0 on the eliminated
    dofs)."""
    def apply(r):
        p = mask.to(r.dtype)
        return p * M(r * p) + r * (1.0 - p)
    return apply


def mpc_precond(m: MPCEliminator, M):
    """``restricted`` to the equations' reduced space (M without
    equations)."""
    return M if m is None else restricted(M, m.mask)


def mpc_reduce_rhs(m: MPCEliminator, A, b: torch.Tensor,
                   factor=0.0) -> torch.Tensor:
    return mpc_Tt(m, b - A(mpc_g(m, b, factor)))


def mpc_recover(m: MPCEliminator, x: torch.Tensor,
                factor=0.0) -> torch.Tensor:
    return mpc_T(m, x * m.mask.to(x.dtype)) + mpc_g(m, x, factor)
