"""The linear solves of a contact Newton iteration (torch port of
``make_contact_solver``, ``contact_mpc_disjoint``,
``make_slag_contact_solver`` and ``make_saddle_contact_solver`` of
``frontistr_tpu/analysis/nonlinear.py``; reference
solve_LINEQ_contact.f90, solve_LINEQ_iter_contact.f90).

Every arm solves on the matrix-free ``femop.FEOperator`` (the model's
spring blocks appended; in a sharded run each rank's element rows, all-
gathered, ``shard.RowFEOperator``) preconditioned by its block Jacobi,
as the JAX package does; ``eff=(c1, c2)`` with the lumped ``mass`` takes
the Newmark effective matrix c1 K + c2 M instead of K.

- ``make_contact_solver``: the augmented-Lagrange / penalty arm, K plus
  the contact block of the search (added through ``IndexAdd``, in a
  fixed order), by CG, or by BiCGSTAB when a pair has friction (the
  Coulomb slip tangent is nonsymmetric); !EQUATION eliminated on the
  contact-extended operator.
- ``make_slag_contact_solver``: SLAGRANGE, the active slots eliminated
  (T_c^T A T_c, ``contact/slag.py``), !EQUATION composed inside when
  the two touch disjoint dofs (``contact_mpc_disjoint``), by CG.
- ``make_saddle_contact_solver``: the KKT saddle system with the slots
  (and the equations) as Lagrange rows, by MINRES; taken when
  FRONTISTR_TPU_CONTACT_SOLVE=saddle or when !EQUATION dofs overlap the
  contact surfaces.

The preconditioner of an eliminated system is the block Jacobi of the
whole operator restricted to the reduced space, P M P + (I - P), P the
mask of the eliminated dofs (``extras.restricted``): the deviation
``extras.mpc_precond`` makes for !EQUATION (ROADMAP, queue 3, fault
5).  Each solve records ``last_iters``, ``last_relres`` and
``last_passes`` (0) on itself.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from frontistr_tpu_torch.assembly import extras, femop
from frontistr_tpu_torch.assembly.segsum import IndexAdd
from frontistr_tpu_torch.contact.slag import ContactEliminator
from frontistr_tpu_torch.device import Phase
from frontistr_tpu_torch.parallel import shard as shardmod
from frontistr_tpu_torch.solver.cg import bicgstab, pcg
from frontistr_tpu_torch.solver.minres import minres


def _operator_parts(model, gather, mass, eff):
    """(operator(kes), mv(op, x)) of the model: the FE operator of the
    element tangents and the spring blocks, and its matvec, c1 K x +
    c2 m x under ``eff``.  In a sharded run the operator is the rank's
    ``shard.RowFEOperator``: its elements' rows, the rest all-gathered."""
    dev = model.device
    c1, c2 = eff if eff is not None else (1.0, 0.0)
    split = shardmod.current_split(model.n_node, model.ndof)
    if split is not None:
        operator = shardmod.row_operator(model, split)
    else:
        ex_kes, ex_dofs = extras.extra_tensors(model, dev)
        dofs = [torch.as_tensor(b.dofs, dtype=torch.int64, device=dev)
                for b in model.blocks] + ex_dofs

        def operator(kes, free):
            return femop.FEOperator(list(kes) + ex_kes, dofs, gather,
                                    model.n_node, model.ndof, free)

    def mv(op, x):
        y = op.matvec(x)
        if eff is not None:
            y = c1 * y + c2 * mass * x
        return y
    return operator, mv


def _block_jacobi(op, eff, mass):
    c1, c2 = eff if eff is not None else (1.0, 0.0)
    return op.block_jacobi(scale=c1,
                           diag_add=c2 * mass if eff is not None else None)


def _record(solve, res):
    solve.last_iters, solve.last_relres = int(res.iters), float(res.relres)


def make_contact_solver(model, free, gather, friction: bool = False,
                        eff=None, mass=None, mpc: bool = True,
                        timings: Optional[dict] = None):
    """The augmented-Lagrange / penalty arm: ``solve(kes, B,
    dirichlet_inc, cdofs, cke, add, gfac=0.0)`` solves

        P (K + K_c) P x + (I-P) x = (B - (K + K_c) d) P + d (I-P)

    d = dirichlet_inc, K_c the contact blocks ``cke`` (Ns, m, m) on
    ``cdofs`` (Ns, m) summed by ``add`` (an ``IndexAdd`` of
    ``cdofs``), with !EQUATION eliminated around it unless ``mpc`` is
    False (``solve.mpc`` holds the tables).  The contact tangent enters
    unscaled under ``eff``: it linearises the contact force of the
    residual, which carries no Rayleigh factor."""
    sv = model.cfg.solver
    dev = model.device
    timings = {} if timings is None else timings
    operator, mv = _operator_parts(model, gather, mass, eff)
    mpc_t = extras.mpc_arrays(model.mesh, model.ndof, model.n_dof_total,
                              dev) if mpc else None
    krylov = bicgstab if friction else pcg

    def solve(kes, B, dirichlet_inc, cdofs, cke, add, gfac=0.0):
        op = operator(kes, free)

        def A_raw(x):
            fe = torch.einsum("eij,ej->ei", cke, x[cdofs])
            return add(mv(op, x), fe)

        def A(x):
            return A_raw(x * free) * free + x * (1.0 - free)

        b_c = (B - A_raw(dirichlet_inc)) * free + \
            dirichlet_inc * (1.0 - free)
        A_k, M = A, _block_jacobi(op, eff, mass)
        if mpc_t is not None:
            b_c = extras.mpc_reduce_rhs(mpc_t, A, b_c, gfac)
            A_k = extras.mpc_wrap(mpc_t, A)
            M = extras.mpc_precond(mpc_t, M)
        with Phase(timings, "solve", dev):
            res = krylov(A_k, b_c, M=M, tol=sv.resid, maxiter=sv.nier)
        _record(solve, res)
        x = res.x
        return x if mpc_t is None else extras.mpc_recover(mpc_t, x, gfac)

    solve.mpc = mpc_t
    solve.last_iters, solve.last_passes = 0, 0
    solve.last_relres = float("nan")
    return solve


def contact_mpc_disjoint(cm, model) -> bool:
    """Host: do the contact constraints and the !EQUATION equations touch
    disjoint dofs?  The exact composition T_c^T T_m^T A T_m T_c of the
    SLAGRANGE arm needs it (the two transforms commute only then).
    Every slave-node dof and every candidate master-face-node dof counts
    as a contact dof, so the answer holds for any active set."""
    ndof = model.ndof
    mpc_t = extras.mpc_arrays(model.mesh, ndof, model.n_dof_total, "cpu")
    if mpc_t is None:
        return True
    cnodes = [np.asarray(cm.all_slaves)]
    for p in cm.pairs:
        f = np.asarray(p.faces).reshape(-1)
        cnodes.append(f[f >= 0])
    cnodes = np.unique(np.concatenate(cnodes))
    cdof = (cnodes[:, None] * ndof + np.arange(ndof)[None, :]).reshape(-1)
    # the tables' masters include their padding (dof 0), as the JAX
    # package's do
    mdof = np.unique(np.concatenate([mpc_t.dep.numpy(),
                                     mpc_t.mast.numpy().reshape(-1)]))
    return not np.intersect1d(cdof, mdof).size


def make_slag_contact_solver(model, free, gather, eff=None, mass=None,
                             mpc: bool = False,
                             timings: Optional[dict] = None):
    """The SLAGRANGE arm: ``solve(kes, B, dirichlet_inc, cn, gfac=0.0)``
    solves the eliminated system T_c^T A T_c (``cn`` the slots of
    ``ContactEliminator.build``), !EQUATION composed inside when
    ``mpc``, by CG.  Returns (solve, eliminator)."""
    sv = model.cfg.solver
    dev = model.device
    timings = {} if timings is None else timings
    elim = ContactEliminator(model.n_dof_total, model.ndof, dev)
    operator, mv = _operator_parts(model, gather, mass, eff)
    mpc_t = extras.mpc_arrays(model.mesh, model.ndof, model.n_dof_total,
                              dev) if mpc else None

    def solve(kes, B, dirichlet_inc, cn, gfac=0.0):
        op = operator(kes, free)

        def A0(x):
            return mv(op, x * free) * free + x * (1.0 - free)

        b_c = (B - mv(op, dirichlet_inc)) * free + \
            dirichlet_inc * (1.0 - free)
        A1, b1 = A0, b_c
        if mpc_t is not None:
            b1 = extras.mpc_reduce_rhs(mpc_t, A0, b_c, gfac)
            A1 = extras.mpc_wrap(mpc_t, A0)
        A = elim.wrap(cn, A1)
        b_r = elim.reduce_rhs(cn, A1, b1)
        M = extras.restricted(
            _block_jacobi(op, eff, mass),
            cn.mask if mpc_t is None else cn.mask * mpc_t.mask)
        with Phase(timings, "solve", dev):
            res = pcg(A, b_r, M=M, tol=sv.resid, maxiter=sv.nier)
        _record(solve, res)
        x = elim.recover(cn, res.x)
        return x if mpc_t is None else extras.mpc_recover(mpc_t, x, gfac)

    solve.mpc = mpc_t
    solve.last_iters, solve.last_passes = 0, 0
    solve.last_relres = float("nan")
    return solve, elim


def _rows_add(dep, mast, coef, device):
    """``IndexAdd`` of the rows' transpose: each row's dependent dof,
    then its masters with a nonzero coefficient (host arrays)."""
    dep, mast, coef = (np.asarray(a).reshape(-1) for a in (dep, mast, coef))
    return IndexAdd.build(np.concatenate([dep, mast]), device,
                          keep=np.concatenate([np.ones(dep.size, bool),
                                               coef != 0.0]))


def make_saddle_contact_solver(model, free, gather, eff=None, mass=None,
                               mpc: bool = False,
                               timings: Optional[dict] = None):
    """The no-elimination arm on the KKT saddle system (the reference's
    solve_no_eliminate, solve_LINEQ_iter_contact.f90:46-109):

        [ A    Bc^T  Bm^T ] [du]   [b  ]
        [ Bc   D_in       ] [lc] = [g_c]
        [ Bm              ] [lm]   [g_m]

    the contact rows from the eliminator's slots (row = act e_dep - coef
    at mast), the !EQUATION rows when ``mpc``, D_in = diag(1 - act) pins
    the multipliers of inactive slots to 0; MINRES with the
    block-diagonal SPD preconditioner (block Jacobi on the displacement
    block, the Schur diagonal sum_j B_ij^2 / diag(A)_j on the
    multipliers).  Same call as the SLAGRANGE arm's solve; records
    ``last_lambda`` too.  Returns (solve, eliminator)."""
    sv = model.cfg.solver
    dev = model.device
    n = model.n_dof_total
    nd = model.ndof
    timings = {} if timings is None else timings
    elim = ContactEliminator(n, nd, dev)
    operator, mv = _operator_parts(model, gather, mass, eff)
    c1, c2 = eff if eff is not None else (1.0, 0.0)
    mpc_t = extras.mpc_arrays(model.mesh, nd, n, dev) if mpc else None
    m_add = None if mpc_t is None else _rows_add(
        mpc_t.dep.cpu(), mpc_t.mast.cpu(), mpc_t.coef.cpu(), dev)

    def rows_T(add, dep, mast, coef, scale, lam):
        """sum over rows of lam_r (scale_r e_dep - coef_r at mast)."""
        vals = torch.cat([scale * lam, (-coef * lam[:, None]).reshape(-1)])
        return add(torch.zeros(n, dtype=lam.dtype, device=dev), vals) * free

    def solve(kes, B, dirichlet_inc, cn, gfac=0.0):
        op = operator(kes, free)

        def A0(x):
            return mv(op, x * free) * free + x * (1.0 - free)

        b_c = (B - mv(op, dirichlet_inc)) * free + \
            dirichlet_inc * (1.0 - free)
        act = cn.act
        Ns = act.shape[0]
        c_add = _rows_add(cn.dep.cpu(), cn.mast.cpu(), cn.coef.cpu(), dev)

        def Bc_of(x):
            xg = x * free
            return act * xg[cn.dep] - (cn.coef * xg[cn.mast]).sum(dim=1)

        def BcT(lam):
            return rows_T(c_add, cn.dep, cn.mast, cn.coef, act, lam)

        d = dirichlet_inc
        g_c = cn.const * gfac - (act * d[cn.dep] -
                                 (cn.coef * d[cn.mast]).sum(dim=1))
        if mpc_t is not None:
            cm_, dm_, mm_ = mpc_t.coef, mpc_t.dep, mpc_t.mast
            ones = torch.ones_like(mpc_t.const)

            def Bm_of(x):
                xg = x * free
                return xg[dm_] - (cm_ * xg[mm_]).sum(dim=1)

            def BmT(lam):
                return rows_T(m_add, dm_, mm_, cm_, ones, lam)

            g_m = mpc_t.const * gfac - (d[dm_] - (cm_ * d[mm_]).sum(dim=1))

        def A_sad(z):
            x, lc = z[:n], z[n:n + Ns]
            yx = A0(x) + BcT(lc)
            yc = Bc_of(x) + (1.0 - act) * lc
            if mpc_t is None:
                return torch.cat([yx, yc])
            lm = z[n + Ns:]
            return torch.cat([yx + BmT(lm), yc, Bm_of(x)])

        # the block-diagonal SPD preconditioner
        M_K = _block_jacobi(op, eff, mass)
        Db = op.diag_blocks() * c1
        ar = torch.arange(nd, device=dev)
        dk = Db[:, ar, ar].reshape(-1)
        if eff is not None:
            dk = dk + c2 * mass
        dk = torch.where((dk <= 0) | (free == 0.0), torch.ones_like(dk), dk)
        sc = (act * free[cn.dep]) / dk[cn.dep] + \
            (cn.coef ** 2 * free[cn.mast] / dk[cn.mast]).sum(dim=1)
        m_lc = 1.0 / (sc + (1.0 - act))
        parts = [b_c, g_c]
        if mpc_t is not None:
            sm = free[dm_] / dk[dm_] + \
                (cm_ ** 2 * free[mm_] / dk[mm_]).sum(dim=1)
            m_lm = 1.0 / torch.clamp(sm, min=1e-30)
            parts.append(g_m)

        def M_sad(r):
            zx, zc = M_K(r[:n]), m_lc * r[n:n + Ns]
            if mpc_t is None:
                return torch.cat([zx, zc])
            return torch.cat([zx, zc, m_lm * r[n + Ns:]])

        with Phase(timings, "solve", dev):
            res = minres(A_sad, torch.cat(parts), M=M_sad, tol=sv.resid,
                         maxiter=sv.nier)
        _record(solve, res)
        solve.last_lambda = res.x[n:]
        return res.x[:n]

    solve.mpc = mpc_t
    solve.last_iters, solve.last_passes = 0, 0
    solve.last_relres = float("nan")
    return solve, elim


def contact_arm(model, cm, slag_mpc: bool, direct_m: bool) -> str:
    """The arm of a contact deck: "saddle" (forced by
    FRONTISTR_TPU_CONTACT_SOLVE=saddle, or !EQUATION dofs overlapping the
    contact surfaces), "slag" (SLAGRANGE without friction) or "al" (the
    augmented-Lagrange / penalty arm)."""
    if cm.algo == "SLAGRANGE" and not cm.has_friction:
        if os.environ.get("FRONTISTR_TPU_CONTACT_SOLVE", "") == "saddle" \
                or (model.mesh.equations and not slag_mpc and not direct_m):
            return "saddle"
        return "slag"
    return "al"
