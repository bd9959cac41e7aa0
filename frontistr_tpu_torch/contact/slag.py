"""Exact-Lagrange (SLAGRANGE) contact by slave-dof elimination (torch port
of ``frontistr_tpu/contact/slag.py``; reference
solve_LINEQ_iter_contact.f90:115-500 choose_slaves / make_BTmat /
make_BTtmat, solve_LINEQ_direct_serial_lag.f90).

Each active slot (one per slave node) with unit outward normal n and
face shape values shp_k closes its gap exactly:

    n . u_s - sum_k shp_k (n . u_mk) = -gap

The dependent dof is the slave component with the largest |n_d| (the
pivot rule of choose_slaves); the other slave components and every
master-face dof are the constraint's masters.  ``ContactEliminator``
builds the slot tables on the host from a search (``build``) and applies
T, T^T, the wrapped operator T^T A T and the recovery on the device;
``lag_rows`` writes the same constraints as explicit Lagrange rows for
the host direct solve.

T^T adds every active slot's dependent row into its masters, and a face
node is a master of every slot that projects onto one of its faces.  On
the card a scatter-add by atomics would sum those terms in a different
order on each run; ``segsum.IndexAdd`` sums them through K1's planes
entry over a plan built with the slot tables, the target's own value
first and then the entries in slot order, so a relaunch is bit-equal.
The penalty arm's block product and force (``analysis/contact.py``) go
through the same plan type.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from frontistr_tpu_torch.assembly.segsum import IndexAdd


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass(eq=False)
class ContactSlots:
    """One search's constraint slots on the device (``build``)."""
    dep: torch.Tensor            # (Ns,) int64 dependent dof of each slot
    mast: torch.Tensor           # (Ns, MAXM) int64 masters, padded with 0
    coef: torch.Tensor           # (Ns, MAXM) float64 (0 on inactive slots)
    const: torch.Tensor          # (Ns,) -gap / c0 (0 on inactive slots)
    act: torch.Tensor            # (Ns,) float64 1.0 active / 0.0
    c0: torch.Tensor             # (Ns,) the pivot's normal component
    mask: torch.Tensor           # (n,) 0.0 on active dependent dofs
    g0: torch.Tensor             # (n,) const on the dependent dofs
    add: IndexAdd                # the reduction's plan over mast


class ContactEliminator:
    """Fixed-slot dynamic T K T^T eliminator for node-to-surface
    contact."""

    MAXM = 14 + 1   # 4 master nodes x 3 dofs + 2 slave dofs (+ pad)

    def __init__(self, n_dof_total: int, ndof: int, device):
        self.n = n_dof_total
        self.ndof = ndof
        self.device = torch.device(device)

    def build(self, proj, slave_nodes, active, free=None,
              dirichlet_inc=None) -> ContactSlots:
        """Host: the slot tables of a search projection and the active
        mask, moved to the device with the reduction's plan.

        With ``free`` (the free mask), a Dirichlet-fixed dof is no master
        of a slot: its term, coef times its prescribed increment
        ``dirichlet_inc`` (0 without), moves into the slot's constant.
        The JAX package keeps such terms, so T^T adds the dependent rows
        into fixed rows and the solve moves fixed dofs off their values
        as soon as a deformed face tilts (ROADMAP, queue 3, fault 6);
        without ``free`` the tables are the JAX package's."""
        nrm = proj["normal"]
        shp = proj["shape"]
        conn = proj["conn"]                # (Ns, 1 + 4) node idx
        gap = proj["gap"]
        Ns, width = conn.shape
        nd = self.ndof
        slave_nodes = np.asarray(slave_nodes, np.int64)
        rows = np.arange(Ns)
        dmax, dep, c0 = self._pivots(nrm, slave_nodes)
        mast = np.zeros((Ns, self.MAXM), np.int64)
        coef = np.zeros((Ns, self.MAXM))
        # the other slave components in dof order, then every face
        # node's dofs (the JAX package's slot layout)
        other = np.stack([np.delete(np.arange(nd), d) for d in range(nd)]
                         )[dmax]                        # (Ns, nd - 1)
        mast[:, :nd - 1] = slave_nodes[:, None] * nd + other
        coef[:, :nd - 1] = -nrm[rows[:, None], other] / c0[:, None]
        k = nd - 1
        for m in range(1, width):
            for d in range(nd):
                mast[:, k] = conn[:, m] * nd + d
                coef[:, k] = shp[:, m - 1] * nrm[:, d] / c0
                k += 1
        const = -gap / c0
        if free is not None:
            fixed = 1.0 - _host(free)[mast]
            if dirichlet_inc is not None:
                const = const + (coef * fixed *
                                 _host(dirichlet_inc)[mast]).sum(axis=1)
            coef = coef * (1.0 - fixed)
        act = np.asarray(active).astype(np.float64)
        mask = np.ones(self.n)
        np.add.at(mask, dep, -act)
        coef = coef * act[:, None]
        const = const * act
        g0 = np.zeros(self.n)
        np.add.at(g0, dep, const)

        def t(a, dtype=torch.float64):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        return ContactSlots(
            dep=t(dep, torch.int64), mast=t(mast, torch.int64),
            coef=t(coef), const=t(const), act=t(act), c0=t(c0),
            mask=t(mask), g0=t(g0),
            add=IndexAdd.build(mast, self.device, keep=coef != 0.0))

    def _pivots(self, nrm, slave_nodes):
        """Host: each slot's pivot component (the largest |n_d|, the
        rule of choose_slaves), its dependent dof and the pivot's normal
        component c0."""
        dmax = np.argmax(np.abs(nrm), axis=1)
        c0 = nrm[np.arange(len(nrm)), dmax]
        c0 = np.where(np.abs(c0) < 1e-12, 1.0, c0)
        return dmax, slave_nodes * self.ndof + dmax, c0

    def pressure(self, proj, slave_nodes, active,
                 B: torch.Tensor) -> torch.Tensor:
        """``lagrange`` of the slots that ``build(proj, slave_nodes,
        active)`` would make, from the pivots alone: no tables, no
        reduction plan."""
        _, dep, c0 = self._pivots(proj["normal"],
                                  np.asarray(slave_nodes, np.int64))
        act = np.asarray(active).astype(np.float64)
        return -B[torch.as_tensor(dep, device=self.device)] / \
            torch.as_tensor(c0, device=self.device) * \
            torch.as_tensor(act, device=self.device)

    # ---- device ops on the slots of ``build`` ----
    def dep_mask(self, cn: ContactSlots) -> torch.Tensor:
        return cn.mask

    def T(self, cn: ContactSlots, x: torch.Tensor) -> torch.Tensor:
        vals = (cn.coef * x[cn.mast]).sum(dim=1)
        return x.index_put((cn.dep,),
                           torch.where(cn.act > 0, vals, x[cn.dep]))

    def Tt(self, cn: ContactSlots, y: torch.Tensor) -> torch.Tensor:
        add = cn.coef * (y[cn.dep] * cn.act)[:, None]
        return cn.add(y, add) * cn.mask

    def g(self, cn: ContactSlots) -> torch.Tensor:
        return cn.g0

    def wrap(self, cn: ContactSlots, A):
        dm = cn.mask

        def apply(x):
            return self.Tt(cn, A(self.T(cn, x * dm))) + x * (1.0 - dm)
        return apply

    def recover(self, cn: ContactSlots, x: torch.Tensor) -> torch.Tensor:
        return self.T(cn, x * cn.mask) + cn.g0

    def reduce_rhs(self, cn: ContactSlots, A, b: torch.Tensor):
        return self.Tt(cn, b - A(cn.g0))

    def lagrange(self, cn: ContactSlots, B: torch.Tensor) -> torch.Tensor:
        """Contact pressure per slot from the unreduced residual at the
        dependent dof: the eliminated row carries -lambda * c0."""
        return -B[cn.dep] / cn.c0 * cn.act


def lag_rows(proj, slave_nodes, act, ndof, n_dof, free=None):
    """Host: the active contact constraints as explicit Lagrange rows
    B du = g for the direct saddle-point solve (make_BTmat's
    counterpart): per active slot +n on the slave dofs, -shp_k n on the
    master-face dofs, g = -gap; the columns of Dirichlet-fixed dofs are
    masked out by ``free``.  Returns (B scipy CSR, g)."""
    import scipy.sparse as sp
    nrm = proj["normal"]
    shp = proj["shape"]
    conn = proj["conn"]
    gap = proj["gap"]
    dim = nrm.shape[1]
    idx = np.nonzero(np.asarray(act))[0]
    rows, cols, vals, g = [], [], [], []
    for r, s in enumerate(idx):
        for d in range(dim):
            rows.append(r)
            cols.append(int(slave_nodes[s]) * ndof + d)
            vals.append(nrm[s, d])
        for m in range(1, conn.shape[1]):
            for d in range(dim):
                rows.append(r)
                cols.append(int(conn[s, m]) * ndof + d)
                vals.append(-shp[s, m - 1] * nrm[s, d])
        g.append(-gap[s])
    B = sp.coo_matrix((vals, (rows, cols)),
                      shape=(len(idx), n_dof)).tocsr()
    if free is not None:
        B = B.multiply(np.asarray(free)[None, :]).tocsr()
    return B, np.asarray(g, dtype=float)
