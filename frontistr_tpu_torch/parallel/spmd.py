"""An element-sharded linear(ized) Newton step (torch port of
``frontistr_tpu/parallel/spmd.py``, ``make_sharded_newton_step``).

The JAX package shards the element axis and the dof axis over a device
mesh and lets GSPMD insert the collectives.  Here each rank of the group
(``parallel/dist.py``) owns a contiguous range of the elements (padded to
a multiple of the ranks with zero-material elements, which add nothing)
and a range of the node rows (``shard.RowSplit``).  A product
all-gathers x, runs the rank's elements and all-reduces the partial
forces (the incidence gather-sum of the JAX package, split by
elements); the rank keeps its rows.  CG runs on the rows, its dots
all-reduced; the block-Jacobi diagonal is summed the same way once.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from frontistr_tpu_torch.assembly import femop
from frontistr_tpu_torch.assembly.bell import block_jacobi_apply
from frontistr_tpu_torch.elements.tables import get_table
from frontistr_tpu_torch.fem import solid
from frontistr_tpu_torch.parallel import dist
from frontistr_tpu_torch.parallel.shard import row_split
from frontistr_tpu_torch.solver.cg import pcg


def make_sharded_newton_step(etype: int, conn: np.ndarray, n_node: int,
                             ndof: int, D1: np.ndarray,
                             fixed_dofs: np.ndarray, cg_iters: int = 30,
                             tol: float = 1e-8,
                             comm: Optional[dist.Comm] = None):
    """``step(coords, f)``: assemble the element stiffness of the rank's
    elements, solve the constrained system by CG over the row-sharded
    dofs, return the whole displacement (the same on every rank).
    ``comm`` defaults to the current group (a group of one on the CPU
    outside one).  Returns (step, info)."""
    comm = comm or dist.current() or dist.single("cpu")
    dev = comm.device
    split = row_split(comm, n_node, ndof)
    table = get_table(etype)
    nn = table.nn
    E0 = conn.shape[0]
    per = -(-E0 // comm.size)
    e0, e1 = comm.rank * per, min((comm.rank + 1) * per, E0)
    conn_r = conn[e0:e1]
    # the padding elements of the last rank carry zero material: they
    # are left out, which adds the same nothing
    dofs = torch.as_tensor((conn_r[:, :, None] * ndof + np.arange(ndof))
                           .reshape(len(conn_r), nn * ndof), device=dev)
    D = torch.as_tensor(np.asarray(D1)[None], dtype=torch.float64,
                        device=dev)
    inc, _ = femop.build_incidence([conn_r], n_node)
    gather = (torch.as_tensor(inc, dtype=torch.int64, device=dev)[:, :, None]
              * ndof + torch.arange(ndof, device=dev))
    free = np.ones(n_node * ndof)
    free[np.asarray(fixed_dofs)] = 0.0
    free_t = torch.as_tensor(free, device=dev)
    conn_t = torch.as_tensor(conn_r, dtype=torch.int64, device=dev)

    def step(coords, f):
        coords = torch.as_tensor(np.asarray(coords), device=dev)
        ke = solid.stiffness_linear(table, coords[conn_t], D)
        op = femop.FEOperator(kes=[ke], dofs=[dofs], gather=gather,
                              n_node=n_node, ndof=ndof, free_mask=free_t)
        fm = split.own(free_t)

        def A(x):
            xm = split.gather(x * fm)
            y = split.own(comm.all_reduce_sum(op.matvec(xm)))
            return y * fm + x * (1.0 - fm)

        Mw = block_jacobi_apply(comm.all_reduce_sum(op.diag_blocks()),
                                free_t)

        def M(r):
            return split.own(Mw(split.embed(r)))

        b = split.own(torch.as_tensor(np.asarray(f), device=dev) * free_t)
        res = pcg(A, b, M=M, tol=tol, maxiter=cg_iters, dot=split.dot)
        return split.gather(res.x)

    return step, dict(n_tot=n_node * ndof, elements=(e0, e1),
                      rows=(split.n0, split.n1))
