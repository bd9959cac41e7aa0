"""Matrix-free global FE operator (torch port of
``frontistr_tpu/assembly/femop.py``: ``build_incidence``, ``FEOperator``).

y = incidence gather-sum of f_e = k_e x_e: one batched element product,
then, per node, the sum of the element-node force rows that touch it
(the dual of the connectivity plays the role of HEC-MW's CSR profile,
hecmw1/src/solver/matrix/hecmw_mat_con.f90).  Deterministic and
scatter-free.  The mixed-precision solve takes its true f64 residuals
from this operator.  The JAX package's unrolled double-float arm
(a TPU workaround for emulated f64) is not ported: the product runs in
native float64.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from frontistr_tpu_torch.assembly import operators as old_ops


def build_incidence(conns: Sequence[np.ndarray], n_node: int):
    """Dual connectivity: for each node, indices into the concatenated
    element-node axis (sum_b E_b * nn_b), padded with ``total_en`` (which
    points at an appended zero row).

    Returns (inc (n_node, maxinc) int32, total_en)."""
    total_en = sum(c.shape[0] * c.shape[1] for c in conns)
    nodes_all = np.concatenate([c.reshape(-1) for c in conns])
    en_idx = np.arange(total_en, dtype=np.int64)
    order = np.argsort(nodes_all, kind="stable")
    sorted_nodes = nodes_all[order]
    sorted_en = en_idx[order]
    counts = np.bincount(sorted_nodes, minlength=n_node)
    maxinc = int(counts.max()) if len(counts) else 1
    inc = np.full((n_node, maxinc), total_en, dtype=np.int64)
    starts = np.zeros(n_node + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    pos_in_node = np.arange(len(sorted_en)) - starts[sorted_nodes]
    inc[sorted_nodes, pos_in_node] = sorted_en
    return inc.astype(np.int32), total_en


@dataclasses.dataclass
class FEOperator:
    """Constrained global stiffness operator over element-type blocks."""
    kes: List[torch.Tensor]         # per block (E, m, m)
    dofs: List[torch.Tensor]        # per block (E, m) int64
    gather: torch.Tensor            # (n_node, maxinc, ndof) int64
    n_node: int
    ndof: int
    free_mask: torch.Tensor         # (n_dof,) 1.0 free / 0.0 fixed

    @property
    def n_dof(self) -> int:
        return self.n_node * self.ndof

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        fes = [torch.einsum("eij,ej->ei", ke, x[dofs]).reshape(-1)
               for ke, dofs in zip(self.kes, self.dofs)]
        fes.append(x.new_zeros(self.ndof))      # the pad slot
        flat = torch.cat(fes)
        return flat[self.gather].sum(dim=1).reshape(-1)

    def apply_constrained(self, x: torch.Tensor) -> torch.Tensor:
        """P A P x + (I-P) x — projection equivalent of hecmw_mat_ass_bc."""
        xm = x * self.free_mask
        y = self.matvec(xm)
        return y * self.free_mask + x * (1.0 - self.free_mask)

    def constrained_rhs(self, f: torch.Tensor, u_fix: torch.Tensor):
        y = self.matvec(u_fix)
        return (f - y) * self.free_mask + u_fix * (1.0 - self.free_mask)


def from_model(model, kes) -> FEOperator:
    """Build the operator from a StructModel + per-block element matrices
    (on the matrices' device and dtype)."""
    conns = [b.conn for b in model.blocks]
    inc, _ = build_incidence(conns, model.n_node)
    dev, dt = kes[0].device, kes[0].dtype
    nd = model.ndof
    gather = (torch.as_tensor(inc, dtype=torch.int64, device=dev)[:, :, None]
              * nd + torch.arange(nd, device=dev))
    free = old_ops.make_free_mask(model.n_dof_total, model.fixed_dofs)
    return FEOperator(
        kes=list(kes),
        dofs=[torch.as_tensor(b.dofs, dtype=torch.int64, device=dev)
              for b in model.blocks],
        gather=gather, n_node=model.n_node, ndof=nd,
        free_mask=torch.as_tensor(free, dtype=dt, device=dev))
