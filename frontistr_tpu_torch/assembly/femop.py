"""Matrix-free global FE operator (torch port of
``frontistr_tpu/assembly/femop.py``: ``build_incidence``, ``FEOperator``
with its nodal diagonal blocks and block-Jacobi preconditioner).

y = incidence gather-sum of f_e = k_e x_e: one batched element product,
then, per node, the sum of the element-node force rows that touch it
(the dual of the connectivity plays the role of HEC-MW's CSR profile,
hecmw1/src/solver/matrix/hecmw_mat_con.f90).  Deterministic and
scatter-free.  The mixed-precision solve takes its true f64 residuals
from this operator.  The JAX package's unrolled double-float arm
(a TPU workaround for emulated f64) is not ported: the product runs in
native float64, and the block-Jacobi inverse is a batched
``torch.linalg.inv`` where the JAX package keeps a closed-form 3 x 3
inverse (a TPU workaround: no float64 LAPACK there); the 6 x 6 blocks of
shells and beams take the JAX package's Gauss-Jordan steps.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from frontistr_tpu_torch.assembly import ell
from frontistr_tpu_torch.assembly import operators as old_ops
from frontistr_tpu_torch.fem.isoparam import gauss_jordan_inv


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
        return gather_sum([torch.einsum("eij,ej->ei", ke, x[dofs])
                           for ke, dofs in zip(self.kes, self.dofs)],
                          self.gather)

    def apply_constrained(self, x: torch.Tensor) -> torch.Tensor:
        """P A P x + (I-P) x — projection equivalent of hecmw_mat_ass_bc."""
        xm = x * self.free_mask
        y = self.matvec(xm)
        return y * self.free_mask + x * (1.0 - self.free_mask)

    def constrained_rhs(self, f: torch.Tensor, u_fix: torch.Tensor):
        y = self.matvec(u_fix)
        return (f - y) * self.free_mask + u_fix * (1.0 - self.free_mask)

    def diag_blocks(self) -> torch.Tensor:
        """Nodal (ndof x ndof) diagonal blocks through the incidence:
        (n_node, ndof, ndof)."""
        nd = self.ndof
        flats = []
        for ke in self.kes:
            E, m, _ = ke.shape
            kr = ke.reshape(E, m // nd, nd, m // nd, nd)
            # (E, nd, nd, nn) -> (E, nn, nd, nd)
            kd = torch.diagonal(kr, dim1=1, dim2=3).permute(0, 3, 1, 2)
            flats.append(kd.reshape(-1, nd, nd))
        flats.append(self.kes[0].new_zeros((1, nd, nd)))    # the pad slot
        inc = self.gather[:, :, 0] // nd
        return torch.cat(flats)[inc].sum(dim=1)

    def block_jacobi(self, scale=1.0, diag_add=None):
        """DIAG preconditioner: the inverse nodal blocks of
        ``scale * D + diag(diag_add)`` (the Newmark effective diagonal
        c1 D + c2 m of fstr_dynamic_nlimplicit.f90; ``diag_add`` a
        per-dof vector), restricted to the free dofs, identity where a
        diagonal entry is zero (fixed and unused dofs).  Returns
        ``apply(r)``."""
        nd, nn = self.ndof, self.n_node
        D = self.diag_blocks() * scale
        ar = torch.arange(nd, device=D.device)
        if diag_add is not None:
            D[:, ar, ar] += diag_add.reshape(nn, nd)
        fm = self.free_mask.reshape(nn, nd)
        D = D * (fm[:, :, None] * fm[:, None, :])
        dd = D[:, ar, ar]
        D[:, ar, ar] = dd + (dd == 0.0).to(D.dtype)
        # 6 x 6 blocks by Gauss-Jordan, as in the JAX package
        Dinv = gauss_jordan_inv(D) if nd > 3 else torch.linalg.inv(D)

        def apply(r):
            return torch.einsum("nij,nj->ni", Dinv,
                                r.reshape(nn, nd)).reshape(-1)

        return apply


def gather_sum(rows, gather: torch.Tensor) -> torch.Tensor:
    """Per-block element rows (E, nn*ndof) summed per node through the
    incidence ``gather``: the global (n_node*ndof,) vector."""
    flat = torch.cat([r.reshape(-1) for r in rows]
                     + [rows[0].new_zeros(gather.shape[2])])  # the pad slot
    return flat[gather].sum(dim=1).reshape(-1)


def incidence_gather(model, device) -> torch.Tensor:
    """(n_node, maxinc, ndof) int64 indices into the concatenated element
    force rows, the spring blocks of ``model.extras`` after the element
    blocks (plus one zero row at the end): a node's force is the sum
    over its incidences."""
    inc, _ = build_incidence(ell.model_conns(model), model.n_node)
    nd = model.ndof
    return (torch.as_tensor(inc, dtype=torch.int64, device=device)[:, :, None]
            * nd + torch.arange(nd, device=device))


def from_model(model, kes) -> FEOperator:
    """Build the operator from a StructModel + per-block element matrices
    (on the matrices' device and dtype), the model's spring blocks
    appended."""
    from frontistr_tpu_torch.assembly.extras import extra_tensors
    dev, dt = kes[0].device, kes[0].dtype
    nd = model.ndof
    ex_kes, ex_dofs = extra_tensors(model, dev, dt)
    free = old_ops.make_free_mask(model.n_dof_total, model.fixed_dofs)
    return FEOperator(
        kes=list(kes) + ex_kes,
        dofs=[torch.as_tensor(b.dofs, dtype=torch.int64, device=dev)
              for b in model.blocks] + ex_dofs,
        gather=incidence_gather(model, dev), n_node=model.n_node, ndof=nd,
        free_mask=torch.as_tensor(free, dtype=dt, device=dev))
