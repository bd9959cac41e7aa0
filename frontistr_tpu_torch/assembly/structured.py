"""Matrix-free operators for structured hex8 boxes (torch port of
``frontistr_tpu/assembly/structured.py``: ``StructuredHexOperator``,
``soa_from_blocks``, the dof-major ``StructuredHexOperatorD`` and
``StructuredHexOperatorConstD``, ``to_dof_major``/``from_dof_major``).

On a structured grid the element nodal values are strided slices of the
(nx+1, ny+1, nz+1, 3) node array, and the transpose accumulation is 8
overlapping slice-adds: no index gathers and no scatter.  The element
products run through kernel K2 (``ops/element_mv.py``) over the SoA
element matrices keT (24, 24, E), element axis last.

Orders (those of ``meshgen.box_hex8``): node (i, j, k) at
(i*(ny+1)+j)*(nz+1)+k, element (i, j, k) at (i*ny+j)*nz+k, corners in
``_OFFS`` order; row ``3*corner + dof`` of keT is that corner's dof.
The slice-adds run in place on views of one zero tensor; the JAX
package builds a new array per add.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from frontistr_tpu_torch.fem.isoparam import det_inv_small
from frontistr_tpu_torch.ops.element_mv import element_matvec_soa

_OFFS = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
         (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]


def soa_from_blocks(ke: torch.Tensor) -> torch.Tensor:
    """(E, m, m) -> contiguous (m, m, E), element axis last (no
    padding)."""
    return ke.permute(1, 2, 0).contiguous()


@dataclasses.dataclass
class StructuredHexOperator:
    nx: int
    ny: int
    nz: int
    keT: torch.Tensor          # (24, 24, E) SoA element matrices
    free_mask: torch.Tensor    # (n_dof,) 1.0 free / 0.0 fixed

    def _corners(self, grid: torch.Tensor):
        """The 8 corner views of a (nx+1, ny+1, nz+1, ...) node grid, each
        (nx, ny, nz, ...), in ``_OFFS`` order."""
        nx, ny, nz = self.nx, self.ny, self.nz
        return [grid[di:di + nx, dj:dj + ny, dk:dk + nz]
                for (di, dj, dk) in _OFFS]

    def _gather_stencil(self, x: torch.Tensor) -> torch.Tensor:
        """x (n_dof,) -> contiguous xeT (24, E) by strided slicing."""
        X = x.reshape(self.nx + 1, self.ny + 1, self.nz + 1, 3)
        xe = torch.stack([c.reshape(-1, 3) for c in self._corners(X)])
        return xe.transpose(1, 2).reshape(24, -1).contiguous()

    def _scatter_stencil(self, feT: torch.Tensor) -> torch.Tensor:
        """feT (24, E) -> y (n_dof,) by 8 overlapping slice-adds."""
        nx, ny, nz = self.nx, self.ny, self.nz
        fe = feT.reshape(8, 3, -1).transpose(1, 2)         # (8, E, 3)
        Y = feT.new_zeros((nx + 1, ny + 1, nz + 1, 3))
        for c, view in enumerate(self._corners(Y)):
            view += fe[c].reshape(nx, ny, nz, 3)
        return Y.reshape(-1)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        feT = element_matvec_soa(self.keT, self._gather_stencil(x))
        return self._scatter_stencil(feT)

    def apply_constrained(self, x: torch.Tensor) -> torch.Tensor:
        """P A P x + (I-P) x."""
        xm = x * self.free_mask
        return self.matvec(xm) * self.free_mask + x * (1.0 - self.free_mask)

    def diag_blocks(self) -> torch.Tensor:
        """(n_node, 3, 3) nodal diagonal blocks via the same slice-adds."""
        nx, ny, nz = self.nx, self.ny, self.nz
        Y = self.keT.new_zeros((nx + 1, ny + 1, nz + 1, 3, 3))
        for c, view in enumerate(self._corners(Y)):
            blk = self.keT[3 * c:3 * c + 3, 3 * c:3 * c + 3]    # (3, 3, E)
            view += blk.permute(2, 0, 1).reshape(nx, ny, nz, 3, 3)
        return Y.reshape(-1, 3, 3)

    def block_jacobi(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """Nodal 3x3 block-Jacobi over ``diag_blocks``, unmasked as in the
        JAX package; a zero block (no adjacent element) becomes the
        identity.  Inverted in closed form."""
        D = self.diag_blocks()
        zero = D.abs().sum(dim=(1, 2)) == 0.0
        D = D + zero[:, None, None] * torch.eye(3, dtype=D.dtype,
                                                device=D.device)
        _, Dinv = det_inv_small(D)

        def M(r: torch.Tensor) -> torch.Tensor:
            return torch.einsum("nij,nj->ni", Dinv,
                                r.reshape(-1, 3)).reshape(-1)
        return M


@dataclasses.dataclass
class StructuredHexOperatorD:
    """Dof-major variant (the JAX package's ``StructuredHexOperatorD``):
    vectors are laid out v[d * n_node + node], so the corner slices of
    the (3, nx+1, ny+1, nz+1) grid stack into xeT (24, E) with no
    transpose; rows of keT are corner-major (``3*corner + dof``).  The
    element products run through K2 (``ops/element_mv.py``);
    ``to_dof_major``/``from_dof_major`` convert node-major vectors."""
    nx: int
    ny: int
    nz: int
    keT: torch.Tensor          # (24, 24, E) SoA element matrices
    free_mask: torch.Tensor    # (n_dof,) dof-major, 1.0 free / 0.0 fixed

    def _corners(self, grid: torch.Tensor):
        """The 8 corner views of a (..., nx+1, ny+1, nz+1) node grid, each
        (..., nx, ny, nz), in ``_OFFS`` order."""
        nx, ny, nz = self.nx, self.ny, self.nz
        return [grid[..., di:di + nx, dj:dj + ny, dk:dk + nz]
                for (di, dj, dk) in _OFFS]

    def _gather_stencil(self, x: torch.Tensor) -> torch.Tensor:
        """x (n_dof,) dof-major -> contiguous xeT (24, E)."""
        X = x.reshape(3, self.nx + 1, self.ny + 1, self.nz + 1)
        return torch.cat([c.reshape(3, -1) for c in self._corners(X)])

    def _scatter_stencil(self, feT: torch.Tensor) -> torch.Tensor:
        """feT (24, E) -> y (n_dof,) dof-major by 8 slice-adds."""
        nx, ny, nz = self.nx, self.ny, self.nz
        Y = feT.new_zeros((3, nx + 1, ny + 1, nz + 1))
        for c, view in enumerate(self._corners(Y)):
            view += feT[3 * c:3 * c + 3].reshape(3, nx, ny, nz)
        return Y.reshape(-1)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        feT = element_matvec_soa(self.keT, self._gather_stencil(x))
        return self._scatter_stencil(feT)

    def apply_constrained(self, x: torch.Tensor) -> torch.Tensor:
        """P A P x + (I-P) x."""
        xm = x * self.free_mask
        return self.matvec(xm) * self.free_mask + x * (1.0 - self.free_mask)

    def diag_blocks(self) -> torch.Tensor:
        """(3, 3, nx+1, ny+1, nz+1) nodal diagonal blocks."""
        nx, ny, nz = self.nx, self.ny, self.nz
        Y = self.keT.new_zeros((3, 3, nx + 1, ny + 1, nz + 1))
        for c, view in enumerate(self._corners(Y)):
            view += self.keT[3 * c:3 * c + 3,
                             3 * c:3 * c + 3].reshape(3, 3, nx, ny, nz)
        return Y

    def block_jacobi(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """Nodal 3x3 block-Jacobi on dof-major vectors, unmasked as in the
        JAX package; a zero block becomes the identity.  Inverted in
        closed form."""
        D = self.diag_blocks().reshape(3, 3, -1).permute(2, 0, 1)
        zero = D.abs().sum(dim=(1, 2)) == 0.0
        D = D + zero[:, None, None] * torch.eye(3, dtype=D.dtype,
                                                device=D.device)
        _, Dinv = det_inv_small(D)

        def M(r: torch.Tensor) -> torch.Tensor:
            return torch.einsum("nij,jn->in", Dinv,
                                r.reshape(3, -1)).reshape(-1)
        return M


@dataclasses.dataclass
class StructuredHexOperatorConstD:
    """Uniform-grid variant of ``StructuredHexOperatorD``: every element of
    the box is the same cube, so one (24, 24) ``ke`` (corner-major rows
    and columns) applies to all corner slices as one matmul.  It is the
    exact K @ x of the uniform box in any dtype; the JAX package computes
    it as a plain matmul, outside any Pallas kernel."""
    nx: int
    ny: int
    nz: int
    ke: torch.Tensor           # (24, 24)
    free_mask: torch.Tensor    # (n_dof,) dof-major

    _corners = StructuredHexOperatorD._corners
    _gather_stencil = StructuredHexOperatorD._gather_stencil
    _scatter_stencil = StructuredHexOperatorD._scatter_stencil
    apply_constrained = StructuredHexOperatorD.apply_constrained

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._scatter_stencil(self.ke @ self._gather_stencil(x))


def to_dof_major(v: torch.Tensor, n_node: int, ndof: int = 3
                 ) -> torch.Tensor:
    """Node-major v[node * ndof + d] -> dof-major v[d * n_node + node]."""
    return v.reshape(n_node, ndof).t().reshape(-1)


def from_dof_major(v: torch.Tensor, n_node: int, ndof: int = 3
                   ) -> torch.Tensor:
    return v.reshape(ndof, n_node).t().reshape(-1)
