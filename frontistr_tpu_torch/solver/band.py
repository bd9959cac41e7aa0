"""Direct factorisation on the device: a blocked band Cholesky (the
port's counterpart of ``frontistr_tpu/solver/band.py`` ``BandCholesky``,
``FRONTISTR_TPU_DIRECT=band``).

It factors once and solves many times: the shift-invert K of EIGEN's
Lanczos and the effective matrix c1 K + c2 M of implicit dynamics with
METHOD=DIRECT.  The semantics are the JAX package's: the constrained
system P A P + (I - P) (a unit diagonal on fixed dofs and on free dofs
whose diagonal is 0), ``scale`` and ``diag_add`` giving
A = scale K + diag(diag_add), nodes in a host RCM order (the port's
``ordering.rcm_order``) expanded to dofs, nb x nb blocks
(``FRONTISTR_TPU_BAND_NB``, default 32).

Layout: after the dof permutation A has half bandwidth b; it is stored
block-banded, Ablk[k, l] = A[block k, block k - l] (l = 0 .. B-1,
B = b // nb + 2), with B block rows of zero padding at the end.  The
host builds Ablk straight from the element entries (lower triangle, in
the JAX package's entry order, so the layout comes out with its bits)
and moves it to the device once.

The factor is right-looking, one block row k at a time on the device:

    L_kk = chol(A_kk)                       torch.linalg.cholesky_ex
    [L_(k+1)k; ..; L_(k+B-1)k] = panel L_kk^-T
                                            one triangular solve of the
                                            (B-1) nb x nb panel
    A_(k+j)(k+i) -= L_(k+j)k L_(k+i)k^T     one product panel panel^T,
                                            its lower blocks subtracted
                                            from the band (1 <= i <= j)

The JAX package unrolls the B^2/2 block products of each row into its
loop body and inverts its diagonal blocks by Gauss-Jordan (the TPU has
no float64 LAPACK); here they go to ``torch.linalg.cholesky_ex`` and
``torch.linalg.solve_triangular``.  The factor is then laid out for the
sweeps: each block row's B-1 off-diagonal blocks side by side (Lrow)
and the inverse diagonal blocks from one batched triangular solve.  A
solve is two sweeps over the nblk block rows, forward row by row and
backward column by column, each block row one matrix-vector product
with its off-diagonal blocks and one with its inverse diagonal block;
on the card the sweeps' kernels are captured once in a CUDA graph and
replayed for every right-hand side.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from frontistr_tpu_torch.ordering import rcm_order
from frontistr_tpu_torch.solver.direct import host

DEFAULT_NB = 32


def band_layout(kes, dofs_list, perm, free, n_dof: int, nb: int,
                scale: float = 1.0, diag_add=None):
    """The constrained A in the block-band layout, on the host:
    (Ablk (nblk + B, B, nb, nb), B, nblk).  ``perm`` maps a dof to its
    place in the band order.  Ablk[k, l, a, c] = A[k nb + a, (k - l) nb
    + c]; the entries are summed in the JAX package's order (element by
    element, each element's rows in order), a diagonal of fixed and of
    zero free dofs set to 1."""
    free = np.asarray(free, float)
    b = 0
    pd_list = []
    for dofs in dofs_list:
        pd = perm[host(dofs)]
        pd_list.append(pd)
        b = max(b, int((pd.max(axis=1) - pd.min(axis=1)).max()))
    B = b // nb + 2
    nblk = -(-n_dof // nb)
    npad = nblk * nb
    fp = np.ones(npad)
    fp[perm] = free            # the free mask in band order
    fp[n_dof:] = 0.0
    flat = np.zeros((nblk + B) * B * nb * nb)

    def at(r, c):
        # flat offset of A[r, c] (r >= c) in Ablk
        k, a = r // nb, r % nb
        return ((k * B + (k - c // nb)) * nb + a) * nb + c % nb

    for ke, pd in zip(kes, pd_list):
        kv = host(ke).astype(np.float64) * scale
        E, m, _ = kv.shape
        r = np.repeat(pd, m, axis=1).reshape(-1)
        c = np.tile(pd[:, None, :], (1, m, 1)).reshape(-1)
        v = kv.reshape(-1) * fp[r] * fp[c]
        keep = r >= c
        np.add.at(flat, at(r[keep], c[keep]), v[keep])
    diag = at(np.arange(npad), np.arange(npad))
    if diag_add is not None:           # A = scale K + diag(diag_add)
        flat[diag[perm]] += host(diag_add).astype(np.float64) * fp[perm]
    d = flat[diag]
    flat[diag] = np.where(fp > 0, np.where(d == 0.0, 1.0, d), 1.0)
    return flat.reshape(nblk + B, B, nb, nb), B, nblk


class BandCholesky:
    """Factor-once constrained SPD solve on ``device``, x = (P A P +
    (I - P))^-1 b.  ``kes``/``dofs_list``: the element blocks (E, m, m)
    and their dofs (E, m), tensors on any device or host arrays;
    ``free``: (n_dof,) 0/1 mask; ``conns``/``n_node``: the node graph of
    the RCM order.  ``factor_s`` is the factor's seconds, ``band`` the
    half bandwidth in dofs.  Everything is float64."""

    def __init__(self, kes: Sequence, dofs_list: Sequence, n_dof: int,
                 free, conns: Sequence, n_node: int,
                 nb: Optional[int] = None, scale: float = 1.0,
                 diag_add=None, device=None):
        dev = torch.device(device if device is not None else
                           (kes[0].device if isinstance(kes[0],
                                                        torch.Tensor)
                            else "cpu"))
        ndof = n_dof // n_node
        order = rcm_order([host(c) for c in conns], n_node)
        nperm = np.empty(n_node, np.int64)      # nperm[old] = new
        nperm[order] = np.arange(n_node)
        perm = (nperm[:, None] * ndof + np.arange(ndof)[None, :]).reshape(-1)
        nb = nb or int(os.environ.get("FRONTISTR_TPU_BAND_NB",
                                      str(DEFAULT_NB)))
        Ablk, B, nblk = band_layout(kes, dofs_list, perm, free, n_dof, nb,
                                    scale, diag_add)
        self.n_dof, self.nb, self.B, self.nblk = n_dof, nb, B, nblk
        self.band = (B - 1) * nb
        self.device = dev
        self.perm = torch.as_tensor(perm, device=dev)
        self._graph = None         # the sweeps captured on the card
        t0 = time.perf_counter()
        L = _factor(torch.as_tensor(Ablk, device=dev), nblk)
        del Ablk
        self.Lrow, self.Linv = _solve_layout(L, nblk)
        del L
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.factor_s = time.perf_counter() - t0

    def stats(self) -> dict:
        """The factor's seconds, half bandwidth and nb, and the bytes of
        the stored factor (N (B-1) nb off-diagonal values, N nb inverse
        diagonal ones)."""
        return {"factor_s": self.factor_s, "band": self.band, "nb": self.nb,
                "bytes": sum(t.numel() * t.element_size()
                             for t in (self.Lrow, self.Linv))}

    def solve(self, b) -> torch.Tensor:
        """x = (P A P + (I - P))^-1 b on the factor's device; ``b`` a
        tensor or host array of n_dof values.  perm maps a dof to its
        band position: bp[perm] = b, x = xp[perm]."""
        b = torch.as_tensor(b, device=self.device).to(torch.float64)
        bp = b.new_zeros(self.nblk * self.nb)
        bp[self.perm] = b
        if self.device.type == "cuda":
            xp = self._replay(bp)
        else:
            xp = _solve(self.Lrow, self.Linv, bp)
        return xp[self.perm]

    def _replay(self, bp: torch.Tensor) -> torch.Tensor:
        """The sweeps on the card: 5 nblk small kernels, captured in a
        CUDA graph at the first solve and replayed with the new
        right-hand side (the same kernels, so the same bits as eager)."""
        if self._graph is None:
            self._b_in = bp.clone()
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):      # warm-up off the capture
                _solve(self.Lrow, self.Linv, self._b_in)
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._x_out = _solve(self.Lrow, self.Linv, self._b_in)
            self._graph = graph
        self._b_in.copy_(bp)
        self._graph.replay()
        return self._x_out.clone()


def _tril(A: torch.Tensor) -> torch.Tensor:
    """The symmetric matrix of A's lower triangle."""
    low = torch.tril(A)
    return low + torch.tril(A, -1).transpose(-1, -2)


def _factor(A: torch.Tensor, nblk: int) -> torch.Tensor:
    """In place: the band Ablk (nblk + B, B, nb, nb) becomes L in the
    same layout (L[k, 0] = L_kk lower, L[k + l, l] = L_(k+l)k)."""
    B, nb = A.shape[1], A.shape[2]
    dev = A.device
    lag = torch.arange(1, B, device=dev)
    # the window's lower blocks (j, i), 1 <= i <= j <= B-1, 0-based
    jj, ii = torch.tril_indices(B - 1, B - 1, device=dev)
    bad = torch.zeros((), dtype=torch.int32, device=dev)
    for k in range(nblk):
        # no host synchronisation a block: the infos are summed and
        # read once at the end
        Lkk, info = torch.linalg.cholesky_ex(_tril(A[k, 0]))
        bad += info
        A[k, 0] = Lkk
        rows, lags = k + lag, lag
        P = torch.linalg.solve_triangular(
            Lkk.transpose(0, 1), A[rows, lags].reshape(-1, nb),
            upper=True, left=False)                 # panel L_kk^-T
        A[rows, lags] = P.reshape(B - 1, nb, nb)
        G = (P @ P.transpose(0, 1)).reshape(B - 1, nb, B - 1, nb)
        A[k + 1 + jj, jj - ii] -= G[jj, :, ii]
    if int(bad):
        raise RuntimeError("band Cholesky: the constrained matrix is not "
                           "positive definite")
    return A


def _solve_layout(L: torch.Tensor, nblk: int):
    """The factor as the sweeps read it: (Lrow (nblk, nb, (B-1) nb), row
    k's off-diagonal blocks side by side, lag 1 first, Lrow[k, a,
    (l-1) nb + c] = L_(k)(k-l)[a, c]; Linv (nblk, nb, nb), the inverse
    diagonal blocks L_kk^-1)."""
    B, nb = L.shape[1], L.shape[2]
    Lrow = L[:nblk, 1:].permute(0, 2, 1, 3).reshape(nblk, nb, (B - 1) * nb)
    eye = torch.eye(nb, dtype=L.dtype, device=L.device).expand(nblk, nb, nb)
    Linv = torch.linalg.solve_triangular(L[:nblk, 0], eye, upper=False)
    return Lrow, Linv


def _solve(Lrow: torch.Tensor, Linv: torch.Tensor,
           b: torch.Tensor) -> torch.Tensor:
    """L L^T x = b by two block sweeps, two or three small kernels a
    block row.  The work vector holds the blocks in reverse order (block
    k at row nblk - 1 - k, W = B - 1 zero blocks after them), so the
    window of blocks k-1 .. k-W of row k is the W blocks after block k,
    contiguous, in Lrow's lag order."""
    nblk, nb = Linv.shape[0], Linv.shape[1]
    Wn = Lrow.shape[2]
    y = b.new_zeros(nblk * nb + Wn)
    bb = b.reshape(nblk, nb)
    # forward, row by row: y_k = L_kk^-1 (b_k - sum_l L_(k)(k-l) y_(k-l))
    for k in range(nblk):
        p = (nblk - 1 - k) * nb
        s = torch.addmv(bb[k], Lrow[k], y[p + nb:p + nb + Wn], alpha=-1.0)
        torch.mv(Linv[k], s, out=y[p:p + nb])
    # backward, column by column: x_k = L_kk^-T y_k, then each y_(k-l)
    # loses L_(k)(k-l)^T x_k
    for k in range(nblk - 1, -1, -1):
        p = (nblk - 1 - k) * nb
        xk = torch.mv(Linv[k].transpose(0, 1), y[p:p + nb])
        y[p:p + nb] = xk
        y[p + nb:p + nb + Wn].addmv_(Lrow[k].transpose(0, 1), xk,
                                      alpha=-1.0)
    return y[:nblk * nb].reshape(nblk, nb).flip(0).reshape(-1)
