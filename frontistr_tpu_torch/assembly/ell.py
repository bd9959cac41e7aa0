"""Scalar block-ELL sparsity profile (torch port of
``frontistr_tpu/assembly/ell.py``: ``ELLProfile``, ``build_profile``,
``profile_from_model``).

The profile is the symbolic assembly of the node graph (the role of
hecmw_mat_con, hecmw1/src/solver/matrix/hecmw_mat_con.f90): padded ELL
columns per node, and the permutation that sorts every element pair
entry by its destination slot.  It is host numpy and bit-equal to the
JAX package's.  It feeds the cluster profile's scalar-slot map, the AMG
aggregation maps and the SSOR coloring, and it is the plan of the
scalar block-ELL operator ``ELLOperator`` (``from_model``), whose
blocks K1 assembles: the operator of linear STATIC's BiCGSTAB, GMRES
and GPBiCG on an unstructured mesh.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence

import numpy as np
import torch

from frontistr_tpu_torch.assembly import operators as old_ops
from frontistr_tpu_torch.assembly import profcache, profsort
from frontistr_tpu_torch.assembly.extras import extra_tensors
from frontistr_tpu_torch.assembly import segsum as segmod


@dataclasses.dataclass
class ELLProfile:
    """Static sparsity profile of the node graph."""
    n_node: int
    ndof: int
    W: int                       # max neighbors (incl. self), padded width
    cols: np.ndarray             # (N, W) int32, padded with the row index
    diag_slot: np.ndarray        # (N,) int32 slot of the diagonal block
    perm: np.ndarray             # (P,) int32 sorts pair entries by slot
    seg_sorted: np.ndarray       # (P,) int32 destination slots, sorted
    pair_counts: tuple           # entries per block (E*nn*nn each)

    @property
    def n_slots(self) -> int:
        return self.n_node * self.W

    def plan(self, device) -> segmod.SegsumPlan:
        """Device-resident segment-sum plan (cached per device)."""
        return segmod.cached_plan(self, device)


def build_profile(conns: Sequence[np.ndarray], n_node: int,
                  ndof: int) -> ELLProfile:
    """Symbolic assembly: node graph -> padded ELL columns + scatter maps."""
    rows_l, cols_l, counts = [], [], []
    for c in conns:
        E, nn = c.shape
        ct = c.T                                          # (nn, E)
        # pair order (a, b, e): e fastest, the order the segment-sum
        # kernel decodes entries in
        r = np.repeat(ct[:, None, :], nn, axis=1).reshape(-1)
        q = np.broadcast_to(ct[None, :, :], (nn, nn, E)).reshape(-1)
        rows_l.append(r.astype(np.int64))
        cols_l.append(q.astype(np.int64))
        counts.append(E * nn * nn)
    rows = np.concatenate(rows_l)
    colsv = np.concatenate(cols_l)
    key = rows * n_node + colsv
    uniq, inv = profsort.unique_inverse(key)
    urow = (uniq // n_node).astype(np.int64)
    ucol = (uniq % n_node).astype(np.int32)
    per_row = np.bincount(urow, minlength=n_node)
    W = max(int(per_row.max()) if len(per_row) else 1, 1)
    starts = np.zeros(n_node + 1, dtype=np.int64)
    np.cumsum(per_row, out=starts[1:])
    within = np.arange(len(uniq), dtype=np.int64) - starts[urow]
    cols_pad = np.repeat(np.arange(n_node, dtype=np.int32)[:, None], W,
                         axis=1)
    cols_pad[urow, within] = ucol
    uniq_slot = (urow * W + within).astype(np.int64)     # per unique pair
    slot = uniq_slot[inv]                                # per raw pair entry
    perm = profsort.stable_argsort(slot)
    seg_sorted = slot[perm].astype(np.int32)
    diag_slot = np.zeros(n_node, dtype=np.int32)
    is_diag = urow == ucol
    diag_slot[urow[is_diag]] = within[is_diag].astype(np.int32)
    return ELLProfile(n_node=n_node, ndof=ndof, W=W, cols=cols_pad,
                      diag_slot=diag_slot, perm=perm.astype(np.int32),
                      seg_sorted=seg_sorted, pair_counts=tuple(counts))


def profile_key(conns, n_node, ndof) -> str:
    h = hashlib.sha1()
    h.update(np.int64(n_node).tobytes())
    h.update(np.int64(ndof).tobytes())
    for c in conns:
        h.update(np.int64(c.shape[0]).tobytes())
        h.update(np.ascontiguousarray(c[:: max(1, c.shape[0] // 64)])
                 .tobytes())
    return h.hexdigest()


_PROFILE_CACHE: dict = {}


def model_conns(model) -> list:
    """The connectivity of the model's element blocks, then its spring
    blocks (``model.extras``)."""
    return [b.conn for b in model.blocks] + \
        list(getattr(model, "extras", ([],))[0])


def profile_from_model(model, n_node: Optional[int] = None) -> ELLProfile:
    """Build (and cache: one profile in memory, they are large; every
    profile on disk through ``profcache``) the ELL profile of a
    StructModel, its spring blocks included."""
    conns = model_conns(model)
    nn = model.n_node if n_node is None else n_node
    key = profile_key(conns, nn, model.ndof)
    prof = _PROFILE_CACHE.get(key)
    if prof is None:
        prof = _disk_load(conns, nn, model.ndof)
        if prof is None:
            prof = build_profile(conns, nn, model.ndof)
            _disk_save(conns, nn, model.ndof, prof)
        _PROFILE_CACHE.clear()
        _PROFILE_CACHE[key] = prof
    return prof


def _disk_load(conns, nn, ndof) -> Optional[ELLProfile]:
    """The profile from the persistent cache (``profcache``), if there."""
    z = profcache.load(profcache.conn_key(conns, nn, ndof, tag="torch-ell"))
    if z is None:
        return None
    return ELLProfile(n_node=nn, ndof=ndof, W=int(z["W"]),
                      cols=z["cols"], diag_slot=z["diag_slot"],
                      perm=z["perm"], seg_sorted=z["seg_sorted"],
                      pair_counts=tuple(int(v) for v in z["pair_counts"]))


def _disk_save(conns, nn, ndof, prof: ELLProfile) -> None:
    profcache.save(
        profcache.conn_key(conns, nn, ndof, tag="torch-ell"),
        dict(W=np.int64(prof.W), cols=prof.cols,
             diag_slot=prof.diag_slot, perm=prof.perm,
             seg_sorted=prof.seg_sorted,
             pair_counts=np.asarray(prof.pair_counts, np.int64)))


@dataclasses.dataclass
class ELLOperator:
    """Constrained global stiffness operator over assembled scalar-ELL
    blocks (the JAX package's ``ELLOperator``): ``matvec``,
    ``apply_constrained``, ``constrained_rhs``, ``diag_blocks``,
    ``block_jacobi`` and ``astype``.  The blocks are kept as rows,
    ``rows[n, i, w*nd + j] = K[n, cols[n, w]][i, j]``, so a product is
    one gather of x by ``cols`` and one batched (nd, W*nd) x (W*nd, 1)
    product; ``blocks`` is the JAX package's (N, W, nd, nd) view."""
    rows: torch.Tensor           # (N, nd, W*nd)
    cols: torch.Tensor           # (N, W) int64
    diag_slot: torch.Tensor      # (N,) int64
    n_node: int
    ndof: int
    free_mask: torch.Tensor      # (N*nd,) 1.0 free / 0.0 fixed

    @property
    def n_dof(self) -> int:
        return self.n_node * self.ndof

    @property
    def blocks(self) -> torch.Tensor:
        N, nd = self.n_node, self.ndof
        return self.rows.reshape(N, nd, -1, nd).permute(0, 2, 1, 3)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        N, nd = self.n_node, self.ndof
        xg = x.reshape(N, nd)[self.cols].reshape(N, -1, 1)
        return torch.bmm(self.rows, xg).reshape(-1)

    def apply_constrained(self, x: torch.Tensor) -> torch.Tensor:
        xm = x * self.free_mask
        y = self.matvec(xm)
        return y * self.free_mask + x * (1.0 - self.free_mask)

    def constrained_rhs(self, f: torch.Tensor, u_fix: torch.Tensor):
        y = self.matvec(u_fix)
        return (f - y) * self.free_mask + u_fix * (1.0 - self.free_mask)

    def diag_blocks(self) -> torch.Tensor:
        n = torch.arange(self.n_node, device=self.cols.device)
        return self.blocks[n, self.diag_slot]         # (N, nd, nd)

    def block_jacobi(self):
        """DIAG preconditioner: the nodal diagonal blocks restricted to
        the free dofs, a unit diagonal where an entry is 0 (fixed and
        unused dofs), inverted in float64 (``torch.linalg.inv``; the JAX
        package's closed forms are a TPU workaround).  Returns
        ``apply(r)``."""
        N, nd = self.n_node, self.ndof
        fm = self.free_mask.reshape(N, nd)
        D = self.diag_blocks() * (fm[:, :, None] * fm[:, None, :])
        ar = torch.arange(nd, device=D.device)
        dd = D[:, ar, ar]
        D[:, ar, ar] = dd + (dd == 0.0).to(D.dtype)
        Dinv = torch.linalg.inv(D.to(torch.float64)).to(D.dtype)

        def apply(r):
            return torch.bmm(Dinv, r.reshape(N, nd, 1)).reshape(-1)

        return apply

    def astype(self, dtype) -> "ELLOperator":
        return dataclasses.replace(self, rows=self.rows.to(dtype),
                                   free_mask=self.free_mask.to(dtype))


def from_model(model, kes, dtype=None,
               profile: Optional[ELLProfile] = None) -> ELLOperator:
    """Assemble the ELL operator of a StructModel from its element
    matrices (on their device), the model's spring blocks appended: K1
    (``segsum.segsum``) at the profile's plan sums the nd*nd slot planes
    of N*W slots, on the CPU its plain version."""
    if profile is None:
        profile = profile_from_model(model)
    dev = kes[0].device
    kes = list(kes) + extra_tensors(model, dev, kes[0].dtype)[0]
    if dtype is not None:
        kes = [k.to(dtype) for k in kes]
    nns = [c.shape[1] for c in model_conns(model)]
    free = old_ops.make_free_mask(model.n_dof_total, model.fixed_dofs)
    return from_blocks(profile, kes, nns, free)


def from_blocks(profile: ELLProfile, kes, nns, free) -> ELLOperator:
    """The ELL operator of element matrices ``kes`` (on their device;
    block b of ``nn = nns[b]`` nodes, in the order of the conns the
    profile was built from) and the free mask ``free`` (host, N*nd), with
    no StructModel: K1's element entry at the profile's plan, on the CPU
    its plain version.  Any nd K1 takes (2, 3, 4 or 6); the element
    matrices need not be symmetric."""
    dev = kes[0].device
    nd, N, W = profile.ndof, profile.n_node, profile.W
    raw = segmod.segsum(profile.plan(dev), list(kes), list(nns), nd)
    rows = raw.reshape(nd, nd, N, W).permute(2, 0, 3, 1).reshape(
        N, nd, W * nd)
    return ELLOperator(
        rows=rows,
        cols=torch.as_tensor(profile.cols, dtype=torch.int64, device=dev),
        diag_slot=torch.as_tensor(profile.diag_slot, dtype=torch.int64,
                                  device=dev),
        n_node=N, ndof=nd,
        free_mask=torch.as_tensor(np.asarray(free), dtype=raw.dtype,
                                  device=dev))
