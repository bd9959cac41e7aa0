"""Cluster-ELL operator (torch port of ``frontistr_tpu/assembly/bell.py``).

G = 8 consecutive (band-ordered) nodes form a cluster; the global matrix
is stored as dense (G*nd, G*nd) blocks per (cluster, neighbour cluster)
pair in the plane-major layout (G*nd, G*nd, Wc, C) of the JAX package,
kept here for parity (a layout chosen for the H100 is later, measured
work).  Assembly is the sorted segment-sum of the element pair entries
into cluster slots through the K1 kernel (``assembly/segsum.py``); the
nodal diagonal blocks and the scalar ELL blocks the AMG Galerkin setup
needs are read out of the same slot planes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from frontistr_tpu_torch.assembly import ell as ellmod
from frontistr_tpu_torch.assembly import operators as old_ops
from frontistr_tpu_torch.assembly import profcache, profsort
from frontistr_tpu_torch.assembly import segsum as segmod
from frontistr_tpu_torch.fem.isoparam import det_inv_small, gauss_jordan_inv


@dataclasses.dataclass
class ClusterProfile:
    """Host-built cluster-ELL sparsity (bit-equal to the JAX package's)."""
    n_node: int
    ndof: int
    G: int                       # nodes per cluster
    C: int                       # clusters
    Wc: int                      # max neighbor clusters
    ccols: np.ndarray            # (C, Wc) int32, padded with row cluster
    diag_wc: np.ndarray          # (C,) int32: wc of the c->c slot
    perm: np.ndarray             # (P,) int32 sorts pair entries by slot2
    seg_sorted: np.ndarray       # (P,) int32 slot2, sorted
    scal_src: np.ndarray         # (N, W) int32 slot2 of each scalar slot
    pair_counts: tuple

    @property
    def n_slots(self) -> int:
        return self.C * self.Wc * self.G * self.G

    @property
    def slot_shape(self) -> tuple:
        """Slot (aoff, boff, wc, c) of the plane layout, c fastest: the
        shape the element kernel tiles by (``segsum.element_schedule``)."""
        return (self.G, self.G, self.Wc, self.C)

    def plan(self, device) -> segmod.SegsumPlan:
        return segmod.cached_plan(self, device)

    def tensor(self, name: str, device) -> torch.Tensor:
        """int64 device copy of an index field (cached per device),
        widened on the device."""
        cache = self.__dict__.setdefault("_dev", {})
        key = (name, str(torch.device(device)))
        if key not in cache:
            cache[key] = torch.as_tensor(getattr(self, name)).to(
                device).long()
        return cache[key]


def build_cluster_profile(conns: Sequence[np.ndarray], n_node: int,
                          ndof: int, G: int = 8,
                          scalar: Optional[ellmod.ELLProfile] = None
                          ) -> ClusterProfile:
    """Symbolic cluster assembly.  Nodes n belong to cluster n // G."""
    C = (n_node + G - 1) // G
    rows_l, cols_l, counts = [], [], []
    for c in conns:
        E, nn = c.shape
        ct = c.T
        rows_l.append(np.repeat(ct[:, None, :], nn, axis=1).reshape(-1))
        cols_l.append(np.broadcast_to(ct[None, :, :],
                                      (nn, nn, E)).reshape(-1))
        counts.append(E * nn * nn)
    rows = np.concatenate(rows_l).astype(np.int64)
    colsv = np.concatenate(cols_l).astype(np.int64)
    cr, cq = rows // G, colsv // G
    key = cr * C + cq
    uniq = profsort.unique_sorted(key)
    ur, uc = uniq // C, (uniq % C).astype(np.int32)
    cnt = np.bincount(ur, minlength=C)
    Wc = max(int(cnt.max()) if len(cnt) else 1, 1)
    ccols = np.repeat(np.arange(C, dtype=np.int32)[:, None], Wc, axis=1)
    starts = np.zeros(C + 1, np.int64)
    np.cumsum(cnt, out=starts[1:])
    within = np.arange(len(uniq), dtype=np.int64) - starts[ur]
    ccols[ur, within] = uc
    wc_of_pair = within
    pair_idx = np.searchsorted(uniq, key)
    wc = wc_of_pair[pair_idx]
    # slot order (aoff, boff, wc, c): each plane's slots reshape to
    # (G, G, Wc, C), the order of the plane-major blocks
    slot2 = (((rows % G) * G + colsv % G) * Wc + wc) * C + cr
    perm = profsort.stable_argsort(slot2.astype(np.int64))
    seg_sorted = slot2[perm].astype(np.int32)
    diag_wc = np.zeros(C, np.int32)
    isd = ur == uc
    diag_wc[ur[isd]] = within[isd].astype(np.int32)
    # scalar-slot -> slot2 map (for AMG / diag extraction)
    if scalar is None:
        scalar = ellmod.build_profile(conns, n_node, ndof)
    N, W = scalar.cols.shape
    n_idx = np.repeat(np.arange(N, dtype=np.int64), W)
    m_idx = scalar.cols.reshape(-1).astype(np.int64)
    scr, scq = n_idx // G, m_idx // G
    skey = scr * C + scq
    s_pair = np.searchsorted(uniq, skey)
    swc = wc_of_pair[np.clip(s_pair, 0, len(uniq) - 1)]
    scal_src = ((((n_idx % G) * G + m_idx % G) * Wc + swc) * C + scr) \
        .astype(np.int32).reshape(N, W)
    # the scalar ELL pads each row's tail with (n, n), which would alias
    # the real diagonal entry: mark padding -1 (read as 0)
    nkey = rows * np.int64(n_node) + colsv
    upairs = profsort.unique_sorted(nkey)
    per_row_s = np.bincount((upairs // n_node).astype(np.int64),
                            minlength=N)
    pad_mask = (np.arange(W)[None, :] >= per_row_s[:, None])
    scal_src[pad_mask] = -1
    return ClusterProfile(
        n_node=n_node, ndof=ndof, G=G, C=C, Wc=Wc, ccols=ccols,
        diag_wc=diag_wc, perm=perm.astype(np.int32),
        seg_sorted=seg_sorted, scal_src=scal_src,
        pair_counts=tuple(counts))


def build_row_cluster_profile(conns: Sequence[np.ndarray], n_node: int,
                              ndof: int, n0: int, n1: int,
                              scalar_cols: np.ndarray,
                              G: int = 8) -> ClusterProfile:
    """The node rows [n0, n1) of ``build_cluster_profile``'s matrix
    alone (n0 and n1 multiples of G): a rank's rows of the sharded
    operator.  Its ``C = (n1 - n0) / G`` row clusters keep the global
    column clusters of their neighbours in ``ccols``; ``perm`` picks, in
    slot order, the entries of these rows out of all the raw entries of
    ``conns`` (order (a, b, e), e fastest, per block), so a plan over it
    reads the element matrices of ``conns`` whole and sums these rows
    only, each slot in the order of the whole profile.
    ``scalar_cols`` (n1 - n0, W) are the rows' scalar ELL columns (the
    AMG's ``scal_src``)."""
    Cg = (n_node + G - 1) // G
    c0, Cl = n0 // G, (n1 - n0) // G
    rows_l, cols_l, counts = [], [], []
    for c in conns:
        E, nn = c.shape
        ct = c.T
        rows_l.append(np.repeat(ct[:, None, :], nn, axis=1).reshape(-1))
        cols_l.append(np.broadcast_to(ct[None, :, :],
                                      (nn, nn, E)).reshape(-1))
        counts.append(E * nn * nn)
    rows = np.concatenate(rows_l).astype(np.int64)
    colsv = np.concatenate(cols_l).astype(np.int64)
    ridx = np.flatnonzero((rows >= n0) & (rows < n1))
    rows, colsv = rows[ridx], colsv[ridx]
    cr, cq = rows // G - c0, colsv // G
    key = cr * Cg + cq
    uniq = profsort.unique_sorted(key)
    ur, uc = uniq // Cg, (uniq % Cg).astype(np.int32)
    cnt = np.bincount(ur, minlength=Cl)
    Wc = max(int(cnt.max()) if len(cnt) else 1, 1)
    ccols = np.repeat((c0 + np.arange(Cl, dtype=np.int32))[:, None], Wc,
                      axis=1)
    starts = np.zeros(Cl + 1, np.int64)
    np.cumsum(cnt, out=starts[1:])
    within = np.arange(len(uniq), dtype=np.int64) - starts[ur]
    ccols[ur, within] = uc
    wc = within[np.searchsorted(uniq, key)]
    slot2 = (((rows % G) * G + colsv % G) * Wc + wc) * Cl + cr
    perm = profsort.stable_argsort(slot2.astype(np.int64))
    seg_sorted = slot2[perm].astype(np.int32)
    perm = ridx[perm]
    diag_wc = np.zeros(Cl, np.int32)
    isd = uc == ur + c0
    diag_wc[ur[isd]] = within[isd].astype(np.int32)
    N, W = scalar_cols.shape
    n_idx = np.repeat(np.arange(n0, n1, dtype=np.int64), W)
    m_idx = scalar_cols.reshape(-1).astype(np.int64)
    scr, scq = n_idx // G - c0, m_idx // G
    s_pair = np.searchsorted(uniq, scr * Cg + scq)
    swc = within[np.clip(s_pair, 0, max(len(uniq) - 1, 0))] if len(uniq) \
        else np.zeros_like(scr)
    scal_src = ((((n_idx % G) * G + m_idx % G) * Wc + swc) * Cl + scr) \
        .astype(np.int32).reshape(N, W)
    upairs = profsort.unique_sorted(rows * np.int64(n_node) + colsv)
    per_row_s = np.bincount((upairs // n_node - n0).astype(np.int64),
                            minlength=N)
    scal_src[np.arange(W)[None, :] >= per_row_s[:, None]] = -1
    return ClusterProfile(
        n_node=n1 - n0, ndof=ndof, G=G, C=Cl, Wc=Wc, ccols=ccols,
        diag_wc=diag_wc, perm=perm.astype(np.int32),
        seg_sorted=seg_sorted, scal_src=scal_src,
        pair_counts=tuple(counts))


def _planes_to_blocks(raw: torch.Tensor, nd: int, G: int, Wc: int,
                      C: int) -> torch.Tensor:
    """(nd*nd, G*G*Wc*C) slot planes -> plane-major cluster blocks
    (G*nd, G*nd, Wc, C): blocks[a*nd+i, b*nd+j, w, c] =
    raw[i*nd+j][(a, b, w, c)]."""
    six = raw.reshape(nd, nd, G, G, Wc, C).permute(2, 0, 3, 1, 4, 5)
    return six.reshape(G * nd, G * nd, Wc, C)


def assemble_cluster(profile: ClusterProfile, kes: Sequence[torch.Tensor],
                     nns: Sequence[int]):
    """Numeric assembly through K1: returns (blocks (G*nd, G*nd, Wc, C),
    raw slot planes (nd*nd, n_slots))."""
    nd = profile.ndof
    raw = segmod.segsum(profile.plan(kes[0].device), kes, nns, nd)
    return _planes_to_blocks(raw, nd, profile.G, profile.Wc,
                             profile.C), raw


def extract_scalar_blocks(cprof: ClusterProfile, raw: torch.Tensor,
                          scalar: ellmod.ELLProfile) -> torch.Tensor:
    """Scalar block planes (nd*nd, N, W) gathered out of the raw cluster
    slot planes (feeds the AMG Galerkin setup; plane p = i*nd + j)."""
    N, W = scalar.cols.shape
    src = cprof.tensor("scal_src", raw.device).reshape(-1)
    live = (src >= 0).to(raw.dtype)
    return (raw[:, src.clamp(min=0)] * live).reshape(-1, N, W)


def extract_diag(cprof: ClusterProfile, raw: torch.Tensor) -> torch.Tensor:
    """Nodal diagonal nd x nd blocks (N, nd, nd) from the slot planes."""
    nd, G, C, Wc = cprof.ndof, cprof.G, cprof.C, cprof.Wc
    n = torch.arange(cprof.n_node, device=raw.device)
    c, off = n // G, n % G
    src = ((off * G + off) * Wc + cprof.tensor("diag_wc", raw.device)[c]) \
        * C + c
    return raw[:, src].T.reshape(-1, nd, nd)


def block_jacobi_apply(D: torch.Tensor, free_mask: torch.Tensor):
    """DIAG preconditioner over nodal blocks D (N, nd, nd): masked to the
    free dofs, identity on fixed and unused dofs, inverted in closed
    form (hecmw_precond_DIAG_33.f90 semantics), the 6 x 6 blocks of shells
    and beams by Gauss-Jordan as in the JAX package."""
    N, nd, _ = D.shape
    fm = free_mask.reshape(N, nd)
    D = D * (fm[:, :, None] * fm[:, None, :])
    idx = torch.arange(nd, device=D.device)
    dd = D[:, idx, idx]
    D = D.clone()
    D[:, idx, idx] = dd + (dd == 0.0).to(D.dtype)
    if nd == 1:
        Dinv = 1.0 / D
    elif nd in (2, 3):
        _, Dinv = det_inv_small(D)
    else:
        Dinv = gauss_jordan_inv(D)

    def apply(r):
        return torch.einsum("nij,nj->ni", Dinv,
                            r.reshape(N, nd)).reshape(-1)

    return apply


@dataclasses.dataclass
class ClusterOperator:
    """Constrained stiffness operator over cluster-ELL blocks."""
    blocks: torch.Tensor         # (G*nd, G*nd, Wc, C)
    ccols: torch.Tensor          # (C, Wc) int64
    diag: torch.Tensor           # (N, nd, nd) nodal diagonal blocks
    n_node: int
    ndof: int
    G: int
    free_mask: torch.Tensor      # (N*nd,)

    @property
    def C(self) -> int:
        return self.blocks.shape[3]

    @property
    def n_dof(self) -> int:
        return self.n_node * self.ndof

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        m = self.G * self.ndof
        n = x.shape[0]
        xc = torch.nn.functional.pad(x, (0, self.C * m - n)) \
            .reshape(self.C, m)
        xgP = xc[self.ccols].permute(2, 1, 0)         # (m, Wc, C)
        y = torch.einsum("abwc,bwc->ac", self.blocks, xgP)
        return y.T.reshape(-1)[:n]

    def apply_constrained(self, x: torch.Tensor) -> torch.Tensor:
        xm = x * self.free_mask
        y = self.matvec(xm)
        return y * self.free_mask + x * (1.0 - self.free_mask)

    def constrained_rhs(self, f: torch.Tensor, u_fix: torch.Tensor):
        y = self.matvec(u_fix)
        return (f - y) * self.free_mask + u_fix * (1.0 - self.free_mask)

    def block_jacobi(self):
        return block_jacobi_apply(self.diag, self.free_mask)


_CPROFILE_CACHE: dict = {}


def cluster_profile_from_model(model,
                               scalar: Optional[ellmod.ELLProfile] = None
                               ) -> ClusterProfile:
    """Build (and cache: one profile in memory, every profile on disk
    through ``profcache``) the cluster profile of a model, its spring
    blocks included."""
    conns = ellmod.model_conns(model)
    key = ellmod.profile_key(conns, model.n_node, model.ndof) + "-bell"
    prof = _CPROFILE_CACHE.get(key)
    if prof is None:
        prof = _disk_load(conns, model.n_node, model.ndof)
        if prof is None:
            prof = build_cluster_profile(conns, model.n_node, model.ndof,
                                         scalar=scalar)
            _disk_save(conns, model.n_node, model.ndof, prof)
        _CPROFILE_CACHE.clear()
        _CPROFILE_CACHE[key] = prof
    return prof


def _disk_load(conns, nn, ndof) -> Optional[ClusterProfile]:
    """The cluster profile from the persistent cache (``profcache``)."""
    z = profcache.load(profcache.conn_key(conns, nn, ndof,
                                          tag="torch-bell"))
    if z is None:
        return None
    return ClusterProfile(
        n_node=nn, ndof=ndof, G=int(z["G"]), C=int(z["C"]),
        Wc=int(z["Wc"]), ccols=z["ccols"], diag_wc=z["diag_wc"],
        perm=z["perm"], seg_sorted=z["seg_sorted"],
        scal_src=z["scal_src"],
        pair_counts=tuple(int(v) for v in z["pair_counts"]))


def _disk_save(conns, nn, ndof, prof: ClusterProfile) -> None:
    profcache.save(
        profcache.conn_key(conns, nn, ndof, tag="torch-bell"),
        dict(G=np.int64(prof.G), C=np.int64(prof.C),
             Wc=np.int64(prof.Wc), ccols=prof.ccols,
             diag_wc=prof.diag_wc, perm=prof.perm,
             seg_sorted=prof.seg_sorted, scal_src=prof.scal_src,
             pair_counts=np.asarray(prof.pair_counts, np.int64)))


def from_model(model, kes, dtype=None,
               profile: Optional[ClusterProfile] = None,
               want_scalar: bool = False,
               scalar: Optional[ellmod.ELLProfile] = None):
    """Assemble the cluster operator (and optionally the scalar block
    planes for AMG) from a StructModel + per-block element matrices, the
    model's spring blocks appended."""
    from frontistr_tpu_torch.assembly.extras import extra_tensors
    if profile is None:
        profile = cluster_profile_from_model(model, scalar=scalar)
    kes = list(kes) + extra_tensors(model, kes[0].device, kes[0].dtype)[0]
    if dtype is not None:
        kes = [k.to(dtype) for k in kes]
    nns = [c.shape[1] for c in ellmod.model_conns(model)]
    blocks, raw = assemble_cluster(profile, kes, nns)
    dev = raw.device
    free = old_ops.make_free_mask(model.n_dof_total, model.fixed_dofs)
    op = ClusterOperator(
        blocks=blocks, ccols=profile.tensor("ccols", dev),
        diag=extract_diag(profile, raw), n_node=model.n_node,
        ndof=model.ndof, G=profile.G,
        free_mask=torch.as_tensor(free, dtype=raw.dtype, device=dev))
    if want_scalar:
        sc = scalar if scalar is not None \
            else ellmod.profile_from_model(model)
        return op, extract_scalar_blocks(profile, raw, sc)
    return op
