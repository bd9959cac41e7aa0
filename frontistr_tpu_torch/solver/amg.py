"""Aggregation AMG preconditioner (torch port of
``frontistr_tpu/solver/amg.py``).

An unsmoothed-aggregation multigrid V-cycle with Chebyshev smoothers,
the accelerator stand-in for the reference's SSOR/BILU sweeps and
Trilinos-ML (hecmw_precond_SSOR_33.f90, hecmw_ML_wrapper_33.c):

  level 0: the global operator (N nodes x nd dofs)
  level 1: aggregates of S0 consecutive (band-ordered) nodes with a
           per-aggregate rigid-body-mode tentative prolongator
           (nd=3 -> 6 modes, nd=2 -> 3, nd=1 -> 1), orthonormalized
  level 2: piecewise-constant aggregation of S1 coarse nodes; the
           coarsest operator is dense and explicitly inverted

The Galerkin products P^T A P run on the device from the scalar ELL
block planes, summed by K1's planes entry (``assembly/segsum.py``
``segsum_planes``) over the host-built sorted maps, in a fixed order, as
the JAX package's sorted ``segment_sum`` does.  The V-cycle is symmetric, so
it is a valid SPD preconditioner for CG.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from frontistr_tpu_torch.assembly import segsum as segmod


def _n_modes(nd: int) -> int:
    return {1: 1, 2: 3, 3: 6}.get(nd, 0)


@dataclasses.dataclass
class AMGMaps:
    """Static aggregation maps (host numpy, bit-equal to the JAX
    package's); ``tensors(device)`` gives their int64 device copies."""
    nd: int
    nv: int                 # modes per aggregate
    S0: int
    S1: int
    n_node: int
    Na: int                 # level-1 aggregates
    Na2: int                # level-2 aggregates
    Wc: int                 # level-1 ELL width
    cols1: np.ndarray       # (Na, Wc) int32
    diag_slot1: np.ndarray  # (Na,) int32
    perm01: np.ndarray      # sorts the N*W fine slots by coarse slot
    seg01: np.ndarray       # (N*W,) sorted coarse slot ids
    perm12: np.ndarray      # sorts Na*Wc slots by dense (a2, b2) id
    seg12: np.ndarray

    def tensors(self, device) -> dict:
        cache = self.__dict__.setdefault("_dev", {})
        key = str(torch.device(device))
        if key not in cache:
            cache[key] = {
                name: torch.as_tensor(np.asarray(getattr(self, name),
                                                 np.int64), device=device)
                for name in ("cols1", "diag_slot1")}
        return cache[key]

    def plans(self, device) -> Tuple[segmod.SegsumPlan, segmod.SegsumPlan]:
        """The Galerkin sums' segment-sum plans on ``device``, built once:
        fine (N*W) slots -> level-1 (Na*Wc) slots, and level-1 slots ->
        dense level-2 (Na2*Na2) entries."""
        cache = self.__dict__.setdefault("_plans", {})
        key = str(torch.device(device))
        if key not in cache:
            cache[key] = (
                segmod.make_plan(self.perm01, self.seg01, self.Na * self.Wc,
                                 (len(self.perm01),), device),
                segmod.make_plan(self.perm12, self.seg12,
                                 self.Na2 * self.Na2, (len(self.perm12),),
                                 device))
        return cache[key]


    def row_plan(self, device, n0: int, n1: int) -> segmod.SegsumPlan:
        """The fine -> level-1 plan of the node rows [n0, n1) alone (a
        rank's partial Galerkin sums), built once."""
        cache = self.__dict__.setdefault("_row_plans", {})
        key = (str(torch.device(device)), n0, n1)
        if key not in cache:
            W = len(self.perm01) // self.n_node
            keep = (self.perm01 >= n0 * W) & (self.perm01 < n1 * W)
            cache[key] = segmod.make_plan(
                self.perm01[keep] - n0 * W, self.seg01[keep],
                self.Na * self.Wc, ((n1 - n0) * W,), device)
        return cache[key]


def build_maps(cols: np.ndarray, n_node: int, nd: int,
               S0: int = 24, S1: int = 16) -> Optional[AMGMaps]:
    """Aggregation maps from the fine ELL columns (chunks of consecutive
    nodes form the aggregates)."""
    nv = _n_modes(nd)
    if nv == 0:
        return None
    N, W = cols.shape
    Na = (n_node + S0 - 1) // S0
    agg = np.minimum(np.arange(N) // S0, Na - 1)
    rows = np.repeat(np.arange(N, dtype=np.int64), W)
    a_r = agg[rows]
    a_c = agg[cols.reshape(-1)]
    key = a_r * Na + a_c
    uniq, inv = np.unique(key, return_inverse=True)
    urow = uniq // Na
    ucol = (uniq % Na).astype(np.int32)
    per_row = np.bincount(urow, minlength=Na)
    Wc = int(per_row.max())
    starts = np.zeros(Na + 1, np.int64)
    np.cumsum(per_row, out=starts[1:])
    within = np.arange(len(uniq)) - starts[urow]
    cols1 = np.repeat(np.arange(Na, dtype=np.int32)[:, None], Wc, axis=1)
    cols1[urow, within] = ucol
    uniq_slot = urow * Wc + within
    slot = uniq_slot[inv]
    perm01 = np.argsort(slot, kind="stable")
    seg01 = slot[perm01].astype(np.int32)
    diag_slot1 = np.zeros(Na, np.int32)
    isd = urow == ucol
    diag_slot1[urow[isd]] = within[isd].astype(np.int32)
    # level 1 -> 2 (dense coarsest)
    Na2 = (Na + S1 - 1) // S1
    agg2 = np.minimum(np.arange(Na) // S1, Na2 - 1)
    r2 = agg2[np.repeat(np.arange(Na), Wc)]
    c2 = agg2[cols1.reshape(-1)]
    did = r2 * Na2 + c2
    perm12 = np.argsort(did, kind="stable")
    seg12 = did[perm12].astype(np.int32)
    return AMGMaps(nd=nd, nv=nv, S0=S0, S1=S1, n_node=n_node, Na=Na,
                   Na2=Na2, Wc=Wc, cols1=cols1, diag_slot1=diag_slot1,
                   perm01=perm01.astype(np.int32), seg01=seg01,
                   perm12=perm12.astype(np.int32), seg12=seg12)


def _rigid_modes(maps: AMGMaps, coords: torch.Tensor,
                 free_mask: torch.Tensor, dtype,
                 n_real: Optional[int] = None) -> torch.Tensor:
    """Per-node mode matrix (Na, S0, nd, nv): translations (+ rotations),
    Dirichlet rows zeroed, orthonormalized per aggregate.  ``n_real``:
    the nodes before a sharded run's padding (the padded ones count in
    no aggregate's centroid)."""
    nd, nv, S0, Na, N = maps.nd, maps.nv, maps.S0, maps.Na, maps.n_node
    n_real = N if n_real is None else n_real
    dev = coords.device
    npad = Na * S0
    fm = free_mask.reshape(N, nd).to(dtype)
    if nd == 1:
        B = fm[:, :, None]
    else:
        c = coords[:, :nd].to(dtype)
        cp = torch.nn.functional.pad(c, (0, 0, 0, npad - N))
        cnt = torch.clamp(n_real - torch.arange(Na, device=dev) * S0,
                          min=1, max=S0).to(dtype)
        cent = cp.reshape(Na, S0, nd).sum(dim=1) / cnt[:, None]
        agg = torch.clamp(torch.arange(N, device=dev) // S0, max=Na - 1)
        d = c - cent[agg]
        eye = torch.eye(nd, dtype=dtype, device=dev).expand(N, nd, nd)
        if nd == 2:
            rot = torch.stack([-d[:, 1], d[:, 0]], dim=1)[:, :, None]
            B = torch.cat([eye, rot], dim=2)
        else:
            z = torch.zeros(N, dtype=dtype, device=dev)
            rx = torch.stack([z, -d[:, 2], d[:, 1]], dim=1)
            ry = torch.stack([d[:, 2], z, -d[:, 0]], dim=1)
            rz = torch.stack([-d[:, 1], d[:, 0], z], dim=1)
            B = torch.cat([eye, rx[:, :, None], ry[:, :, None],
                           rz[:, :, None]], dim=2)
        B = B * fm[:, :, None]
    Bp = torch.nn.functional.pad(B, (0, 0, 0, 0, 0, npad - N))
    Ba = Bp.reshape(Na, S0 * nd, nv)
    G = torch.einsum("akp,akq->apq", Ba, Ba)
    tr = torch.diagonal(G, dim1=1, dim2=2).sum(dim=1)
    ridge = torch.where(tr > 0, tr, torch.ones_like(tr)) * 1e-7 + \
        (tr <= 0).to(dtype)
    G = G + ridge[:, None, None] * torch.eye(nv, dtype=dtype, device=dev)
    L = torch.linalg.cholesky(G)
    Linv = torch.linalg.inv(L)
    Bo = torch.einsum("akp,aqp->akq", Ba, Linv)             # B L^-T
    return Bo.reshape(Na, S0, nd, nv)


def _block_inv(D: torch.Tensor) -> torch.Tensor:
    """Inverses of the level-1 diagonal blocks (Na, nv, nv), symmetric
    positive semi-definite.

    As in the JAX package, a zero diagonal entry (a mode that is zero on
    the whole aggregate) is set to 1 first.  The inverse is then taken in
    float64 through an eigendecomposition whose eigenvalues are floored
    at 100 eps(dtype) of the block's largest, and rounded to the blocks'
    dtype.  A run of collinear nodes has no rotation about its own line:
    that mode's column of the tentative prolongator is zero up to
    rounding, and the block is singular up to rounding.  Inverted as it
    stands in float32 (the JAX package's Gauss-Jordan, or any LU), such
    a block gives an indefinite V-cycle whose sign depends on the
    device's summation order; with the floor the mode is left to the
    coarser level."""
    D64 = D.to(torch.float64, copy=True)
    idx = torch.arange(D.shape[-1], device=D.device)
    dd = D64[:, idx, idx]
    D64[:, idx, idx] = dd + (dd == 0.0).to(D64.dtype)
    lam, V = torch.linalg.eigh(0.5 * (D64 + D64.transpose(1, 2)))
    top = lam[:, -1:]
    floor = torch.where(top > 0, top * (100.0 * torch.finfo(D.dtype).eps),
                        torch.ones_like(top))
    lam = torch.maximum(lam, floor)
    return torch.einsum("aij,aj,akj->aik", V, 1.0 / lam, V).to(D.dtype)


def _cheb(A: Callable, Minner: Callable, lmax, degree: int):
    """Fixed-coefficient Chebyshev correction z ~= A^-1 r on
    [lmax/30, 1.05*lmax]: a symmetric polynomial in A, SPD-safe."""
    lmax = 1.05 * lmax
    lmin = lmax / 30.0
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)

    def apply(r):
        b = Minner(r)
        d = b / theta
        z = d
        sigma = theta / delta
        rho_old = 1.0 / sigma
        resid = b - Minner(A(z))
        for _ in range(degree - 1):
            rho = 1.0 / (2.0 * sigma - rho_old)
            d = rho * rho_old * d + (2.0 * rho / delta) * resid
            z = z + d
            resid = resid - Minner(A(d))
            rho_old = rho
        return z

    return apply


def _lmax(A: Callable, Minner: Callable, v0: torch.Tensor,
          iters: int = 12, norm: Callable = torch.linalg.norm
          ) -> torch.Tensor:
    """Power-iteration estimate of the largest eigenvalue of Minner A
    (``norm`` of a rank's rows: the sum over the ranks)."""
    v = v0 / norm(v0)
    for _ in range(iters):
        w = Minner(A(v))
        v = (w / norm(w)).to(v.dtype)
    return norm(Minner(A(v)))


def start_vectors(n0: int, n1: int, dtype, device,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normal start vectors of the two power iterations.  The JAX
    package draws them from ``jax.random.PRNGKey(11)``; torch cannot
    reproduce those bits, so the port draws from a ``torch.Generator``
    seeded 11 unless one is given.  The default generator draws on the
    CPU, so every device starts from the same vectors."""
    if generator is None:
        generator = torch.Generator().manual_seed(11)
    v0 = torch.randn(n0, generator=generator, dtype=dtype,
                     device=generator.device)
    v1 = torch.randn(n1, generator=generator, dtype=dtype,
                     device=generator.device)
    return v0.to(device), v1.to(device)


@dataclasses.dataclass
class CoarseLevels:
    """The V-cycle's coarse operators, from ``coarse_levels``."""
    Bo: torch.Tensor        # (Na, S0, nd, nv) tentative prolongator
    blocks1: torch.Tensor   # (nv*nv, Na*Wc) level-1 slot planes
    Dinv1: torch.Tensor     # (Na, nv, nv) level-1 diagonal block inverses
    dense2: torch.Tensor    # (nv*nv, Na2*Na2) dense level-2 planes
    A2inv: torch.Tensor     # (Na2*nv, Na2*nv) inverse of the ridged level 2
    w1: torch.Tensor        # (Na2,) level-2 aggregate weights


def coarse_levels(maps: AMGMaps, blocks: torch.Tensor, cols: torch.Tensor,
                  coords: torch.Tensor, free_mask: torch.Tensor,
                  part=None) -> CoarseLevels:
    """The Galerkin products P^T A P of both coarse levels, each level's
    sums in one K1 planes launch (``segsum_planes``, plans cached on the
    maps): on the card, equal inputs give bit-equal levels.  With
    ``part`` (a rank's ``RowSplit``) ``blocks`` and ``cols`` are the
    rank's fine rows: the level-1 sums are the rank's partial sums, then
    one all-reduce, and both levels are the same on every rank."""
    nd, nv, Na, Wc, S0, S1, Na2, N = (maps.nd, maps.nv, maps.Na, maps.Wc,
                                      maps.S0, maps.S1, maps.Na2,
                                      maps.n_node)
    dt = blocks.dtype
    dev = blocks.device
    mt = maps.tensors(dev)
    plan01, plan12 = maps.plans(dev)
    Bo = _rigid_modes(maps, coords, free_mask, dt,
                      None if part is None else part.n_node)
    Bn = Bo.reshape(Na * S0, nd, nv)[:N]
    Bpl = Bn.permute(1, 2, 0)                             # (nd, nv, N)
    Brow = Bpl
    if part is not None:
        plan01 = maps.row_plan(dev, part.n0, part.n1)
        Brow = Bpl[:, :, part.n0:part.n1]
    # Galerkin level-1 blocks:
    #   C[n,w,p,q] = sum_ij Bn[n,i,p] A[n,w,i,j] Bn[cols[n,w],j,q]
    # as nv*nv (N, W) planes, segment-summed into the coarse slots:
    # blocks1[p*nv+q, a*Wc+w]
    S_jp = [[sum(Brow[i, p][:, None] * blocks[i * nd + j] for i in range(nd))
             for p in range(nv)] for j in range(nd)]
    Bcols = Bpl[:, :, cols]                               # (nd, nv, N, W)
    C = torch.stack([sum(S_jp[j][p] * Bcols[j, q] for j in range(nd))
                     .reshape(-1) for p in range(nv) for q in range(nv)])
    del Bcols, S_jp
    blocks1 = segmod.segsum_planes(C, plan01)
    del C
    if part is not None:
        blocks1 = part.comm.all_reduce_sum(blocks1)
    ar1 = torch.arange(nv, device=dev)
    D1 = blocks1.T[torch.arange(Na, device=dev) * Wc
                   + mt["diag_slot1"]].reshape(Na, nv, nv)
    tr1 = D1[:, ar1, ar1].sum(dim=1)
    # level 2 (dense coarsest): piecewise-constant over S1 coarse nodes
    cnt1 = torch.clamp(Na - torch.arange(Na2, device=dev) * S1,
                       min=1, max=S1).to(dt)
    w1 = 1.0 / torch.sqrt(cnt1)                           # (Na2,)
    wnode = w1[torch.clamp(torch.arange(Na, device=dev) // S1,
                           max=Na2 - 1)]
    sblk = (wnode[torch.arange(Na, device=dev).repeat_interleave(Wc)]
            * wnode[mt["cols1"].reshape(-1)])             # (Na*Wc,)
    dense2 = segmod.segsum_planes(blocks1 * sblk, plan12)
    A2 = dense2.reshape(nv, nv, Na2, Na2).permute(2, 0, 3, 1) \
        .reshape(Na2 * nv, Na2 * nv)
    d2 = torch.diagonal(A2)
    trs = tr1.sum()
    ridge = torch.where(trs > 0, trs / (Na * nv),
                        torch.ones_like(trs)) * 1e-6
    A2 = A2 + ridge * torch.eye(Na2 * nv, dtype=dt, device=dev)
    A2 = A2 + torch.diag((d2 == 0).to(dt))
    # inverted in float64 and rounded: in float32 an LU of this matrix
    # (condition up to ~1/ridge) loses the near-null modes' digits
    A2inv = torch.linalg.inv(A2.to(torch.float64)).to(dt)
    return CoarseLevels(Bo=Bo, blocks1=blocks1, Dinv1=_block_inv(D1),
                        dense2=dense2, A2inv=A2inv, w1=w1)


def setup_amg(maps: AMGMaps, blocks: torch.Tensor, cols: torch.Tensor,
              coords: torch.Tensor, free_mask: torch.Tensor,
              A0: Callable, Dinv0_apply: Callable,
              deg0: int = 2, deg1: int = 4,
              generator: Optional[torch.Generator] = None,
              start: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              part=None):
    """Build the V-cycle preconditioner.

    A0: the constrained fine operator (node-major flat vectors).
    Dinv0_apply: fine block-Jacobi apply.
    blocks: scalar ELL block planes (nd*nd, N, W), plane p = i*nd + j.
    cols: (N, W) int64 scalar ELL columns.
    start: optional (v0 (N*nd,), v1 (Na*nv,)) power-iteration start
    vectors; else drawn by ``start_vectors`` from ``generator``.
    part: a rank's ``RowSplit`` (``parallel/shard.py``): level 0 is
    row-sharded (``blocks``, ``cols``, ``A0``, ``Dinv0_apply`` and M's
    vectors are the rank's rows; ``coords`` and ``free_mask`` stay whole),
    the coarse levels are replicated: a rank restricts its rows into the
    level-1 vector, the ranks all-reduce it, every rank solves the coarse
    levels and prolongs back its own rows.
    Returns M(r) for node-major flat vectors of the blocks' dtype.
    """
    nd, nv, Na, Wc, S0, S1, Na2, N = (maps.nd, maps.nv, maps.Na, maps.Wc,
                                      maps.S0, maps.S1, maps.Na2,
                                      maps.n_node)
    dt = blocks.dtype
    dev = blocks.device
    cols1 = maps.tensors(dev)["cols1"]
    lv = coarse_levels(maps, blocks, cols, coords, free_mask, part)
    Bo, Dinv1, A2inv, w1 = lv.Bo, lv.Dinv1, lv.A2inv, lv.w1
    blocks1 = lv.blocks1.reshape(nv, nv, Na, Wc)
    del lv
    npad1 = Na2 * S1

    def A1(x):
        xg = x.reshape(Na, nv).T[:, cols1]                # (nv, Na, Wc)
        return torch.einsum("pqaw,qaw->ap", blocks1, xg).reshape(-1)

    def M1(r):
        return torch.einsum("apq,aq->ap", Dinv1,
                            r.reshape(Na, nv)).reshape(-1)

    # transfer operators, mode-major: (nv, Na, S0*nd)
    Bt = Bo.reshape(Na, S0 * nd, nv).permute(2, 0, 1).contiguous()

    def restrict0(d):                                     # (N*nd)->(Na*nv)
        dpa = torch.nn.functional.pad(d, (0, Na * S0 * nd - N * nd)) \
            .reshape(Na, S0 * nd)
        return (Bt * dpa).sum(dim=2).T.reshape(-1)

    def prolong0(xc):                                     # (Na*nv)->(N*nd)
        xn = xc.reshape(Na, nv)
        y = (Bt * xn.T[:, :, None]).sum(dim=0)
        return y.reshape(-1)[:N * nd]

    def restrict1(d):                                     # (Na*nv)->(n2)
        dp = torch.nn.functional.pad(d.reshape(Na, nv),
                                     (0, 0, 0, npad1 - Na))
        return (dp.reshape(Na2, S1, nv).sum(dim=1)
                * w1[:, None]).reshape(-1)

    def prolong1(x2):
        y = (x2.reshape(Na2, nv) * w1[:, None]).repeat_interleave(
            S1, dim=0)[:Na]
        return y.reshape(-1)

    if start is None:
        # a sharded run draws the unpadded model's vectors, as one device
        # does, and starts its padded rows at 0: the same estimates
        n_draw = N if part is None else part.n_node
        v0, v1 = start_vectors(n_draw * nd, Na * nv, dt, dev, generator)
        start = (torch.nn.functional.pad(v0, (0, (N - n_draw) * nd)), v1)
    v0, v1 = (v.to(dtype=dt, device=dev) for v in start)
    fm = free_mask.to(dt)
    norm0 = torch.linalg.norm
    if part is not None:
        restrict0, prolong0 = _row_transfer(Bt, part, Na, S0, nd, nv)
        v0 = v0[part.n0 * nd:part.n1 * nd]
        fm = fm[part.n0 * nd:part.n1 * nd]

        def norm0(v):
            return torch.sqrt(part.dot(v, v))
    cheb0 = _cheb(A0, Dinv0_apply, _lmax(A0, Dinv0_apply, v0, norm=norm0),
                  deg0)
    cheb1 = _cheb(A1, M1, _lmax(A1, M1, v1), deg1)

    def M(r):
        r0 = r * fm
        x0 = cheb0(r0)
        r1 = restrict0(r0 - A0(x0))
        x1 = cheb1(r1)
        r2 = restrict1(r1 - A1(x1))
        x2 = A2inv @ r2
        x1 = x1 + prolong1(x2)
        x1 = x1 + cheb1(r1 - A1(x1))
        x0 = x0 + prolong0(x1)
        x0 = x0 + cheb0(r0 - A0(x0))
        return x0 * fm + r * (1.0 - fm)

    return M


def _row_transfer(Bt: torch.Tensor, part, Na: int, S0: int, nd: int,
                  nv: int):
    """Level 0 <-> 1 transfers of a rank's node rows [n0, n1): the
    aggregates those rows touch (they may straddle a rank boundary)
    restrict into the whole level-1 vector, all-reduced over the ranks;
    the prolongation of the replicated level-1 vector is kept on the
    rank's rows."""
    n0, n1 = part.n0, part.n1
    a0, a1 = n0 // S0, min(-(-n1 // S0), Na)
    off = (n0 - a0 * S0) * nd
    rows = (n1 - n0) * nd
    Btl = Bt[:, a0:a1]

    def restrict0(d):
        dpa = d.new_zeros((a1 - a0) * S0 * nd)
        dpa[off:off + rows] = d
        loc = (Btl * dpa.reshape(a1 - a0, S0 * nd)).sum(dim=2).T
        full = d.new_zeros((Na, nv))
        full[a0:a1] = loc
        return part.comm.all_reduce_sum(full.reshape(-1))

    def prolong0(xc):
        xn = xc.reshape(Na, nv)[a0:a1]
        y = (Btl * xn.T[:, :, None]).sum(dim=0)
        return y.reshape(-1)[off:off + rows]

    return restrict0, prolong0


def eligible_maps(profile, n_dof_total: int,
                  policy: Optional[str] = None) -> Optional[AMGMaps]:
    """AMG maps for an ELL profile if eligible, else None (block-Jacobi).

    Eligible: a node-block dof count with rigid-body modes (1/2/3), at
    least FRONTISTR_TPU_AMG_MIN dofs (default 30k) and no
    FRONTISTR_TPU_PRECOND forcing jacobi.  Cached on the profile."""
    pol = policy or os.environ.get("FRONTISTR_TPU_PRECOND", "auto")
    if pol in ("jacobi", "diag", "ssor"):
        return None
    min_dof = int(os.environ.get("FRONTISTR_TPU_AMG_MIN", "30000"))
    if pol != "amg" and n_dof_total < min_dof:
        return None
    if _n_modes(profile.ndof) == 0:
        return None
    maps = profile.__dict__.get("_amg_maps")
    if maps is None:
        maps = build_maps(profile.cols, profile.n_node, profile.ndof)
        profile.__dict__["_amg_maps"] = maps
    return maps
