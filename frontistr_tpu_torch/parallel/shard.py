"""Row-sharded solves (torch port of ``frontistr_tpu/parallel/shard.py``
and of the ``nshard`` arms of the JAX package's solvers).

The JAX package shards every operator array over a 1-D device mesh and
lets GSPMD insert the collectives: an all-gather of x before the sparse
row product (a replicated gather source: 8 MB in float64 at 1M dofs)
and a psum per dot.  The port keeps that layout with one process a
device (``parallel/dist.py``):

- nodes are padded to a multiple of 8 n (G = 8 nodes a cluster, n
  ranks, as ``frontistr_tpu/analysis/nonlinear.py:1049`` pads them);
  padded rows are inert (no entries, ``free`` = 0) and rank r owns the
  contiguous node rows [r Np/n, (r+1) Np/n) (``RowSplit``);
- a rank keeps every element that touches its rows (the overlap of the
  reference's node-based partitions, ``local_model``) and assembles its
  own rows of the cluster-ELL slot planes through K1 over its part of
  the sorted pair list (``bell.build_row_cluster_profile``);
- a product all-gathers x, then runs the rank's rows; a dot is the
  rank's partial sum, all-reduced (``RowSplit.dot``, the Krylov
  solvers' ``dot`` hook); block-Jacobi is row-local;
- the AMG's level 0 is row-sharded and its coarse levels replicated
  (``solver/amg.py``, ``part=``);
- the float64 matrix-free residual (``femop.FEOperator``) runs over the
  rank's elements, right on its rows;
- !EQUATION: the elimination runs on whole vectors, every rank the same
  (T maps dofs across ranks), around the sharded products.

The drivers see whole vectors: a sharded solve takes and returns them
(every rank the same), so the Newton, Newmark, Lanczos and heat loops
around it are unchanged.  An explicit halo exchange over the partition
tables would move fewer bytes than the all-gather; it is not ported
yet (ROADMAP, queue 1b).
"""

from __future__ import annotations

import dataclasses
import time
import types
from typing import Callable, List, Optional

import numpy as np
import torch

from frontistr_tpu_torch.assembly import bell, ell, extras, femop
from frontistr_tpu_torch.assembly import operators as old_ops
from frontistr_tpu_torch.assembly import profcache
from frontistr_tpu_torch.assembly import segsum as segmod
from frontistr_tpu_torch.device import Phase
from frontistr_tpu_torch.parallel import dist
from frontistr_tpu_torch.parallel.dist import Comm
from frontistr_tpu_torch.solver import amg as amgmod
from frontistr_tpu_torch.solver.cg import pcg
from frontistr_tpu_torch.solver.mixed import refined_cg

G = 8                     # nodes a cluster (assembly/bell.py)


def ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass
class RowSplit:
    """A rank's node rows of a model of ``n_node`` nodes x ``nd`` dofs,
    padded to ``n_pad`` = a multiple of 8 ranks."""
    comm: Comm
    n_node: int
    nd: int
    n_pad: int
    n0: int
    n1: int

    @property
    def rows(self) -> int:
        return self.n1 - self.n0

    @property
    def n1_real(self) -> int:
        return max(min(self.n1, self.n_node), self.n0)

    def own(self, v: torch.Tensor) -> torch.Tensor:
        """The rank's rows (rows * nd,) of a whole (n_node * nd,) vector,
        padded rows 0."""
        nd = self.nd
        seg = v[self.n0 * nd:self.n1_real * nd]
        pad = self.rows * nd - seg.numel()
        return torch.nn.functional.pad(seg, (0, pad)) if pad else seg

    def gather_pad(self, v_own: torch.Tensor) -> torch.Tensor:
        """The padded whole vector (n_pad * nd,) from every rank's rows."""
        return self.comm.all_gather_rows(v_own)

    def gather(self, v_own: torch.Tensor) -> torch.Tensor:
        """The whole vector (n_node * nd,) from every rank's rows."""
        return self.gather_pad(v_own)[:self.n_node * self.nd]

    def embed(self, v_own: torch.Tensor) -> torch.Tensor:
        """A whole vector holding the rank's rows, 0 elsewhere."""
        nd = self.nd
        out = v_own.new_zeros(self.n_node * nd)
        k = (self.n1_real - self.n0) * nd
        out[self.n0 * nd:self.n0 * nd + k] = v_own[:k]
        return out

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.comm.all_reduce_sum(torch.dot(a, b))

    def whole(self, A_own: Callable) -> Callable:
        """A rank-row operator as an operator on whole vectors, every
        rank the same (the !EQUATION arms)."""
        return lambda x: self.gather(A_own(self.own(x)))


def row_split(comm: Comm, n_node: int, nd: int) -> RowSplit:
    n_pad = ceil_to(max(n_node, 1), G * comm.size)
    per = n_pad // comm.size
    return RowSplit(comm, n_node, nd, n_pad, comm.rank * per,
                    (comm.rank + 1) * per)


def current_split(n_node: int, nd: int) -> Optional[RowSplit]:
    """This rank's split of the model, None outside a sharded run."""
    comm = dist.current()
    return None if comm is None else row_split(comm, n_node, nd)


# ---------------- the rank's elements --------------------------------------


@dataclasses.dataclass
class LocalModel:
    """The elements of a model that touch a rank's rows."""
    model: object               # the StructModel of those elements
    sel: List[np.ndarray]       # per block: their indices in the block
    owned: List[np.ndarray]     # per block: owned here (bool; each
    #   element is owned by the rank of its lowest node)


def _touch(conn: np.ndarray, n0: int, n1: int):
    c = np.asarray(conn)
    if c.shape[0] == 0:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    sel = np.flatnonzero(((c >= n0) & (c < n1)).any(axis=1))
    low = c[sel].min(axis=1)
    return sel, (low >= n0) & (low < n1)


def _sub_block(b, sel: np.ndarray):
    E = b.conn.shape[0]

    def pick(a):
        a = np.asarray(a)
        return a[sel] if a.ndim and a.shape[0] == E and E > 1 else a

    return dataclasses.replace(b, elem_ids=b.elem_ids[sel],
                               conn=b.conn[sel], dofs=b.dofs[sel],
                               D=pick(b.D), density=pick(b.density))


def local_model(model, split: RowSplit) -> LocalModel:
    n0, n1 = split.n0, split.n1_real
    blocks, sel, owned = [], [], []
    for b in model.blocks:
        s, o = _touch(b.conn, n0, n1)
        blocks.append(_sub_block(b, s))
        sel.append(s)
        owned.append(o)
    econns, edofs, ekes, enns = getattr(model, "extras", ([], [], [], []))
    ex = ([], [], [], list(enns))
    for c, d, k in zip(econns, edofs, ekes):
        s, _ = _touch(c, n0, n1)
        for out, a in zip(ex, (c, d, k)):
            out.append(np.asarray(a)[s])
    lm = dataclasses.replace(model, blocks=blocks, extras=tuple(ex))
    return LocalModel(lm, sel, owned)


# ---------------- the row-sharded constrained solve ------------------------


class RowSolver:
    """A rank's part of the constrained solve

        P K P x + (I-P) x = (B - K d) * P + d * (I-P),  d = dirichlet_inc

    (the sharded arm of ``make_constrained_solver``, of linear STATIC,
    of the Newmark effective solve and of the Lanczos apply): the
    cluster-ELL rows assembled by K1, the AMG (row-sharded level 0) or
    block-Jacobi, CG (float64) or the refined CG (mixed: float32 cluster
    CG, float64 residuals of the rank's matrix-free rows).
    ``eff=(c1, c2)`` with the lumped ``mass`` solves c1 K + c2 M under
    block-Jacobi (as one device's dynamics does); ``tol`` replaces
    RESID.  ``__call__(kes, B, dirichlet_inc, gfac)`` takes the element
    matrices of ``lm`` (or, with ``select``, of the whole model, picked
    here) and whole vectors; it returns the whole solution, the same on
    every rank."""

    def __init__(self, model, lm: LocalModel, split: RowSplit,
                 free: torch.Tensor, mixed: bool, timings: dict,
                 policy: Optional[str] = None, select: bool = False,
                 eff=None, mass: Optional[torch.Tensor] = None,
                 tol: Optional[float] = None):
        self.model, self.lm, self.split = model, lm, split
        self.mixed, self.timings, self.select = mixed, timings, select
        dev = self.dev = model.device
        nd, Np = model.ndof, split.n_pad
        sv = model.cfg.solver
        self.tol = sv.resid if tol is None else tol
        self.nier = sv.nier
        self.eff, self.mass = eff, mass
        if eff is not None:
            policy = "jacobi"
            self.mass_own = split.own(mass)
        with Phase(timings, "profile", dev):
            with profcache.rank_zero_first():
                prof = ell.profile_from_model(model, n_node=Np)
            self.amaps = amgmod.eligible_maps(prof, Np * nd, policy=policy)
            cols_own = np.ascontiguousarray(prof.cols[split.n0:split.n1])
            conns = ell.model_conns(lm.model)
            self.cprof = bell.build_row_cluster_profile(
                conns, Np, nd, split.n0, split.n1, cols_own)
            self.plan = self.cprof.plan(dev)
            self.scalar = types.SimpleNamespace(cols=cols_own)
            self.cols_own = torch.as_tensor(cols_own, dtype=torch.int64,
                                            device=dev)
            self.ccols = self.cprof.tensor("ccols", dev)
            self.nns = [c.shape[1] for c in conns]
        coords = torch.as_tensor(np.asarray(model.coords), device=dev)
        self.coords = torch.nn.functional.pad(
            coords, (0, 0, 0, Np - model.n_node))
        self.free = free
        self.free_pad = torch.nn.functional.pad(
            free, (0, (Np - model.n_node) * nd))
        self.free_own = split.own(free)
        ex_kes, ex_dofs = extras.extra_tensors(lm.model, dev)
        self.ex_kes = ex_kes
        self.dofs = [torch.as_tensor(b.dofs, dtype=torch.int64, device=dev)
                     for b in lm.model.blocks] + ex_dofs
        self.gather = femop.incidence_gather(lm.model, dev)
        self.mpc = extras.mpc_arrays(model.mesh, nd, model.n_dof_total, dev)
        self.sel_t = [torch.as_tensor(s, device=dev) for s in lm.sel]
        self.last_iters = self.last_passes = 0
        self.last_relres = float("nan")

    def local_kes(self, kes) -> list:
        kes = list(kes)
        if self.select:
            kes = [k[s] for k, s in zip(kes, self.sel_t)]
        return kes

    def cluster(self, kes_loc, dtype):
        """The rank's K1-assembled rows in ``dtype``: (A, M) on its rows."""
        sp, cp, nd = self.split, self.cprof, self.model.ndof
        dev = self.dev
        with Phase(self.timings, "assembly", dev):
            kes = [k.to(dtype).contiguous() for k in
                   list(kes_loc) + self.ex_kes]
            raw = segmod.segsum(self.plan, kes, self.nns, nd)
            blocks = bell._planes_to_blocks(raw, nd, cp.G, cp.Wc, cp.C)
            diag = bell.extract_diag(cp, raw)
            fm = self.free_own.to(dtype)
            m = cp.G * nd
            ccols, Cg = self.ccols, sp.n_pad // cp.G
            c2m = None
            if self.eff is not None:
                c1, c2 = self.eff
                blocks, diag = blocks * c1, diag * c1
                c2m = (c2 * self.mass_own).to(dtype)
                ar = torch.arange(nd, device=dev)
                diag[:, ar, ar] += c2m.reshape(-1, nd)

            def A(x):
                xm = x * fm
                xg = sp.gather_pad(xm).reshape(Cg, m)[ccols]
                y = torch.einsum("abwc,bwc->ac", blocks, xg.permute(2, 1, 0))
                y = y.T.reshape(-1)
                if c2m is not None:
                    y = y + c2m * xm
                return y * fm + x * (1.0 - fm)

            Mj = bell.block_jacobi_apply(diag, fm)
        with Phase(self.timings, "amg_setup", dev):
            if self.amaps is None:
                return A, Mj
            sb = bell.extract_scalar_blocks(cp, raw, self.scalar)
            return A, amgmod.setup_amg(self.amaps, sb, self.cols_own,
                                       self.coords.to(dtype),
                                       self.free_pad.to(dtype), A, Mj,
                                       part=sp)

    def residual_op(self, kes_loc) -> femop.FEOperator:
        """The float64 matrix-free operator of the rank's elements: right
        on its rows."""
        return femop.FEOperator(list(kes_loc) + self.ex_kes, self.dofs,
                                self.gather, self.model.n_node,
                                self.model.ndof, self.free)

    def __call__(self, kes, B, dirichlet_inc, gfac=0.0):
        sp = self.split
        kes_loc = self.local_kes(kes)
        op = self.residual_op(kes_loc)
        mv = op.matvec
        if self.eff is not None:
            c1, c2 = self.eff

            def mv(x):
                return c1 * op.matvec(x) + c2 * self.mass * x
        free, d = self.free, dirichlet_inc
        b_c = sp.own((B - mv(d)) * free + d * (1.0 - free))
        dtype = torch.float32 if self.mixed else torch.float64
        A, M = self.cluster(kes_loc, dtype)
        fm = self.free_own

        def A64(x):
            y = sp.own(mv(sp.gather(x * fm)))
            return y * fm + x * (1.0 - fm)

        dot = sp.dot
        mpc = self.mpc
        if mpc is not None:
            # the elimination on whole vectors, the same on every rank
            A, A64, M = sp.whole(A), sp.whole(A64), sp.whole(M)
            b_c = extras.mpc_reduce_rhs(mpc, A64, sp.gather(b_c), gfac)
            A, A64 = extras.mpc_wrap(mpc, A), extras.mpc_wrap(mpc, A64)
            M = extras.mpc_precond(mpc, M)
            dot = torch.dot
        with Phase(self.timings, "solve", self.dev):
            if self.mixed:
                res = refined_cg(A64, A, M, b_c, tol=self.tol,
                                 inner_tol=1e-6, maxiter=self.nier,
                                 max_passes=6, dot=dot)
                self.last_passes = res.passes
            else:
                res = pcg(A, b_c, M=M, tol=self.tol, maxiter=self.nier,
                          dot=dot)
                self.last_passes = 0
            x = extras.mpc_recover(mpc, res.x, gfac) if mpc is not None \
                else sp.gather(res.x)
        self.last_iters = int(res.iters)
        self.last_relres = float(res.relres)
        self.last = res
        return x


def check_policy(method: str, policy: Optional[str]) -> None:
    """The arms the sharded solve does not run raise, naming themselves."""
    if method not in ("CG", "1"):
        raise NotImplementedError(f"!SOLVER METHOD={method} under "
                                  "FRONTISTR_TPU_SHARDS")
    if policy == "ssor":
        raise NotImplementedError("the SSOR preconditioner under "
                                  "FRONTISTR_TPU_SHARDS")


def sharded_solve_linear(model, kes, f: torch.Tensor, u_fix: torch.Tensor,
                         mixed: bool, timings: dict):
    """Linear STATIC under FRONTISTR_TPU_SHARDS (``static.py:228-240`` of
    the JAX package): the row-sharded cluster solve of the whole model's
    element matrices, the !EQUATION arm included.  Returns (x (n_dof,)
    host array, iterations, relres, refinement passes)."""
    split = current_split(model.n_node, model.ndof)
    lm = local_model(model, split)
    free = torch.as_tensor(old_ops.make_free_mask(model.n_dof_total,
                                                  model.fixed_dofs),
                           dtype=torch.float64, device=model.device)
    solver = RowSolver(model, lm, split, free, mixed, timings,
                       select=True)
    x = solver(kes, f, u_fix, 1.0)
    return x.cpu().numpy(), solver.last_iters, solver.last_relres, \
        solver.last_passes


# ---------------- row-sharded matrix-free CG -------------------------------


def row_pcg(split: RowSplit, A: Callable, b: torch.Tensor,
            M: Callable, tol: float, maxiter: int, mpc=None,
            gfac: float = 1.0):
    """CG on a matrix-free operator whose whole-vector apply ``A`` (and
    preconditioner ``M``, node-local) is right on the rank's rows (the
    rank's elements; heat, at one dof a node, which K1 has no entry
    for): the rows sharded, x all-gathered before each apply, the dots
    all-reduced.  With !EQUATION tables the elimination runs on whole
    vectors around the sharded apply.  Returns (whole x, CGResult)."""
    A_own = lambda x: split.own(A(split.gather(x)))       # noqa: E731
    M_own = lambda r: split.own(M(split.embed(r)))       # noqa: E731
    if mpc is None:
        res = pcg(A_own, split.own(b), M=M_own, tol=tol, maxiter=maxiter,
                  dot=split.dot)
        return split.gather(res.x), res
    Aw, Mw = split.whole(A_own), split.whole(M_own)
    b = extras.mpc_reduce_rhs(mpc, Aw, b, gfac)
    res = pcg(extras.mpc_wrap(mpc, Aw), b, M=extras.mpc_precond(mpc, Mw),
              tol=tol, maxiter=maxiter)
    return res.x, res


# ---------------- a whole-vector operator of the rank's elements -----------


@dataclasses.dataclass
class RowFEOperator(femop.FEOperator):
    """``femop.FEOperator`` of a rank's elements whose products come back
    whole: the rank's rows from its elements, the others all-gathered
    (the contact arms, whose Krylov vectors and contact tables stay
    whole on every rank, as the JAX package's replicated slot tables)."""
    split: Optional[RowSplit] = None

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.split.gather(self.split.own(super().matvec(x)))

    def diag_blocks(self) -> torch.Tensor:
        D = super().diag_blocks()
        sp = dataclasses.replace(self.split, nd=self.ndof * self.ndof)
        return sp.gather(sp.own(D.reshape(-1))).reshape(D.shape)


def row_operator(model, split: RowSplit):
    """``operator(kes, free)`` building the ``RowFEOperator`` of the
    rank's elements from the whole model's element matrices (the spring
    blocks of the rank's rows appended)."""
    dev = model.device
    lm = local_model(model, split)
    sel = [torch.as_tensor(s, device=dev) for s in lm.sel]
    ex_kes, ex_dofs = extras.extra_tensors(lm.model, dev)
    dofs = [torch.as_tensor(b.dofs, dtype=torch.int64, device=dev)
            for b in lm.model.blocks] + ex_dofs
    gather = femop.incidence_gather(lm.model, dev)

    def operator(kes, free):
        return RowFEOperator([k[s] for k, s in zip(kes, sel)] + ex_kes,
                             dofs, gather, model.n_node, model.ndof, free,
                             split=split)
    return operator


# ---------------- the Newton driver's element ownership --------------------


def owns_elements(model) -> bool:
    """Whether the Newton driver keeps only its rank's elements (the
    counterpart of ``_maybe_engine``'s conditions): solid blocks with a
    continuum state, no follower load (its load is re-assembled on the
    whole model), no rotational boundary, no contact (the contact arms
    take the whole model's element matrices)."""
    if model.nlgeom and model.dload_grp is not None:
        return False
    if model.mesh.contact_pairs and model.cfg.contacts:
        return False
    if model.rot_bcs:
        return False
    return all(b.kind == "solid" for b in model.blocks)


@dataclasses.dataclass
class NewtonShard:
    """What the Newton driver of one rank holds: its split, its
    elements (``lm``), whether it owns them (else the driver keeps the
    whole model and the solver picks the rank's elements)."""
    split: RowSplit
    lm: LocalModel
    owned: bool
    owned_t: list               # ``lm.owned`` on the model's device
    whole: object               # the whole StructModel

    def sync(self, v: torch.Tensor) -> torch.Tensor:
        """A whole vector right on the rank's rows, made right
        everywhere (an all-gather of the rows)."""
        return self.split.gather(self.split.own(v)) if self.owned else v

    def yielded(self, states) -> torch.Tensor:
        """The yielded gauss points of the owned elements, summed over
        the ranks (each element counted once)."""
        tot = torch.zeros((), dtype=torch.float64,
                          device=self.split.comm.device)
        for s, o in zip(states, self.owned_t):
            if s:
                y = s["yielded"]
                tot = tot + y.reshape(y.shape[0], -1)[o].sum().to(tot.dtype)
        return self.split.comm.all_reduce_sum(tot)

    def post(self, result):
        """A ``StaticResult`` of the rank's elements (right on its nodes
        and owned elements) made whole: nodal rows and owned elements
        gathered from every rank (host arrays, every rank the same)."""
        if not self.owned:
            return result
        sp, comm = self.split, self.split.comm
        r0, r1 = sp.n0, sp.n1_real
        nodal = ("nodal_strain", "nodal_stress", "nodal_mises",
                 "node_count")
        mine = {k: np.asarray(getattr(result, k))[r0:r1] for k in nodal}
        ne = [len(s) for s in self.lm.sel]
        offs = np.concatenate([[0], np.cumsum(ne)]).astype(np.int64)
        el = {}
        for k in ("elem_strain", "elem_stress", "elem_mises"):
            a = np.asarray(getattr(result, k))
            el[k] = [a[offs[i]:offs[i + 1]][o]
                     for i, o in enumerate(self.lm.owned)]
        ids = [s[o] for s, o in zip(self.lm.sel, self.lm.owned)]
        got = comm.all_gather_object((mine, el, ids))
        full = {k: np.concatenate([g[0][k] for g in got]) for k in nodal}
        model = self.whole
        for k in ("elem_strain", "elem_stress", "elem_mises"):
            blocks = []
            for i, b in enumerate(model.blocks):
                first = got[0][1][k][i]
                out = np.zeros((b.conn.shape[0],) + first.shape[1:],
                               first.dtype)
                for g in got:
                    out[g[2][i]] = g[1][k][i]
                blocks.append(out)
            full[k] = np.concatenate(blocks)
        full["elem_ids"] = np.concatenate([b.elem_ids for b in
                                           model.blocks])
        return dataclasses.replace(result, **full)


def newton_shard(model) -> Optional[NewtonShard]:
    """The rank's Newton context in a sharded run, else None."""
    split = current_split(model.n_node, model.ndof)
    if split is None:
        return None
    t0 = time.perf_counter()
    lm = local_model(model, split)
    owned = owns_elements(model)
    sh = NewtonShard(split, lm, owned,
                     [torch.as_tensor(o, device=model.device)
                      for o in lm.owned], model)
    ne = sum(len(s) for s in lm.sel)
    print(f"### shard rank {split.comm.rank}/{split.comm.size} "
          f"({split.comm.backend}): rows {split.n0}-{split.n1} of "
          f"{split.n_pad} nodes, {ne} elements "
          f"({'owned' if owned else 'whole model kept'}), "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return sh
