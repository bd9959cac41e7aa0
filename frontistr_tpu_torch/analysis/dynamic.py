"""Implicit (Newmark-beta) and explicit (central difference) dynamics
(torch port of the single-device solid slice of
``frontistr_tpu/analysis/dynamic.py``; reference
fistr1/src/analysis/dynamic/transit/):

  implicit (fstr_dynamic_nlimplicit.f90:98-370):
    a1=0.5/b-1, a2=1/(b dt), a3=1/(b dt^2), b1=(0.5 g/b-1)dt, b2=g/b-1,
    b3=g/(b dt), c1=1+ray_k b3, c2=a3+ray_m b3
    predictors VEC1=a1 ACC+a2 VEL, VEC2=b1 ACC+b2 VEL
    Newton: B = F(t) - Q + M(VEC1 - a3 du + ray_m X) + ray_k K X,
            K_eff = c1 K + c2 M;  res = sqrt(|B|^2/|B1|^2) < converg
    post:   ACC' = -a1 ACC - a2 VEL + a3 du; VEL' = -b1 ACC - b2 VEL + b3 du
  explicit (fstr_dynamic_nlexplicit.f90:95-296):
    VEC1 = (1/dt^2 + ray_m/(2dt)) m;  u_{n+1} = B/VEC1 with
    B = F - Q + 2/dt^2 m u_n + (-1/dt^2 + ray_m/(2dt)) m u_{n-1}

Loads are scaled by !AMPLITUDE tables at t (clamped linear
interpolation, table_dyn.f90).  The mass is the HRZ-lumped diagonal
(``lumped_mass_vector``; a consistent-mass request gets it too, as in
the JAX package); shells, solid-shells and beams take an equal split of
their element mass, translations only, no rotary inertia, so a 6-dof
model runs the implicit arm only (the explicit one refuses with the
JAX package's message).

The JAX package runs a linear implicit deck, and any explicit deck, as
one ``lax.scan`` program (``FRONTISTR_TPU_IMPLICIT_SCAN`` /
``FRONTISTR_TPU_EXPLICIT_SCAN`` = 0 select its eager loops).  Here a step
train is a Python loop over device tensors with no host synchronisation
inside an explicit step: the load vectors are built once, amplitude
factors are host floats of the step's time, and the monitor rows go to a
device buffer read back once at the end.  The JAX package's two explicit
arms compute the same values, so one loop serves both here.  The
implicit arms keep the JAX package's conditions and switch: the linear
arm (K0 once, one effective solve a step) and the Newton loop (a
tangent and a solve per iteration; nonlinear decks, per-interval
output).  The only host reads of an implicit step are CG's convergence
scalar and the Newton residual norm.

The effective system c1 K + c2 M is solved by a block-Jacobi PCG on the
matrix-free ``femop.FEOperator`` (tol = RESID, maxiter = NIER), with
!EQUATION eliminated around it (``assembly/extras.py``); METHOD=DIRECT
factors it on the host (``solver/direct.py``), or with
FRONTISTR_TPU_DIRECT=band on the device (``solver/band.py``).  A contact
deck takes the Newton loop with the static analysis's SLAGRANGE or penalty
arm on c1 K + c2 M (``nonlinear.ContactState``): every pass restarts the
step's increment, the SLAGRANGE active set frozen for the pass.  !RESTART
checkpoints the implicit run every FREQUENCY steps (u, vel, acc, the
gauss states and a contact deck's multipliers and released slots) and
resumes from it; the explicit run ignores the card, as the JAX package's
does.  !COUPLE with FRONTISTR_TPU_COUPLE_DIR couples the run to a peer
code through ``couple/rcap.py`` (the peer's traction before each step,
the interface motion after it; such a run takes the Newton loop, not the
linear step train). In a sharded run (``parallel/dist.py``) the implicit
effective solve is row-sharded (``shard.RowSolver``: the rank's rows of
c1 K + c2 M assembled by K1 from its elements, block-Jacobi, the dots
all-reduced; a contact deck's arms over ``shard.RowFEOperator``); the
explicit run, !RESTART and a direct method there raise
``NotImplementedError`` naming themselves. What the JAX package also
runs in dynamics and the port does not yet (frequency response) raises
``NotImplementedError`` naming itself, and so do the cards the JAX
package's dynamics drop without effect: !EQUATION and !CONTACT in an
explicit run, !SPRING (ROADMAP, queue 3, fault 2).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from frontistr_tpu_torch.analysis.nonlinear import (BlockPrograms,
                                                    ContactState,
                                                    check_log,
                                                    _all_linear,
                                                    _commit_state,
                                                    _element_values,
                                                    _postprocess,
                                                    _qforce,
                                                    device_states,
                                                    host_states,
                                                    init_block_state)
from frontistr_tpu_torch.analysis.static import StaticResult
from frontistr_tpu_torch.assembly import extras, femop, loads
from frontistr_tpu_torch.assembly import operators as old_ops
from frontistr_tpu_torch.assembly.model import StructModel, collect_cload
from frontistr_tpu_torch.couple.rcap import driver_from_env
from frontistr_tpu_torch.device import Phase
from frontistr_tpu_torch.elements.quadhi import mass_tables
from frontistr_tpu_torch.fem.isoparam import det_inv_small
from frontistr_tpu_torch.io import logio
from frontistr_tpu_torch.io.restart import load_restart, save_restart
from frontistr_tpu_torch.parallel import dist
from frontistr_tpu_torch.parallel import shard as shardmod
from frontistr_tpu_torch.post.shellpost import check_recoverable
from frontistr_tpu_torch.solver import direct
from frontistr_tpu_torch.solver.band import BandCholesky
from frontistr_tpu_torch.solver.cg import pcg

F64 = torch.float64


def lumped_mass_vector(model: StructModel, gather=None) -> torch.Tensor:
    """Global lumped mass per dof on ``model.device``: HRZ diagonal
    scaling m_i = (int rho N_i^2) * M_elem / sum_j (int rho N_j^2) with
    the high-order rules of ``elements/quadhi.py`` (setMASS kernels,
    eigen_LIB_3d*mass.f90 -- the 'ss(num)*(2*totmass-totdiag)/totdiag'
    scaling), summed per node through the incidence ``gather``
    (``femop.incidence_gather``) in element order."""
    dev, nd = model.device, model.ndof
    if gather is None:
        gather = femop.incidence_gather(model, dev)
    coords = torch.as_tensor(model.coords, dtype=F64, device=dev)
    rows = []
    for b in model.blocks:
        if b.kind != "solid":
            me = torch.as_tensor(_struct_elem_mass(model, b), device=dev)
            rows.append(_node_rows(me, nd))
            continue
        N, dN, w = (torch.as_tensor(a, dtype=F64, device=dev)
                    for a in mass_tables(b.etype))
        ce = coords[torch.as_tensor(b.conn, dtype=torch.int64, device=dev)]
        J = torch.einsum("qni,enj->eqij", dN, ce)
        det = det_inv_small(J)[0].abs()
        rho = torch.as_tensor(b.density, dtype=F64, device=dev)
        # a 2-D block integrates over its section's thickness
        wdet = w[None, :] * det * (b.thick if model.dim == 2 else 1.0)
        mii = torch.einsum("qn,eq->en", N * N, wdet) * rho[:, None]
        total = wdet.sum(dim=1) * rho                         # element mass
        diag_sum = mii.sum(dim=1)
        me = mii * (total / torch.where(diag_sum == 0, 1.0,
                                        diag_sum))[:, None]
        rows.append(_node_rows(me, nd))
    return femop.gather_sum(rows, gather)


def _node_rows(me: torch.Tensor, nd: int) -> torch.Tensor:
    """Element-node masses (E, nn) as element rows (E, nn*nd): every
    dof of a node, or, on a 6-dof model, the translations only -- no
    rotary inertia (fstr_EIG_setMASS.f90:163-231; the rotary terms are
    commented out in the reference too)."""
    rep = me[:, :, None].expand(-1, -1, nd)
    if nd == 6:
        rep = rep * torch.as_tensor([1.0, 1, 1, 0, 0, 0], dtype=me.dtype,
                                    device=me.device)
    return rep.reshape(len(me), -1)


def _tri_area(x0, x1, x2) -> np.ndarray:
    return 0.5 * np.linalg.norm(np.cross(x1 - x0, x2 - x0), axis=1)


def _struct_elem_mass(model: StructModel, b) -> np.ndarray:
    """Equal-split element mass (E, nn) of a shell, solid-shell or beam
    block (fstr_EIG_setMASS.f90:131-199; host numpy): a shell's
    area * t * rho / nn on every node (a quad's area as the triangles
    (1, 2, 3) and (1, 3, 4), also for MITC9), a solid-shell's on its
    lower-face nodes (zero on the upper ones), a beam's L * area * rho / 2
    on its two geometry nodes (zero on 641's rotation carriers)."""
    x = model.coords[b.conn]
    E, nn = b.conn.shape
    rho = b.density
    me = np.zeros((E, nn))
    if b.kind in ("shell", "sshell"):
        nm = nn // 2 if b.kind == "sshell" else nn
        area = _tri_area(x[:, 0], x[:, 1], x[:, 2])
        if nm != 3:
            area = area + _tri_area(x[:, 0], x[:, 2], x[:, 3])
        me[:, :nm] = (area * b.thick * rho / nm)[:, None]
        return me
    me[:, :2] = (0.5 * np.linalg.norm(x[:, 1] - x[:, 0], axis=1)
                 * b.section[3] * rho)[:, None]
    return me


def _tensor(dev, a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64), device=dev)


def _amp_factory(mesh, cfg):
    """name -> amp(t) callable (clamped linear interp over !AMPLITUDE)."""
    def make(name):
        a = mesh.amplitudes.get(name)
        if a is None:
            return lambda t: 1.0
        tt, vv = np.asarray(a.time), np.asarray(a.value)
        return lambda t: float(np.interp(t, tt, vv))
    return make


def _load_groups_with_amp(model, make_amp):
    """[(f_vector, amp_fn)] per CLOAD and DLOAD card (every card of the
    deck, as the JAX package's dynamics take them), the DLOAD vectors
    assembled once at the reference geometry."""
    mesh, cfg = model.mesh, model.cfg
    out = [(collect_cload(mesh, [c], model.ndof, model.n_node),
            make_amp(c.param("AMP", ""))) for c in cfg.cloads]
    out += [(loads.collect_dload(mesh, model, [c]),
             make_amp(c.param("AMP", ""))) for c in cfg.dloads]
    return out


def _external_force(f_groups, t: float, zero: torch.Tensor):
    """F(t): the device load vectors of ``_load_groups_with_amp`` scaled
    by their amplitude factors at t (host floats: no device read)."""
    f = zero
    for fv, amp in f_groups:
        f = f + fv * amp(t)
    return f


def _rate_bc_split(model, cards, make_amp):
    """Split !VELOCITY / !ACCELERATION cards into (initial, transit)
    entries.  initial = (dofs, vals); transit = (dofs, vals, amp_fn,
    amp_name).  Row layout matches !BOUNDARY (group, dof_s, dof_e,
    value).  A dof may be listed more than once (a group and a node in
    it); ``_RateSet`` keeps the last occurrence."""
    ndof = model.ndof
    mesh = model.mesh
    init_d, init_v = [], []
    tr_d, tr_v, tr_amp, tr_name = [], [], None, ""
    for c in cards:
        typ = (c.param("TYPE", "") or "").upper()
        amp = make_amp(c.param("AMP", ""))
        name = c.param("AMP", "")
        for row in c.data:
            grp = row[0]
            d1 = int(float(row[1]))
            d2 = int(float(row[2])) if len(row) > 2 else d1
            val = float(row[3]) if len(row) > 3 else 0.0
            nodes = mesh.node_groups.get(grp)
            if nodes is None:
                try:
                    nodes = [mesh.id2idx[int(grp)]]
                except (ValueError, KeyError):
                    continue
            for nn in np.asarray(nodes).reshape(-1):
                for d in range(d1, d2 + 1):
                    dof = int(nn) * ndof + d - 1
                    if typ.startswith("INIT"):
                        init_d.append(dof)
                        init_v.append(val)
                    else:
                        tr_d.append(dof)
                        tr_v.append(val)
                        tr_amp = amp
                        tr_name = name
    init = (np.asarray(init_d, np.int64), np.asarray(init_v)) \
        if init_d else None
    trans = (np.asarray(tr_d, np.int64), np.asarray(tr_v), tr_amp,
             tr_name) if tr_d else None
    return init, trans


class _RateSet:
    """One rate-BC entry of ``_rate_bc_split`` on the device, each dof
    once with its last value: a repeated index in ``index_copy`` has no
    defined order on CUDA, where the JAX package's ``.at[].set`` keeps
    the last write."""

    def __init__(self, entry, device):
        dofs, vals = np.asarray(entry[0]), np.asarray(entry[1])
        _, first = np.unique(dofs[::-1], return_index=True)
        keep = np.sort(len(dofs) - 1 - first)
        self.idx = torch.as_tensor(dofs[keep], dtype=torch.int64,
                                   device=device)
        self.vals = torch.as_tensor(vals[keep], dtype=F64, device=device)
        self.amp = entry[2] if len(entry) > 2 else None

    def set(self, x: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        return x.index_copy(0, self.idx, vals)


@dataclasses.dataclass
class DynamicResult:
    u: np.ndarray
    vel: np.ndarray
    acc: np.ndarray
    steps: int
    monitors: Dict[str, np.ndarray]
    final: Optional[StaticResult] = None
    # per step of an implicit run: step, newton (solves), cg (iterations
    # per solve), solve_s; the explicit run leaves it empty
    history: List[dict] = dataclasses.field(default_factory=list)
    # seconds per phase ("mass", "steps", "post"; run_directory adds its
    # own), and "block_ms": device ms of each block of steps
    timings: dict = dataclasses.field(default_factory=dict)
    arm: str = ""                  # "linear", "newton" or "explicit"


def _check_request(model: StructModel) -> None:
    """Raise for what the JAX package's dynamics run and the port does
    not yet."""
    cfg = model.cfg
    d = cfg.dynamic
    if d is None:
        raise ValueError("!DYNAMIC card missing")
    check_recoverable(model)
    if d.idx_resp == 2 or cfg.eigenread is not None:
        raise NotImplementedError("frequency response (!DYNAMIC idx_resp "
                                  "= 2, !EIGENREAD)")
    if dist.current() is not None:
        # the sharded arm is the implicit effective solve
        if d.idx_eqa == 11:
            raise NotImplementedError("explicit dynamics under "
                                      "FRONTISTR_TPU_SHARDS")
        if cfg.restart is not None:
            raise NotImplementedError("!RESTART under FRONTISTR_TPU_SHARDS")
        if cfg.solver.method.upper() not in ("CG", "1"):
            raise NotImplementedError(f"!SOLVER METHOD={cfg.solver.method}"
                                      " under FRONTISTR_TPU_SHARDS")
    # the JAX package's explicit run prints a warning and drops the
    # !EQUATION constraints; its dynamics leave !SPRING out of K
    explicit_eq = model.mesh.equations if d.idx_eqa == 11 else []
    for name, cards in (("!EQUATION in explicit dynamics", explicit_eq),
                        ("!SPRING", cfg.springs),
                        ("!TEMPERATURE", cfg.temperatures),
                        ("!AMPLITUDE in the .cnt", cfg.amplitudes)):
        if cards:
            raise NotImplementedError(f"{name} in dynamics")
    if any(c.param("AMP") for c in cfg.boundaries):
        # the JAX package reads the amplitude and leaves it unused
        raise NotImplementedError("!BOUNDARY, AMP= in dynamics")


def run_dynamic(model: StructModel, log_path: Optional[str] = None,
                on_interval=None, restart_path: Optional[str] = None,
                restart_freq: int = 0, coupler=None) -> DynamicResult:
    """Time history on ``model.device``.  ``on_interval(step, t, u, vel,
    acc)`` (host arrays) fires after every committed time step -- the
    runner uses it for per-interval result files (fstr_solve_dynamic
    result cadence) -- and selects the eager arms, as in the JAX
    package.  ``restart_path``/``restart_freq`` (the !RESTART card) are
    the implicit run's: it resumes from the file when it exists and
    ``restart_freq`` is set, and writes it every ``restart_freq`` steps;
    the explicit run never reads them, as in the JAX package.
    ``coupler`` (``couple.rcap.CoupleDriver``; by default one from
    FRONTISTR_TPU_COUPLE_DIR when the deck has !COUPLE) adds the peer's
    interface traction to each step's external force and publishes the
    interface displacement, velocity and acceleration after it."""
    _check_request(model)
    if log_path is not None:
        check_log(model)
    if coupler is None:
        coupler = driver_from_env(model, model.mesh, model.cfg)
    if model.cfg.dynamic.idx_eqa == 11:
        return _run_explicit(model, log_path, on_interval=on_interval,
                             coupler=coupler)
    return _run_implicit(model, log_path, on_interval=on_interval,
                         restart_path=restart_path,
                         restart_freq=restart_freq, coupler=coupler)


class _Monitor:
    """Per-step monitoring-node history (dynamic_output_monit,
    dynamic_output.f90:354-431): u/v/a of node `node_monit_1` every
    `nout_monit` steps, kept in a device buffer (no host read inside the
    step loop); dyna_disp/velo/acce.out next to the log with the
    reference line layout (step, t, global id, components)."""

    def __init__(self, model, d, device):
        self.model = model
        self.gid = int(getattr(d, "node_monit_1", 0) or 0)
        self.every = max(int(getattr(d, "nout_monit", 1) or 1), 1)
        self.idx = model.mesh.id2idx.get(self.gid) if self.gid else None
        self.steps: List[tuple] = []
        self.buf = None
        if self.idx is not None:
            nrow = max(d.n_step, 0) // self.every
            self.buf = torch.zeros((nrow, 3, model.ndof), dtype=F64,
                                   device=device)

    def record(self, i, t, u, vel, acc):
        if self.idx is None or i % self.every:
            return
        nd = self.model.ndof
        k0 = self.idx * nd
        row = self.buf[len(self.steps)]
        for j, v in enumerate((u, vel, acc)):
            row[j].copy_(v[k0:k0 + nd])
        self.steps.append((i, t))

    def arrays(self):
        if not self.steps:
            return {}
        b = self.buf[:len(self.steps)].cpu().numpy()
        return {"step": np.asarray([s[0] for s in self.steps]),
                "time": np.asarray([s[1] for s in self.steps]),
                "disp": b[:, 0], "velo": b[:, 1], "acce": b[:, 2]}

    def write_files(self, log_path, arrays):
        if not arrays or not log_path:
            return
        base = os.path.dirname(os.path.abspath(log_path))
        for name in ("disp", "velo", "acce"):
            with open(os.path.join(base, f"dyna_{name}.out"), "w") as fh:
                for i, t, vals in zip(arrays["step"], arrays["time"],
                                      arrays[name]):
                    v = "".join(f"{x:13.4E}" for x in vals)
                    fh.write(f"{int(i):10d}{t:13.4E}{self.gid:10d}{v}\n")


class _StepClock:
    """Marks every ``every`` steps without a host synchronisation: CUDA
    events on the card, the host clock on the CPU.  ``block_ms()``
    reads them after the loop."""

    def __init__(self, device, n_step: int):
        self.cuda = device.type == "cuda"
        self.every = max(n_step // 10, 1)
        self.marks = []
        self.mark()

    def mark(self, i: int = 0):
        if i % self.every:
            return
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def block_ms(self) -> List[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) / self.every
                    for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 / self.every
                for a, b in zip(self.marks, self.marks[1:])]


def _update(model, programs, states, u, du, gather, t=0.0, dt=0.0):
    """Element update of every block from the committed ``states`` at
    u + du (``t``, ``dt`` the step's time and increment, as the
    rate-dependent materials read them): (new states, internal force
    Q)."""
    new_states, qfs = [], []
    nn, nd = model.n_node, model.ndof
    for p, s in zip(programs, states):
        ns_, qf = p.update(_element_values(u, p, nn, nd),
                           _element_values(du, p, nn, nd), s, t, dt)
        new_states.append(ns_)
        qfs.append(qf)
    return new_states, femop.gather_sum(qfs, gather)


def make_effective_solver(model, free, gather, mass, c1: float,
                          c2: float):
    """The effective solve of an implicit step: ``solve(kes, B,
    dirichlet_inc, prepared=None)`` solves

        P A P x + (I-P) x = (B - A d) * P + d * (I-P),  A = c1 K + c2 M,

    d = dirichlet_inc, by PCG with the block-Jacobi inverse of A's nodal
    diagonal blocks (tol RESID, maxiter NIER); with !EQUATION on the
    eliminated system T^T A T (its constants held at 0: the rate form).
    METHOD=DIRECT without !EQUATION factors the constrained A on the host
    instead (SuperLU), once per ``prepare`` and back-substituted at every
    call with it: once a run on the linear arm, every iteration on the
    Newton arm; with FRONTISTR_TPU_DIRECT=band the factor is the band
    Cholesky on the model's device (``solver/band.py``).
    ``solve.prepare(kes)`` builds the operator and the
    preconditioner or factor once for a tangent that stays (the linear
    arm), ``solve.operator(kes)`` the stiffness operator alone;
    ``solve.last_iters`` / ``last_relres`` describe the last call."""
    sv = model.cfg.solver
    dev = model.device
    dofs = [torch.as_tensor(b.dofs, dtype=torch.int64, device=dev)
            for b in model.blocks]
    nn, nd = model.n_node, model.ndof
    mpc = extras.mpc_arrays(model.mesh, nd, nn * nd, dev)
    use_direct = sv.method.upper() in direct.METHODS and mpc is None
    use_band = use_direct and \
        os.environ.get("FRONTISTR_TPU_DIRECT", "").lower() == "band"

    def operator(kes):
        return femop.FEOperator(list(kes), dofs, gather, nn, nd, free)

    split = shardmod.current_split(nn, nd)
    if split is not None:
        # a sharded run: the rank's rows of c1 K + c2 M assembled by K1
        # from its elements, block-Jacobi (the JAX package's
        # dynamic.py:382-393 takes its sharded constrained solver)
        row = shardmod.RowSolver(model, shardmod.local_model(model, split),
                                 split, free, False, {}, select=True,
                                 eff=(c1, c2), mass=mass)

    def prepare(kes):
        if split is not None:
            # the whole operator for the Rayleigh term; the solve is
            # the rank's
            return operator(kes), None
        op = operator(kes)
        if use_band:
            # K_eff = c1 K + c2 M factored on the device
            return op, BandCholesky(op.kes, dofs, nn * nd, direct.host(free),
                                    [b.conn for b in model.blocks], nn,
                                    scale=c1, diag_add=c2 * mass, device=dev)
        if use_direct:
            import scipy.sparse as sp
            A = (c1 * direct.assemble_csr(op.kes, dofs, nn * nd)
                 + sp.diags(c2 * direct.host(mass))).tocsr()
            return op, direct.factor_constrained(A, free)
        return op, op.block_jacobi(scale=c1, diag_add=c2 * mass)

    def solve(kes, B, dirichlet_inc, prepared=None):
        if split is not None:
            x = row(kes, B, dirichlet_inc, 0.0)
            solve.last_iters, solve.last_relres = row.last_iters, \
                row.last_relres
            return x
        op, M = prepared if prepared is not None else prepare(kes)
        if use_band:
            solve.last_iters, solve.last_relres = 0, 0.0
            A_d = c1 * op.matvec(dirichlet_inc) + c2 * mass * dirichlet_inc
            return M.solve((B - A_d) * free +
                           dirichlet_inc * (1.0 - free))
        if use_direct:
            solve.last_iters, solve.last_relres = 0, 0.0
            return torch.as_tensor(M(B, dirichlet_inc), device=dev)

        def A_raw(x):
            return c1 * op.matvec(x) + c2 * mass * x

        def A_eff(x):
            y = A_raw(x * free)
            return y * free + x * (1.0 - free)

        b_c = (B - A_raw(dirichlet_inc)) * free + \
            dirichlet_inc * (1.0 - free)
        A_cg = A_eff
        if mpc is not None:
            b_c = extras.mpc_reduce_rhs(mpc, A_eff, b_c)
            A_cg = extras.mpc_wrap(mpc, A_eff)
            M = extras.mpc_precond(mpc, M)
        res = pcg(A_cg, b_c, M=M, tol=sv.resid, maxiter=sv.nier)
        solve.last_iters, solve.last_relres = int(res.iters), res.relres
        return res.x if mpc is None else extras.mpc_recover(mpc, res.x)

    solve.operator, solve.prepare = operator, prepare
    solve.mpc = mpc
    solve.last_iters, solve.last_relres = 0, float("nan")
    return solve


def _load_dyn_checkpoint(path, states, contact, device):
    """The implicit run's checkpoint (fstr_dynamic_nlimplicit.f90's
    restart block; ``frontistr_tpu/analysis/dynamic.py:534-552``): u,
    vel, acc and the gauss states on ``device``, the contact manager's
    multipliers, slip origin and released slots restored in place.
    Returns (u, vel, acc, states, first step)."""
    rz = load_restart(path)
    u, vel, acc = (_tensor(device, rz[k]) for k in ("u", "vel", "acc"))
    states = device_states(rz["states"], states, device)
    if contact is not None and "cm" in rz:
        cm, cs = contact.cm, rz["cm"]
        cm.lam = np.asarray(cs["lam"])
        cm.lam_t = np.asarray(cs["lam_t"])
        if cs.get("rel_prev") is not None:
            cm.rel_prev = np.asarray(cs["rel_prev"])
        cm.slag_released = np.asarray(cs["slag_released"]).astype(bool)
    return u, vel, acc, states, int(np.asarray(rz["i"])) + 1


def _save_dyn_checkpoint(path, i, u, vel, acc, states, contact) -> None:
    """The committed step ``i`` (``frontistr_tpu/analysis/dynamic.py:
    862-879``): u, vel, acc, i, the gauss states and, on a contact deck,
    the contact manager's lam, lam_t, rel_prev and slag_released."""
    payload = dict(u=u.cpu().numpy(), vel=vel.cpu().numpy(),
                   acc=acc.cpu().numpy(), i=np.asarray(i),
                   states=host_states(states))
    if contact is not None:
        cm = contact.cm
        payload["cm"] = dict(lam=cm.lam, lam_t=cm.lam_t,
                             rel_prev=cm.rel_prev,
                             slag_released=cm.slag_released.astype(np.int8))
    save_restart(path, payload)


def _couple_force(coupler, i: int, f_ext: torch.Tensor) -> torch.Tensor:
    """f_ext plus the peer's interface traction of step i
    (fstr_rcap_get + dynamic_mat_ass_couple)."""
    if coupler is None:
        return f_ext
    return f_ext + torch.as_tensor(coupler.traction_force(i),
                                   dtype=f_ext.dtype, device=f_ext.device)


def _couple_publish(coupler, i: int, u, vel, acc) -> None:
    """Interface motion of the committed step i to the peer
    (fstr_rcap_send)."""
    if coupler is not None:
        coupler.publish_state(i, *(v.cpu().numpy() for v in (u, vel, acc)))


def _run_implicit(model: StructModel, log_path, on_interval=None,
                  restart_path=None, restart_freq=0, coupler=None):
    cfg = model.cfg
    d = cfg.dynamic
    step = cfg.steps[0]
    ndof, n, dev = model.ndof, model.n_dof_total, model.device
    dt = d.t_delta
    beta, gamma = d.beta, d.gamma
    a1 = 0.5 / beta - 1.0
    a2 = 1.0 / (beta * dt)
    a3 = 1.0 / (beta * dt * dt)
    b1 = (0.5 * gamma / beta - 1.0) * dt
    b2 = gamma / beta - 1.0
    b3 = gamma / (beta * dt)
    c1 = 1.0 + d.ray_k * b3
    c2 = a3 + d.ray_m * b3
    timings: dict = {}
    gather = femop.incidence_gather(model, dev)
    with Phase(timings, "mass", dev):
        mass = lumped_mass_vector(model, gather)
    programs = [BlockPrograms(model, b) for b in model.blocks]
    states = [init_block_state(b, p.table, dev)
              for b, p in zip(model.blocks, programs)]
    make_amp = _amp_factory(model.mesh, cfg)
    f_groups = [(_tensor(dev, f), amp)
                for f, amp in _load_groups_with_amp(model, make_amp)]
    zero = torch.zeros(n, dtype=F64, device=dev)

    u = zero.clone()
    vel = zero.clone()
    acc = zero.clone()
    # !VELOCITY / !ACCELERATION (dynamic_mat_ass_bc_vl/_ac.f90 +
    # DYNAMIC_BC_INIT_VL/_AC): TYPE=INITIAL seeds v(0)/a(0); otherwise
    # the card is a prescribed-rate Dirichlet condition enforced through
    # the Newmark displacement relation each step
    v_init, v_trans = _rate_bc_split(model, cfg.velocities, make_amp)
    a_init, a_trans = _rate_bc_split(model, cfg.accelerations, make_amp)
    if v_init is not None:
        r = _RateSet(v_init, dev)
        vel = r.set(vel, r.vals)
    if a_init is not None:
        r = _RateSet(a_init, dev)
        acc = r.set(acc, r.vals)
    vt = _RateSet(v_trans, dev) if v_trans is not None else None
    at = _RateSet(a_trans, dev) if a_trans is not None else None
    extra_fix = [e[0] for e in (v_trans, a_trans) if e is not None]
    fixed_all = np.concatenate([np.asarray(model.fixed_dofs,
                                           np.int64).reshape(-1)]
                               + extra_fix)
    free = _tensor(dev, old_ops.make_free_mask(n, fixed_all))
    fixed = 1.0 - free
    # Newmark coefficients of the prescribed-rate displacement relation
    bv2 = dt * (gamma - beta) / gamma
    bv3 = dt * dt * (gamma - 2.0 * beta) / (2.0 * gamma)
    bv4 = dt * beta / gamma
    ba2 = dt
    ba3 = dt * dt * (0.5 - beta)
    ba4 = dt * dt * beta
    u_fix = _tensor(dev, old_ops.full_fixed_vector(n, model.fixed_dofs,
                                             model.fixed_vals))
    solve = make_effective_solver(model, free, gather, mass, c1, c2)
    # contact (fstr_dynamic_nlimplicit.f90:374+): the static driver's
    # SLAGRANGE or penalty arm on the effective matrix c1 K + c2 M
    contact = ContactState.make(model, gather, timings, eff=(c1, c2),
                                mass=mass)
    if contact is not None:
        contact.build(free)
        if cfg.solver.method.upper() in direct.METHODS:
            print("### NOTE: METHOD=DIRECT with !EQUATION/contact rides "
                  "the iterative eliminated solve in dynamics")

    def dirichlet_increment(u, vel, acc, t):
        """Constrained-dof increment of step t: u_fix - u, and the
        Newmark displacement relation on the rate-BC dofs; zero on the
        free rows (u_fix - u is nonzero there from step 2 on, and the
        constrained right-hand side applies A to the whole vector)."""
        dinc = u_fix - u
        if vt is not None:
            dinc = vt.set(dinc, bv2 * vel[vt.idx] + bv3 * acc[vt.idx]
                          + bv4 * vt.vals * vt.amp(t))
        if at is not None:
            dinc = at.set(dinc, ba2 * vel[at.idx] + ba3 * acc[at.idx]
                          + ba4 * at.vals * at.amp(t))
        return dinc * fixed

    def rayleigh_k(kes, x, prepared=None):
        op = prepared[0] if prepared is not None else solve.operator(kes)
        return d.ray_k * op.matvec(x)

    mon = _Monitor(model, d, dev)
    clock = _StepClock(dev, d.n_step)
    history: List[dict] = []
    # the JAX package's linear step train (lax.scan): linear programs,
    # no per-interval output; FRONTISTR_TPU_IMPLICIT_SCAN=0 takes the
    # Newton loop instead.  For a linear model the Newton loop is one
    # solve a step (it = 2 only re-measures the residual), so the two
    # agree at CG tolerance.
    start_i = 1
    if restart_path and restart_freq and os.path.exists(restart_path):
        with Phase(timings, "restart_load", dev):
            u, vel, acc, states, start_i = _load_dyn_checkpoint(
                restart_path, states, contact, dev)
    linear = (on_interval is None and contact is None and coupler is None
              and not restart_path and _all_linear(programs)
              and os.environ.get("FRONTISTR_TPU_IMPLICIT_SCAN", "1") != "0")
    t0 = time.perf_counter()
    if linear:
        ze = [_element_values(zero, p, model.n_node, ndof)
              for p in programs]
        kes0 = [p.tangent(z, z, s, 0.0, dt)
                for p, z, s in zip(programs, ze, states)]
        prepared = solve.prepare(kes0)
        Q = _qforce(model, programs, states, u, zero, gather)
        for i in range(1, d.n_step + 1):
            t = dt * i
            vec1 = a1 * acc + a2 * vel
            vec2 = b1 * acc + b2 * vel
            B = _external_force(f_groups, t, zero) - Q + \
                mass * (vec1 + d.ray_m * vec2)
            if d.ray_k != 0.0:
                B = B + rayleigh_k(kes0, vec2, prepared)
            ts = {}
            with Phase(ts, "solve", dev):
                du = solve(kes0, B, dirichlet_increment(u, vel, acc, t),
                           prepared)
            states, Q = _update(model, programs, states, u, du, gather, t,
                                dt)
            states = [_commit_state(s) for s in states]
            acc, vel = -a1 * acc - a2 * vel + a3 * du, \
                -b1 * acc - b2 * vel + b3 * du
            u = u + du
            history.append(dict(step=i, newton=1, cg=[solve.last_iters],
                                solve_s=ts["solve"]))
            mon.record(i, t, u, vel, acc)
            clock.mark(i)
    else:
        for i in range(start_i, d.n_step + 1):
            t = dt * i
            vec1 = a1 * acc + a2 * vel
            vec2 = b1 * acc + b2 * vel
            f_ext = _couple_force(coupler, i,
                                  _external_force(f_groups, t, zero))
            cgs, ts, passes = [], {}, []
            for cont_it in range(max(step.max_contiter, 1)
                                 if contact is not None else 1):
                # each contact pass restarts the step's Newton increment
                # from the committed state (the reference's
                # loopFORcontactAnalysis inside the dynamic loop)
                du = zero
                states_i = states
                resb = None
                if contact is not None and contact.slag is not None:
                    contact.freeze(contact.search(u))
                Q = _qforce(model, programs, states_i, u, du, gather)
                newton = 0
                for it in range(1, max(step.max_iter, 1) + 1):
                    kes = [p.tangent(_element_values(u, p, model.n_node,
                                                     ndof),
                                     _element_values(du, p, model.n_node,
                                                     ndof), s, t, dt)
                           for p, s in zip(programs, states_i)]
                    X_ray = vec2 - b3 * du
                    B = f_ext - Q + mass * (vec1 - a3 * du +
                                            d.ray_m * X_ray)
                    if d.ray_k != 0.0:
                        B = B + rayleigh_k(kes, X_ray)
                    dinc = dirichlet_increment(u, vel, acc, t) if it == 1 \
                        else zero
                    if contact is not None:
                        B, Bres = contact.dyn_residual(B, u + du, dinc,
                                                       free)
                    else:
                        # !EQUATION: the residual in the reduced space
                        Bres = B if solve.mpc is None else \
                            extras.mpc_Tt(solve.mpc, B)
                    Bf = Bres * free
                    bnorm = float(torch.dot(Bf, Bf))
                    if it == 1:
                        resb = max(bnorm, 1e-300)
                    res_rel = np.sqrt(bnorm / resb)
                    if os.environ.get("FRONTISTR_TPU_DEBUG_NEWTON"):
                        print(f" dyn i={i} it={it} res={res_rel:.6e}",
                              flush=True)
                    if it > 1 and res_rel < step.converg:
                        break
                    with Phase(ts, "solve", dev):
                        if contact is None:
                            dx = solve(kes, B, dinc)
                            cgs.append(solve.last_iters)
                        else:
                            dx = contact.dyn_solve(kes, B, dinc)
                            cgs.append(contact.solver.last_iters)
                    newton += 1
                    du = du + dx
                    states_i, Q = _update(model, programs, states_i, u, du,
                                          gather, t, dt)
                passes.append(newton)
                if contact is None or contact.settled(u + du):
                    break
            acc, vel = -a1 * acc - a2 * vel + a3 * du, \
                -b1 * acc - b2 * vel + b3 * du
            u = u + du
            states = [_commit_state(s) for s in states_i]
            rec = dict(step=i, newton=len(cgs), cg=cgs,
                       solve_s=ts.get("solve", 0.0))
            if contact is not None:
                rec.update(passes=passes, active=contact.active_set())
            history.append(rec)
            mon.record(i, t, u, vel, acc)
            clock.mark(i)
            if on_interval is not None:
                on_interval(i, t, *(v.cpu().numpy() for v in (u, vel, acc)))
            _couple_publish(coupler, i, u, vel, acc)
            if restart_path and restart_freq > 0 and i % restart_freq == 0:
                with Phase(timings, "restart_save", dev):
                    _save_dyn_checkpoint(restart_path, i, u, vel, acc,
                                         states, contact)
    timings["block_ms"] = clock.block_ms()
    timings["steps"] = time.perf_counter() - t0
    return _finalize_dyn(model, states, u, vel, acc, d.n_step, log_path,
                         mon, timings, history,
                         "linear" if linear else "newton")


def _run_explicit(model: StructModel, log_path, on_interval=None,
                  coupler=None):
    cfg = model.cfg
    d = cfg.dynamic
    ndof, n, dev = model.ndof, model.n_dof_total, model.device
    if ndof == 6:
        # frontistr_tpu/analysis/dynamic.py:905-908
        raise NotImplementedError(
            "explicit dynamics needs rotary inertia for 6-dof "
            "shell/beam models; use implicit (idx_eqa=1)")
    if any(b.kind in ("sshell", "beam341") for b in model.blocks):
        # their rotation carriers have no mass: the JAX package's
        # central-difference run diverges (ROADMAP, queue 3)
        raise NotImplementedError(
            "explicit dynamics of solid-shell and 641 blocks (rotation "
            "carriers without mass)")
    if np.any(np.asarray(model.fixed_vals) != 0.0):
        # the central-difference update holds every fixed dof at zero
        # (the JAX package drops the value)
        raise NotImplementedError("nonzero !BOUNDARY values in explicit "
                                  "dynamics")
    dt = d.t_delta
    a1 = 1.0 / (dt * dt)
    a2 = 1.0 / (2.0 * dt)
    ray_m = d.ray_m
    timings: dict = {}
    gather = femop.incidence_gather(model, dev)
    with Phase(timings, "mass", dev):
        mass = lumped_mass_vector(model, gather)
    programs = [BlockPrograms(model, b) for b in model.blocks]
    states = [init_block_state(b, p.table, dev)
              for b, p in zip(model.blocks, programs)]
    free = _tensor(dev, old_ops.make_free_mask(n, model.fixed_dofs))
    make_amp = _amp_factory(model.mesh, cfg)
    f_groups = [(_tensor(dev, f), amp)
                for f, amp in _load_groups_with_amp(model, make_amp)]
    zero = torch.zeros(n, dtype=F64, device=dev)

    disp1 = zero.clone()          # u_n
    disp3 = zero.clone()          # u_{n-1}
    vel = zero.clone()
    acc = zero.clone()
    # initial velocity/acceleration (DYNAMIC_BC_INIT_VL/_AC): central
    # difference seeds u_{-1} = -dt v0 + dt^2/2 a0
    v_init, v_tr = _rate_bc_split(model, cfg.velocities, make_amp)
    a_init, a_tr = _rate_bc_split(model, cfg.accelerations, make_amp)
    if v_init is not None:
        r = _RateSet(v_init, dev)
        vel = r.set(vel, r.vals)
        disp3 = disp3 - dt * vel
    if a_init is not None:
        r = _RateSet(a_init, dev)
        acc = r.set(acc, r.vals)
        disp3 = disp3 + (0.5 * dt * dt) * acc
    vt = _RateSet(v_tr, dev) if v_tr is not None else None
    at = _RateSet(a_tr, dev) if a_tr is not None else None
    vec1 = (a1 + a2 * ray_m) * mass
    vec1 = torch.where(vec1 * free == 0.0, 1.0, vec1)
    free_b = free > 0
    m2 = 2.0 * a1 * mass
    m3 = (-a1 + a2 * ray_m) * mass
    Q = zero
    # the element tables and material constants reach the card here,
    # not inside the first step
    _update(model, programs, states, zero, zero, gather)

    mon = _Monitor(model, d, dev)
    clock = _StepClock(dev, d.n_step)
    t0 = time.perf_counter()
    for i in range(1, d.n_step + 1):
        t = dt * i
        B = _couple_force(coupler, i, _external_force(f_groups, t, zero)) \
            - Q + m2 * disp1 + m3 * disp3
        X = torch.where(free_b, B / vec1, 0.0)
        # prescribed-rate Dirichlet (dynamic_mat_ass_bc_vl/_ac explicit
        # branches): u_{n+1} = u_{n-1} + 2 dt v / 2 u_n - u_{n-1} + dt^2 a
        if vt is not None:
            X = vt.set(X, disp3[vt.idx] + (2.0 * dt * vt.amp(t)) * vt.vals)
        if at is not None:
            X = at.set(X, 2.0 * disp1[at.idx] - disp3[at.idx]
                       + (dt * dt * at.amp(t)) * at.vals)
        acc = a1 * (X - 2.0 * disp1 + disp3)
        vel = a2 * (X - disp3)
        # one stress/state update per step (fstr_dynamic_nlexplicit:278-296)
        states, Q = _update(model, programs, states, disp1, X - disp1,
                            gather, t, dt)
        states = [_commit_state(s) for s in states]
        disp3, disp1 = disp1, X
        mon.record(i, t, X, vel, acc)
        clock.mark(i)
        if on_interval is not None:
            on_interval(i, t, *(v.cpu().numpy() for v in (X, vel, acc)))
        _couple_publish(coupler, i, X, vel, acc)
    timings["block_ms"] = clock.block_ms()
    timings["steps"] = time.perf_counter() - t0
    return _finalize_dyn(model, states, disp1, vel, acc, d.n_step, log_path,
                         mon, timings, [], "explicit")


def _finalize_dyn(model, states, u, vel, acc, steps, log_path, mon,
                  timings, history, arm) -> DynamicResult:
    dev = model.device
    with Phase(timings, "post", dev):
        res = _postprocess(model, states, u)
        monitors = mon.arrays()
        shape = (model.n_node, model.ndof)
        out = DynamicResult(u=u.cpu().numpy().reshape(shape),
                            vel=vel.cpu().numpy().reshape(shape),
                            acc=acc.cpu().numpy().reshape(shape),
                            steps=steps, monitors=monitors, final=res,
                            history=history, timings=timings, arm=arm)
        if log_path:
            _write_dyn_log(log_path, model, out, steps)
            mon.write_files(log_path, monitors)
    return out


def _write_dyn_log(path, model, out, step):
    """New-format summary incl. velocity/acceleration (dynamic_output.f90)."""
    res = out.final
    dim = model.dim
    sel = res.node_count > 0
    names, arrs = [], []
    for dname, a in (("U", out.u), ("V", out.vel), ("A", out.acc)):
        for k in range(dim):
            names.append(f"{dname}{k+1}")
            arrs.append(a[sel, k])
    for k, lab in enumerate(logio.LABELS_E[dim]):
        names.append(lab)
        arrs.append(res.nodal_strain[sel, k])
    for k, lab in enumerate(logio.LABELS_S[dim]):
        names.append(lab)
        arrs.append(res.nodal_stress[sel, k])
    names.append("SMS")
    arrs.append(res.nodal_mises[sel])
    ids = model.mesh.node_ids[sel]
    with open(path, "w") as f:
        f.write(f"#### Result step={step:6d}\n")
        f.write(" ##### Global Summary @Node    :Max/IdMax/Min/IdMin####\n")
        for nm, a in zip(names, arrs):
            imax, imin = int(np.argmax(a)), int(np.argmin(a))
            f.write(f" //{nm:<5s}{a[imax]: .4E} {int(ids[imax]):9d} "
                    f"{a[imin]: .4E} {int(ids[imin]):9d}\n")
