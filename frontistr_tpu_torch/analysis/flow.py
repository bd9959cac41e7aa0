"""Incompressible flow on u-p tet meshes, element 3414 (torch port of
``frontistr_tpu/analysis/flow.py``: ``FlowResult``, ``_fluid_props``,
``run_flow``, ``write_flow_result``; reference fstr_dynamic_nlimplicit.f90
with the 3414 arms of dynamic_mat_ass_load.f90:240-330, zero mass).

``!SOLUTION, TYPE=DYNAMIC`` on a mesh with a 3414 block runs the
semi-implicit SUPG/PSPG Navier-Stokes stepper.  Each time step builds
the element matrices and right-hand sides at the step's start field
(``fem/fluid.py``, in element chunks), sums the matrices into the
scalar block-ELL operator at nd = 4 (v_x, v_y, v_z, p) through K1's
element entry (``ell.from_blocks``) and the right-hand sides into the
global vector through K1's planes entry (``segsum.IndexAdd``: a fixed
order, so a relaunch on the card is bit-equal), then solves the
linearised system K(v_n) d(dv) = r, r = b(v_n) - K (v_n + dv), by
block-Jacobi BiCGSTAB (the blocks are not symmetric), up to the
!STEP's ``max_iter`` times until ||r|| / ||b|| <= ``converg``.  With no
pressure condition the gauge is pinned at dof 3, the pressure of the
first node of the (reordered) mesh, as in the JAX package.

Beside the JAX package's answer the result holds what a run measured:
per step the BiCGSTAB count and seconds of every solve and the final
residual, and the seconds of each phase (``timings``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from frontistr_tpu_torch.assembly import ell
from frontistr_tpu_torch.assembly import segsum as segmod
from frontistr_tpu_torch.assembly.model import collect_boundary
from frontistr_tpu_torch.device import Phase, synchronize
from frontistr_tpu_torch.elements.tables import get_table
from frontistr_tpu_torch.fem import fluid as flib
from frontistr_tpu_torch.io.resfile import write_result
from frontistr_tpu_torch.solver.cg import bicgstab

F64 = torch.float64


@dataclasses.dataclass
class FlowResult:
    v: np.ndarray            # (n_node, 4) velocity + pressure
    steps: int
    iters: int               # linear solves over the run
    resid: float             # the last residual test's ||r|| / ||b||
    strain: Optional[np.ndarray] = None   # (E, 6) cell-avg strain rate
    stress: Optional[np.ndarray] = None   # (E, 6) cell-avg Cauchy stress
    # one dict a step: "bicgstab" (iterations of each solve), "solve_s"
    # (seconds of each solve), "resid" (the step's last residual test)
    history: List[dict] = dataclasses.field(default_factory=list)
    timings: dict = dataclasses.field(default_factory=dict)


def _fluid_props(cfg):
    """Viscosity from !FLUID TYPE=INCOMP_NEWTONIAN, density from
    !DENSITY of the first material with a !FLUID card
    (fstr_ctrl_get_FLUID, fstr_ctrl_material.f90:660-706); 1e-3 and 1e3
    without one."""
    mu, rho = 1.0e-3, 1.0e3
    for m in getattr(cfg, "materials", []):
        if getattr(m, "fluid", None) is not None:
            if m.fluid.data:
                mu = float(m.fluid.data[0][0])
            if getattr(m, "density", None) is not None and m.density.data:
                rho = float(m.density.data[0][0])
            return mu, rho
    return mu, rho


def run_flow(mesh, cfg, log_path: Optional[str] = None,
             n_step: Optional[int] = None, device="cuda",
             timings: Optional[dict] = None) -> FlowResult:
    """The u-p flow stepper on ``device`` over the mesh's first 3414
    block.  ``log_path`` gets a ``time step=... time=...`` line every
    !DYNAMIC ``nout`` steps and at the last step."""
    dev = torch.device(device)
    tm = {} if timings is None else timings
    blk = next(b for b in mesh.blocks if b.etype == 3414)
    conn_np = np.asarray(blk.conn, np.int64)
    n_node = mesh.n_node
    dyn = cfg.dynamic
    dt = float(dyn.t_delta) if dyn is not None else 1.0
    steps = int(n_step if n_step is not None
                else (dyn.n_step if dyn is not None else 1))
    step0 = cfg.steps[0] if getattr(cfg, "steps", None) else None
    max_iter = step0.max_iter if step0 is not None else 20
    converg = step0.converg if step0 is not None else 1e-8
    mu, rho = _fluid_props(cfg)
    sv = cfg.solver
    tol = float(getattr(sv, "resid", 1e-8) or 1e-8)
    nier = int(getattr(sv, "nier", 10000) or 10000)

    fixed_dofs, fixed_vals = collect_boundary(mesh, cfg.boundaries, 4)
    if not np.any(fixed_dofs % 4 == 3):
        # no pressure condition: pin the gauge (the constant-pressure
        # null space would break the Krylov solve; velocity unaffected)
        fixed_dofs = np.append(fixed_dofs, 3)
        fixed_vals = np.append(fixed_vals, 0.0)
    free = np.ones(n_node * 4)
    free[fixed_dofs] = 0.0

    with Phase(tm, "profile", dev):
        prof = ell.build_profile([conn_np], n_node, 4)
        dof = (conn_np[:, :, None] * 4 + np.arange(4)).reshape(-1)
        rhs_sum = segmod.IndexAdd.build(dof, dev)
    table = get_table(3414)
    coords = torch.as_tensor(mesh.coords, dtype=F64, device=dev)
    conn = torch.as_tensor(conn_np, device=dev)
    free_t = torch.as_tensor(free, dtype=F64, device=dev)
    v = np.zeros(n_node * 4)
    v[fixed_dofs] = fixed_vals            # BC-substituted start field
    v = torch.as_tensor(v, dtype=F64, device=dev)

    history: List[dict] = []
    total_iters = 0
    resid = 0.0
    nout = max(1, int(getattr(dyn, "nout", 100) or 100))
    for step in range(1, steps + 1):
        with Phase(tm, "element", dev):
            K, b = flib.element_system(table, coords, conn,
                                       v.reshape(n_node, 4), mu, rho, dt)
        with Phase(tm, "assembly", dev):
            op = ell.from_blocks(prof, [K], [4], free)
        del K
        with Phase(tm, "rhs", dev):
            B = rhs_sum(v.new_zeros(n_node * 4), b)
        del b
        M = op.block_jacobi()
        dv = torch.zeros_like(v)
        bscale = float(torch.linalg.norm(B * free_t)) or 1.0
        rec = {"step": step, "bicgstab": [], "solve_s": []}
        for _ in range(max_iter):
            r = (B - op.matvec(v + dv)) * free_t
            resid = float(torch.linalg.norm(r)) / bscale
            if resid <= max(converg, 1e-14):
                break
            t0 = time.perf_counter()
            res = bicgstab(op.apply_constrained, r, M=M, tol=tol,
                           maxiter=nier)
            dv = dv + res.x
            synchronize(dev)
            rec["bicgstab"].append(int(res.iters))
            rec["solve_s"].append(time.perf_counter() - t0)
            total_iters += 1
        rec["resid"] = resid
        history.append(rec)
        v = v + dv
        del op, M, B, dv
        if log_path and (step % nout == 0 or step == steps):
            with open(log_path, "a") as f:
                f.write(f" time step={step:10d} "
                        f"time={step * dt:13.4E}\n")
    tm["solve"] = sum(sum(h["solve_s"]) for h in history)

    with Phase(tm, "stress", dev):
        vn = v.reshape(n_node, 4)
        strain, stress = flib.element_strain(table, coords, conn, vn, mu)
        vmat = vn.cpu().numpy()
        strain, stress = strain.cpu().numpy(), stress.cpu().numpy()
    return FlowResult(v=vmat, steps=steps, iters=total_iters, resid=resid,
                      strain=strain, stress=stress, history=history,
                      timings=tm)


def write_flow_result(path: str, mesh, res: FlowResult,
                      step: int = 1) -> None:
    """The text ``.res`` of a flow run: nodal VELOCITY and PRESSURE,
    element STRAIN_RATE and STRESS."""
    eids = np.concatenate([b.elem_ids for b in mesh.blocks])
    write_result(path, f"*fstrresult flow step={step}",
                 mesh.node_ids, eids,
                 [("VELOCITY", res.v[:, :3]),
                  ("PRESSURE", res.v[:, 3:4])],
                 [("STRAIN_RATE", res.strain),
                  ("STRESS", res.stress)])
