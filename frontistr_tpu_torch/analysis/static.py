"""Linear static analysis driver (torch port of the linear-elastic solid
arm of ``frontistr_tpu/analysis/static.py``).

assemble -> apply BC -> Krylov solve -> stress recovery
(fstr_static_analysis, fistr1/src/main/fistr_main.f90:288, one linear
step).  The solve is the JAX package's cluster-ELL path: the f32
cluster operator assembled through the K1 segment-sum kernel,
AMG-preconditioned (block-Jacobi below FRONTISTR_TPU_AMG_MIN dofs), with
f64 refinement on the matrix-free operator ("mixed", the default on
CUDA) or a plain f64 CG ("f64", the default on the CPU).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from frontistr_tpu_torch.assembly import bell, ell, femop
from frontistr_tpu_torch.assembly import operators as ops
from frontistr_tpu_torch.assembly.model import StructModel
from frontistr_tpu_torch.device import Phase
from frontistr_tpu_torch.elements.tables import get_table
from frontistr_tpu_torch.fem import solid
from frontistr_tpu_torch.post import nodal as postnodal
from frontistr_tpu_torch.solver import amg as amgmod
from frontistr_tpu_torch.solver.cg import pcg
from frontistr_tpu_torch.solver.mixed import refined_cg


@dataclasses.dataclass
class StaticResult:
    u: np.ndarray                      # (n_node, ndof)
    nodal_strain: np.ndarray
    nodal_stress: np.ndarray
    nodal_mises: np.ndarray
    elem_strain: np.ndarray            # concatenated over blocks
    elem_stress: np.ndarray
    elem_mises: np.ndarray
    elem_ids: np.ndarray
    iters: int
    relres: float
    policy: str                        # "mixed" or "f64"
    passes: int                        # refinement passes (mixed)
    node_count: np.ndarray = None      # elements touching each node
    timings: dict = dataclasses.field(default_factory=dict)  # seconds


class LinearSolve(NamedTuple):
    x: np.ndarray
    iters: int
    relres: float
    passes: int
    policy: str


def compute_element_stiffness(model: StructModel):
    """Batched f64 element stiffness per block, on ``model.device``."""
    kes = []
    for b in model.blocks:
        coords_e = torch.as_tensor(model.coords[b.conn], device=model.device)
        D = torch.as_tensor(b.D, device=model.device)
        kes.append(solid.stiffness_linear(get_table(b.etype), coords_e, D,
                                          thick=b.thick))
    return kes


def solve_policy(device: torch.device) -> str:
    """'f64' (native f64 CG) or 'mixed' (f32 CG + f64 refinement):
    FRONTISTR_TPU_PRECISION=f64|mixed, else mixed on CUDA, f64 on CPU."""
    pol = os.environ.get("FRONTISTR_TPU_PRECISION", "auto")
    if pol in ("f64", "mixed"):
        return pol
    return "mixed" if device.type == "cuda" else "f64"


def print_iterlog(hist) -> None:
    """The reference's ITERLOG lines (hecmw_solver_CG.f90:245)."""
    if hist is None:
        return
    it = 0
    for r in np.asarray(hist).reshape(-1):
        if r < 0:
            continue
        it += 1
        print(f"{it:7d} {r:16.6E}")


def print_timelog(t_setup: float, t_solve: float) -> None:
    """Reference TIMELOG shape (hecmw_solver_CG.f90:131-145)."""
    print(" Time solver setup")
    print(f"   Total   : {t_setup:.6f}")
    print(" Time solver iterations")
    print(f"   Total   : {t_solve:.6f}")


def _check_solver(sv) -> str:
    method = sv.method.upper()
    if method not in ("CG", "1"):
        raise NotImplementedError(f"!SOLVER METHOD={sv.method}")
    if (sv.dumptype or "NONE").upper() not in ("NONE", "", "0"):
        raise NotImplementedError("!SOLVER DUMPTYPE")
    if sv.estcond:
        raise NotImplementedError("!SOLVER ESTCOND")
    if os.environ.get("FRONTISTR_TPU_PRECOND", "") == "cheby":
        raise NotImplementedError("FRONTISTR_TPU_PRECOND=cheby")
    return method


def solve_linear(model: StructModel, kes,
                 timings: Optional[dict] = None) -> LinearSolve:
    """Assemble + constrained CG solve on ``model.device``."""
    sv = model.cfg.solver
    method = _check_solver(sv)
    timings = {} if timings is None else timings
    dev = model.device
    n = model.n_dof_total
    t0 = time.perf_counter()
    u_fix = torch.as_tensor(ops.full_fixed_vector(n, model.fixed_dofs,
                                                  model.fixed_vals),
                            device=dev)
    f = torch.as_tensor(model.f_ext, device=dev)
    op = femop.from_model(model, kes)
    b_c = op.constrained_rhs(f, u_fix)
    hl = 2000 if sv.iterlog else 0
    policy = solve_policy(dev)
    mixed = policy == "mixed" and method == "CG"
    with Phase(timings, "profile", dev):
        prof = ell.profile_from_model(model)
        amaps = amgmod.eligible_maps(prof, n)
        cprof = bell.cluster_profile_from_model(model, scalar=prof)
    with Phase(timings, "assembly", dev):
        dtype = torch.float32 if mixed else torch.float64
        if amaps is not None:
            cop, sb = bell.from_model(model, kes, dtype=dtype,
                                      profile=cprof, want_scalar=True,
                                      scalar=prof)
        else:
            cop, sb = bell.from_model(model, kes, dtype=dtype,
                                      profile=cprof), None
    with Phase(timings, "amg_setup", dev):
        if amaps is None:
            M = cop.block_jacobi()
        else:
            M = amgmod.setup_amg(
                amaps, sb, torch.as_tensor(prof.cols, dtype=torch.int64,
                                           device=dev),
                torch.as_tensor(model.coords, dtype=dtype, device=dev),
                cop.free_mask, cop.apply_constrained, cop.block_jacobi())
    t1 = time.perf_counter()
    with Phase(timings, "solve", dev):
        if mixed:
            res = refined_cg(op.apply_constrained, cop.apply_constrained,
                             M, b_c, tol=sv.resid, inner_tol=1e-6,
                             maxiter=sv.nier, hist_len=hl)
            passes = res.passes
        else:
            res = pcg(cop.apply_constrained, b_c, M=M, tol=sv.resid,
                      maxiter=sv.nier, hist_len=hl)
            passes = 0
        x = res.x.cpu().numpy()
    t2 = time.perf_counter()
    if sv.iterlog:
        print_iterlog(res.hist)
    if sv.timelog:
        print_timelog(t1 - t0, t2 - t1)
    return LinearSolve(x, int(res.iters), float(res.relres), passes,
                       "mixed" if mixed else "f64")


def recover_stress(model: StructModel, u_flat: np.ndarray):
    """Gauss strain/stress + nodal smoothing + element means."""
    dev = model.device
    u = u_flat.reshape(model.n_node, model.ndof)
    block_data = []
    for b in model.blocks:
        coords_e = torch.as_tensor(model.coords[b.conn], device=dev)
        u_e = torch.as_tensor(u[b.conn], device=dev)
        eps = solid.strains_at_gauss(get_table(b.etype), coords_e, u_e)
        sig = torch.einsum("ekl,eql->eqk",
                           torch.as_tensor(b.D, device=dev), eps)
        block_data.append(dict(etype=b.etype, conn=b.conn,
                               gauss_strain=eps, gauss_stress=sig))
    return u, postnodal.smooth(model.n_node, block_data, model.dim)


def run_linear_static(model: StructModel,
                      timings: Optional[dict] = None) -> StaticResult:
    timings = {} if timings is None else timings
    with Phase(timings, "element_stiffness", model.device):
        kes = compute_element_stiffness(model)
    sol = solve_linear(model, kes, timings)
    with Phase(timings, "stress", model.device):
        u, sm = recover_stress(model, sol.x)
    return StaticResult(
        u=u, nodal_strain=sm["strain"], nodal_stress=sm["stress"],
        nodal_mises=sm["mises"], node_count=sm["count"],
        elem_strain=np.concatenate(sm["estrain"]),
        elem_stress=np.concatenate(sm["estress"]),
        elem_mises=np.concatenate(sm["emises"]),
        elem_ids=np.concatenate([b.elem_ids for b in model.blocks]),
        iters=sol.iters, relres=sol.relres, policy=sol.policy,
        passes=sol.passes, timings=timings)
