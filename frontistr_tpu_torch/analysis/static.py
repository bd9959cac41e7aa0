"""Linear static analysis driver (torch port of the linear-elastic solid
arm of ``frontistr_tpu/analysis/static.py``, with its shell, solid-shell
and beam arms).

assemble -> apply BC -> Krylov solve -> stress recovery
(fstr_static_analysis, fistr1/src/main/fistr_main.f90:288, one linear
step).  The solve arms, chosen in the JAX package's order
(``static.py:284-360`` there):

- FRONTISTR_TPU_PRECOND=cheby (without !EQUATION): the deck's Krylov
  method on the matrix-free operator with the Chebyshev polynomial of
  the block-Jacobi-preconditioned operator (``solver/cheby.py``);
- a structured hex8 box (``mesh.structured`` set, as ``meshgen.box_hex8``
  sets it; one solid 361 block) takes the stencil operator
  (``assembly/structured.py``, element products through kernel K2),
  block-Jacobi preconditioned, whatever the method;
- CG on any other mesh takes the cluster-ELL path: the cluster operator
  assembled through the K1 segment-sum kernel, AMG-preconditioned
  (block-Jacobi below FRONTISTR_TPU_AMG_MIN dofs);
- BiCGSTAB, GMRES or GPBiCG (``!SOLVER, METHOD=`` or the ids 2-4) on
  any other mesh take the scalar block-ELL operator (``ell.from_model``,
  its blocks summed by K1 at the ELL profile's plan) with block-Jacobi.

A deck with !EQUATION takes none of the operator arms: the JAX package
eliminates the dependent dofs on the matrix-free operator, T^T K T, and
solves with the deck's method and a float64 block-Jacobi preconditioner
(``assembly/extras.py``; restricted to the reduced space, ROADMAP queue
3, fault 5).  METHOD=DIRECT (and DIRECTMKL, MUMPS, MKL) factors the
assembled system on the host (``solver/direct.py``); DUMPTYPE writes the
assembled matrix (``solver/dump.py``) and ESTCOND prints a Lanczos
estimate of the block-Jacobi-preconditioned operator's condition number
(``solver/cond.py``).

In a sharded run (a rank of ``parallel/dist.py``) CG takes the
row-sharded cluster solve of ``parallel/shard.py`` instead
(``sharded_solve_linear``, the JAX package's ``static.py:228-240``),
!EQUATION included; the element matrices are the whole model's on every
rank, and each rank assembles its own rows through K1.

CG runs in the "mixed" policy (f32 CG + f64 refinement on the f64
operator, the default of linear STATIC on CUDA; the cluster arm's f64
operator is the matrix-free ``FEOperator``) or the "f64" policy (a plain
f64 CG, the default on the CPU and of NLSTATIC); every other method and
the numeric id 1 run in float64.  Under a !TEMPERATURE field the stress
recovery subtracts the thermal strains.  Shells (``fem/shell.py``) and
611 beams make a 6-dof model whose cluster operator K1 assembles at
nd = 6, block-Jacobi preconditioned (the AMG has no modes for nd = 6);
a shell model's stresses come from ``post/shellpost.py``, a model of
beams and solid-shells only reports the 641 fiber stresses
(``beam_fibers``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from frontistr_tpu_torch.assembly import bell, ell, extras, femop, loads
from frontistr_tpu_torch.assembly import operators as ops
from frontistr_tpu_torch.assembly.model import StructModel
from frontistr_tpu_torch.assembly.structured import (StructuredHexOperator,
                                                     soa_from_blocks)
from frontistr_tpu_torch.device import Phase
from frontistr_tpu_torch.elements.tables import get_table
from frontistr_tpu_torch.parallel import dist
from frontistr_tpu_torch.parallel import shard
from frontistr_tpu_torch.fem import beam, shell, solid
from frontistr_tpu_torch.post import nodal as postnodal
from frontistr_tpu_torch.post.shellpost import check_recoverable, \
    shell_recover
from frontistr_tpu_torch.solver import amg as amgmod
from frontistr_tpu_torch.solver import direct
from frontistr_tpu_torch.solver import cg as krylov
from frontistr_tpu_torch.solver import ssor
from frontistr_tpu_torch.solver.cheby import (chebyshev_precond,
                                              estimate_lmax)
from frontistr_tpu_torch.solver.cond import estimate_condition
from frontistr_tpu_torch.solver.dump import dump_operator
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
    reaction: np.ndarray = None        # (n_node, ndof) K u - f_ext
    newton: object = None              # NewtonStats of the Newton driver


class LinearSolve(NamedTuple):
    x: np.ndarray
    iters: int
    relres: float
    passes: int
    policy: str
    op: femop.FEOperator           # the f64 operator of the solve


def compute_element_stiffness(model: StructModel):
    """Batched f64 element stiffness per block, on ``model.device``: the
    solids by their formulation, shells (``fem/shell.py``), solid-shells
    on their lower face and beams (``fem/beam.py``, after the reference
    vector's check)."""
    kes = []
    for b in model.blocks:
        coords_e = torch.as_tensor(model.coords[b.conn], device=model.device)
        m = b.material
        if b.kind == "shell":
            kes.append(shell.stiffness_shell(coords_e, b.thick, m.youngs,
                                             m.poisson, etype=b.etype))
            continue
        if b.kind == "sshell":
            kes.append(shell.stiffness_solid_shell(
                coords_e[:, :b.conn.shape[1] // 2], b.thick, m.youngs,
                m.poisson, etype=b.etype))
            continue
        if b.kind in ("beam", "beam341"):
            beam.check_reference(model.coords, b.conn, b.section)
            kes.append(beam.stiffness_beam(coords_e, b.section, m.youngs,
                                           m.poisson, etype=b.etype))
            continue
        D = torch.as_tensor(b.D, device=model.device)
        table = get_table(b.etype)
        if b.etype == 361 and b.formulation == "IC":
            kes.append(solid.stiffness_hex8ic(table, coords_e, D))
        elif b.etype == 361 and b.formulation == "FBAR":
            kes.append(solid.stiffness_hex8fbar(table, coords_e, D))
        else:
            kes.append(solid.stiffness_linear(table, coords_e, D,
                                              thick=b.thick))
    return kes


def solve_policy(device: torch.device, analysis: str = "STATIC") -> str:
    """'f64' (native f64 CG) or 'mixed' (f32 CG + f64 refinement):
    FRONTISTR_TPU_PRECISION=f64|mixed, else f64 on the CPU and for
    NLSTATIC, mixed for linear STATIC on CUDA.  (On the card, the
    NLSTATIC bench deck did not finish in 1,500 s under the mixed
    policy and took 165-188 s under f64; PERF.md.)"""
    pol = os.environ.get("FRONTISTR_TPU_PRECISION", "auto")
    if pol in ("f64", "mixed"):
        return pol
    return "mixed" if device.type == "cuda" and \
        analysis.upper() == "STATIC" else "f64"


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


def check_solver(sv) -> str:
    """The deck's method, upper case: a Krylov method of
    ``cg.SOLVERS`` or a direct one.  Any other name the deck reader
    passes (GMRESR, GMRESREN) raises by name: the JAX package's
    ``solve`` has no such method."""
    method = sv.method.upper()
    if method not in tuple(krylov.SOLVERS) + direct.METHODS:
        raise NotImplementedError(f"!SOLVER METHOD={sv.method}")
    return method


def is_structured(model: StructModel) -> bool:
    """The stencil arm's condition (``static.py:265-268`` of the JAX
    package): a structured box of one solid hex8 block, without springs
    or !EQUATION."""
    return (getattr(model.mesh, "structured", None) is not None
            and len(model.blocks) == 1 and model.blocks[0].etype == 361
            and model.blocks[0].kind == "solid" and not model.extras[0]
            and not model.mesh.equations)


def _stencil_operators(model: StructModel, kes, free_mask, mixed: bool,
                       timings: dict):
    """(f64 operator, CG operator, preconditioner) of the stencil arm."""
    with Phase(timings, "assembly", model.device):
        sop = StructuredHexOperator(*model.mesh.structured,
                                    soa_from_blocks(kes[0]), free_mask)
        work = dataclasses.replace(
            sop, keT=sop.keT.to(torch.float32),
            free_mask=free_mask.to(torch.float32)) if mixed else sop
        M = work.block_jacobi()
    return sop.apply_constrained, work.apply_constrained, M


@dataclasses.dataclass
class ClusterSetup:
    """The cluster-ELL arm's symbolic part, built once per analysis."""
    prof: ell.ELLProfile                # scalar ELL profile
    amaps: object                       # AMGMaps, SSORMaps or None
    #   (None: block-Jacobi)
    cprof: bell.ClusterProfile
    cols: torch.Tensor                  # (N, W) int64 scalar ELL columns
    coords: torch.Tensor                # (N, dim) float64


def cluster_setup(model: StructModel, timings: dict,
                  policy: Optional[str] = None) -> ClusterSetup:
    """Profiles and preconditioner maps of the model's mesh: the SSOR
    color maps when ``policy`` is ``ssor``, else the AMG maps as
    ``amg.eligible_maps`` grants them (``policy`` None reads
    FRONTISTR_TPU_PRECOND, where ``ssor`` means block-Jacobi, as in the
    JAX package's linear STATIC)."""
    dev = model.device
    with Phase(timings, "profile", dev):
        prof = ell.profile_from_model(model)
        amaps = ssor.eligible_maps(prof, policy) or \
            amgmod.eligible_maps(prof, model.n_dof_total, policy=policy)
        cprof = bell.cluster_profile_from_model(model, scalar=prof)
        cols = torch.as_tensor(prof.cols, dtype=torch.int64, device=dev)
        coords = torch.as_tensor(model.coords, device=dev)
    return ClusterSetup(prof, amaps, cprof, cols, coords)


def cluster_operator(setup: ClusterSetup, model: StructModel, kes,
                     free_mask: torch.Tensor, dtype, timings: dict):
    """One numeric pass: the element matrices assembled in ``dtype``
    through K1, then the preconditioner (block-Jacobi, multicolor SSOR
    or the AMG V-cycle).  Returns (constrained cluster operator,
    preconditioner)."""
    dev = model.device
    with Phase(timings, "assembly", dev):
        want = setup.amaps is not None
        out = bell.from_model(model, kes, dtype=dtype, profile=setup.cprof,
                              want_scalar=want, scalar=setup.prof)
        cop, sb = out if want else (out, None)
        cop = dataclasses.replace(cop, free_mask=free_mask.to(dtype))
    with Phase(timings, "amg_setup", dev):
        if not want:
            M = cop.block_jacobi()
        elif isinstance(setup.amaps, ssor.SSORMaps):
            M = ssor.setup_ssor(setup.amaps, sb, setup.cols, cop.diag,
                                cop.free_mask, model.ndof)
        else:
            M = amgmod.setup_amg(setup.amaps, sb, setup.cols,
                                 setup.coords.to(dtype), cop.free_mask,
                                 cop.apply_constrained, cop.block_jacobi())
    return cop.apply_constrained, M


def solve_linear(model: StructModel, kes,
                 timings: Optional[dict] = None) -> LinearSolve:
    """Assemble + constrained CG solve on ``model.device``."""
    sv = model.cfg.solver
    method = check_solver(sv)
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
    mpc = extras.mpc_arrays(model.mesh, model.ndof, n, dev)
    A_mpc = None
    if mpc is not None:
        A_mpc = extras.mpc_wrap(mpc, op.apply_constrained)
        b_c = extras.mpc_reduce_rhs(mpc, op.apply_constrained, b_c, 1.0)
    if (sv.dumptype or "NONE").upper() not in ("NONE", "", "0"):
        print(f"### matrix dumped: {dump_matrix(model, kes, sv.dumptype)}")
    if method in direct.METHODS:
        if mpc is not None:
            # the JAX package solves without the elimination and then
            # overwrites the dependent dofs (static.py:275-280): not the
            # constrained answer (ROADMAP, queue 3, fault 4)
            raise NotImplementedError("!SOLVER METHOD=DIRECT with "
                                      "!EQUATION in linear STATIC")
        with Phase(timings, "solve", dev):
            x = direct.solve_direct(op, f, u_fix)
        return LinearSolve(x, 1, 0.0, 0, "direct", op)
    hl = 2000 if sv.iterlog else 0
    policy = solve_policy(dev)
    if dist.current() is not None:
        shard.check_policy(method, None)
        t1 = time.perf_counter()
        x, iters, relres, passes = shard.sharded_solve_linear(
            model, kes, f, u_fix, policy == "mixed", timings)
        if sv.timelog:
            print_timelog(t1 - t0, time.perf_counter() - t1)
        return LinearSolve(x, iters, relres, passes, policy, op)
    cheby = os.environ.get("FRONTISTR_TPU_PRECOND", "") == "cheby" and \
        mpc is None
    mixed = policy == "mixed" and method == "CG" and mpc is None and \
        not cheby
    if cheby:
        # the polynomial preconditioner on the matrix-free operator
        A = A64 = op.apply_constrained
        with Phase(timings, "precond_setup", dev):
            Mj = op.block_jacobi()
            M = chebyshev_precond(A, Mj, estimate_lmax(A, Mj, n, dev))
    elif mpc is not None:
        A, A64, M = A_mpc, None, extras.mpc_precond(mpc, op.block_jacobi())
    elif is_structured(model):
        A64, A, M = _stencil_operators(model, kes, op.free_mask, mixed,
                                       timings)
    elif method in ("CG", "1"):
        A, M = cluster_operator(cluster_setup(model, timings), model, kes,
                                op.free_mask,
                                torch.float32 if mixed else torch.float64,
                                timings)
        A64 = op.apply_constrained
    else:
        A, M = ell_operator(model, kes, timings)
        A64 = op.apply_constrained
    t1 = time.perf_counter()
    with Phase(timings, "solve", dev):
        if mixed:
            res = refined_cg(A64, A, M, b_c, tol=sv.resid, inner_tol=1e-6,
                             maxiter=sv.nier, hist_len=hl)
            passes = res.passes
        else:
            # the JAX package keeps no ITERLOG history on the Chebyshev
            # arm
            res = krylov.solve(method, A, b_c, M=M, tol=sv.resid,
                               maxiter=sv.nier, hist_len=0 if cheby else hl)
            passes = 0
        x = res.x if mpc is None else extras.mpc_recover(mpc, res.x, 1.0)
        x = x.cpu().numpy()
    t2 = time.perf_counter()
    if sv.iterlog:
        print_iterlog(res.hist)
    if sv.timelog:
        print_timelog(t1 - t0, t2 - t1)
    if sv.estcond:
        # ESTCOND (hecmw_solver_CG.f90:89): the estimated condition number
        # of the block-Jacobi-preconditioned operator
        cond = estimate_condition(A_mpc or op.apply_constrained, n,
                                  M=op.block_jacobi(), device=dev)
        print(f"### Condition number estimate (precond K): {cond:.4e}")
    return LinearSolve(x, int(res.iters), float(res.relres), passes,
                       "mixed" if mixed else "f64", op)


def ell_operator(model: StructModel, kes, timings: dict):
    """The scalar block-ELL arm of a non-CG method: the float64 blocks
    summed by K1 at the ELL profile's plan (``ell.from_model``), then
    block-Jacobi.  Returns (constrained ELL operator, preconditioner)."""
    dev = model.device
    with Phase(timings, "profile", dev):
        prof = ell.profile_from_model(model)
    with Phase(timings, "assembly", dev):
        eop = ell.from_model(model, kes, dtype=torch.float64, profile=prof)
    with Phase(timings, "amg_setup", dev):
        M = eop.block_jacobi()
    return eop.apply_constrained, M


def dump_matrix(model: StructModel, kes, dumptype: str) -> str:
    """DUMPTYPE: the float64 scalar block-ELL blocks (N, W, nd, nd), the
    spring blocks included, read out of K1's cluster slot planes, written
    by ``solver/dump.py``.  Returns the file's path."""
    setup = cluster_setup(model, {})
    _, sb = bell.from_model(model, kes, dtype=torch.float64,
                            profile=setup.cprof, want_scalar=True,
                            scalar=setup.prof)
    nd = model.ndof
    N, W = setup.prof.cols.shape
    blocks = sb.reshape(nd, nd, N, W).permute(2, 3, 0, 1)
    return dump_operator(blocks.cpu().numpy(), setup.prof.cols, nd,
                         dumptype)


def beam_fibers(model: StructModel, u: np.ndarray) -> dict:
    """The ``smooth`` dict of a model of beams and solid-shells only
    (``frontistr_tpu/analysis/static.py:384-425``): a 641 block's fiber
    strain and stress at the six section positions
    (NodalStress_Beam_641, static_LIB_beam.f90:646-980), averaged over
    the two end nodes; zeros for every other block."""
    n, ns, dev = model.n_node, 6, model.device
    nd_strain, nd_stress = np.zeros((n, ns)), np.zeros((n, ns))
    count = np.zeros(n)
    estrain, estress, emises = [], [], []
    for b in model.blocks:
        Eb = len(b.elem_ids)
        if b.kind != "beam341":
            estrain.append(np.zeros((Eb, ns)))
            estress.append(np.zeros((Eb, ns)))
            emises.append(np.zeros(Eb))
            continue
        radius, angles = b.fiber
        nds, ndt, es, et = beam.nqm_beam_641(
            torch.as_tensor(model.coords[b.conn], device=dev), b.section,
            b.material.youngs, torch.as_tensor(u[b.conn], device=dev),
            radius=radius, angles=angles)
        estrain.append(es)
        estress.append(et)
        emises.append(np.abs(et).max(axis=1))
        # the two end nodes' sums, host numpy in element order
        for ln in range(2):
            np.add.at(nd_strain, b.conn[:, ln], nds[:, ln])
            np.add.at(nd_stress, b.conn[:, ln], ndt[:, ln])
            np.add.at(count, b.conn[:, ln], 1.0)
    nz = count > 0
    nd_strain[nz] /= count[nz, None]
    nd_stress[nz] /= count[nz, None]
    return dict(strain=nd_strain, stress=nd_stress,
                mises=np.abs(nd_stress).max(axis=1),
                count=np.maximum(count, 1.0), estrain=estrain,
                estress=estress, emises=emises)


def recover_stress(model: StructModel, u_flat: np.ndarray):
    """Gauss strain/stress + nodal smoothing + element means; a shell
    model through ``shellpost.shell_recover``, a model of beams and
    solid-shells through ``beam_fibers``, and a solid model's
    solid-shell and 641 blocks as zero rows."""
    dev = model.device
    u = u_flat.reshape(model.n_node, model.ndof)
    if any(b.kind == "shell" for b in model.blocks):
        return u, shell_recover(model, u)
    if all(b.kind != "solid" for b in model.blocks):
        return u, beam_fibers(model, u)
    block_data = []
    for b in model.blocks:
        if b.kind != "solid":
            block_data.append(postnodal.skip_block(b, model.dim, dev))
            continue
        coords_e = torch.as_tensor(model.coords[b.conn], device=dev)
        u_e = torch.as_tensor(u[b.conn], device=dev)
        D = torch.as_tensor(b.D, device=dev)
        table = get_table(b.etype)
        if b.etype == 361 and b.formulation == "IC":
            eps = solid.strains_at_gauss_hex8ic(table, coords_e, u_e, D)
        else:
            eps = solid.strains_at_gauss(table, coords_e, u_e)
        eps_el = eps
        if model.temperature is not None:
            eps_el = eps - torch.as_tensor(
                loads.thermal_strains(model, b, model.temperature),
                device=dev)
        sig = torch.einsum("eqkl,eql->eqk" if D.dim() == 4 else
                           "ekl,eql->eqk", D, eps_el)
        block_data.append(dict(etype=b.etype, conn=b.conn,
                               gauss_strain=eps, gauss_stress=sig))
    return u, postnodal.smooth(model.n_node, block_data, model.dim)


def run_linear_static(model: StructModel,
                      timings: Optional[dict] = None) -> StaticResult:
    check_recoverable(model)
    timings = {} if timings is None else timings
    with Phase(timings, "element_stiffness", model.device):
        kes = compute_element_stiffness(model)
    sol = solve_linear(model, kes, timings)
    with Phase(timings, "stress", model.device):
        u, sm = recover_stress(model, sol.x)
        # REACTION = K u - f_ext (static_make_result.f90:97-102)
        Ku = sol.op.matvec(torch.as_tensor(sol.x, device=model.device))
        reaction = (Ku.cpu().numpy() - model.f_ext).reshape(u.shape)
    return StaticResult(
        u=u, nodal_strain=sm["strain"], nodal_stress=sm["stress"],
        nodal_mises=sm["mises"], node_count=sm["count"],
        elem_strain=np.concatenate(sm["estrain"]),
        elem_stress=np.concatenate(sm["estress"]),
        elem_mises=np.concatenate(sm["emises"]),
        elem_ids=np.concatenate([b.elem_ids for b in model.blocks]),
        iters=sol.iters, relres=sol.relres, policy=sol.policy,
        passes=sol.passes, timings=timings, reaction=reaction)
