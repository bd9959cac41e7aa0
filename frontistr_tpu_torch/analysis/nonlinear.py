"""Nonlinear static analysis: Newton-Raphson with load substepping (torch
port of the single-device solid-elastic slice of
``frontistr_tpu/analysis/nonlinear.py``; reference FSTR_SOLVE_NLGEOM +
fstr_Newton, fistr1/src/analysis/static/fstr_solve_NLGEOM.f90:28-253,
fstr_solve_NonLinear.f90:29-167).

- per-gauss state (strain, stress and the rest of ``init_block_state``)
  lives in one dict of batched tensors per element block;
- each Newton iteration runs TANGENT (batched element stiffness) and
  UPDATE (strain/stress integration + internal force) per block, then
  the constrained solve of ``make_constrained_solver``: the cluster
  operator assembled through the K1 kernel, AMG (or block-Jacobi), and
  the mixed-precision refined CG or the float64 CG;
- convergence: rres = |B|/|Q| < CONVERG or rxnrm = |du|/|Du| < CONVERG
  (fstr_solve_NonLinear.f90:110-135), the four norms read back in one
  host transfer per iteration;
- divergence (MAXITER, MAXRES) cuts the substep back by Rc and restarts
  it from the committed state (fstr_solve_NLGEOM.f90:151-195).

The slice: the 2-D solids (tri3, tri6, quad4, quad8; plane stress,
plane strain, axisymmetric, with the section thickness) and the 3-D
solids (tet4/tet10, prism6/prism15, hex8/hex20, hex8 in its B-bar,
F-bar or, for linear STATIC decks, IC formulation) of an ELASTIC
(isotropic, orthotropic in its !ORIENTATION frame, or E(T), nu(T) from
the !ELASTIC rows), !PLASTIC (``fem/plastic.py``: MISES,
DRUCKER-PRAGER, MOHR-COULOMB), hyperelastic (``fem/hyper.py``),
viscoelastic with !TRS or Norton creep (``fem/visco.py``, their clock
the VISCO step's increment) or user material (``user.py``) with the
INFINITESIMAL, TOTALLAG or UPDATELAG flag (the 2-D blocks: ELASTIC or
!PLASTIC, not UPDATELAG, as in the JAX package); CLOAD,
DLOAD and TEMPERATURE loads, DLOAD as a follower load under nlgeom
(``assembly/loads.FollowerDload``, re-assembled on the device every
iteration); steps, substeps, AUTOINC, TIME_POINTS; !SPRING blocks in
the tangent and the internal force; !EQUATION eliminated around the
solve (T^T K T, ``assembly/extras.py``) with the residual reduced the
same way; rotational !BOUNDARY rows about ROT_CENTER, re-rotated from
the current positions every substep; METHOD=DIRECT as a host SuperLU
factor of each tangent (``solver/direct.py``; with !EQUATION the
iterative elimination, as in the JAX package); node-to-surface contact
(``ContactState``: a search every Newton iteration, the SLAGRANGE,
augmented-Lagrange with Coulomb friction, saddle-point and DIRECT arms
of ``analysis/contact.py``, the outer loop of contact passes with the
SLAGRANGE active-set scan or the AL update); !RESTART checkpoints and
resumes (``save_checkpoint``/``load_checkpoint``: the ``.npz`` or the
reference's blob stream; refused with !CONTACT, ROADMAP queue 3, fault
8); PRECOND=10-12, 20, 21 precondition the CG
with multicolor block SSOR (``solver/ssor.py``).  Shell, solid-shell and
beam blocks take a constant tangent and qf = ke u, with no gauss state
(an empty one in a checkpoint).  In a sharded run (a rank of
``parallel/dist.py``) the solve is the row-sharded ``RowSolver`` of
``parallel/shard.py`` (K1 on every rank over its rows, the AMG's level 0
row-sharded); a rank keeps only the elements that touch its rows (the
JAX package's ``ShardedNewton`` element ownership: tangent, update and
QFORCE over those elements, the gauss states on their rank, each owned
element's yield counted once), except on a follower-load deck, a
rotational boundary, a non-solid block or contact, where every rank
keeps the whole model (``_maybe_engine``'s exclusions; the contact
arms' products run over the rank's elements, ``shard.RowFEOperator``,
their Krylov vectors whole).  !RESTART and a contact deck's DIRECT arm
under sharding raise ``NotImplementedError`` naming themselves.  The
JAX package's jit-argument carry (a TPU remote-compile workaround) has
no counterpart: PyTorch runs eagerly.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from frontistr_tpu_torch import user
from frontistr_tpu_torch.analysis import contact as contact_mod
from frontistr_tpu_torch.analysis.static import (StaticResult, check_solver,
                                                 cluster_operator,
                                                 cluster_setup, solve_policy)
from frontistr_tpu_torch.assembly import extras, femop, loads
from frontistr_tpu_torch.assembly import operators as old_ops
from frontistr_tpu_torch.assembly.model import (StructModel, collect_boundary,
                                                collect_cload, rot_bc_disp)
from frontistr_tpu_torch.assembly.segsum import IndexAdd
from frontistr_tpu_torch.contact.ntos import ContactManager
from frontistr_tpu_torch.contact.slag import lag_rows
from frontistr_tpu_torch.device import Phase
from frontistr_tpu_torch.elements.tables import get_table
from frontistr_tpu_torch.fem import material as mat
from frontistr_tpu_torch.fem import solid
from frontistr_tpu_torch.fem.hyper import make_hyper_fns
from frontistr_tpu_torch.fem.isoparam import jacobians
from frontistr_tpu_torch.fem.plastic import (PlasticParams, plastic_tangent,
                                             return_mapping)
from frontistr_tpu_torch.fem.visco import (creep_return, creep_tangent,
                                           trs_shift, visco_D, visco_update)
from frontistr_tpu_torch.io import logio
from frontistr_tpu_torch.io.hecmw_restart import (export_solid_state,
                                                  import_solid_state)
from frontistr_tpu_torch.io.restart import load_restart, save_restart
from frontistr_tpu_torch.io.stafile import sta_final, sta_init, sta_status
from frontistr_tpu_torch.parallel import dist
from frontistr_tpu_torch.parallel import shard as shardmod
from frontistr_tpu_torch.post import nodal as postnodal
from frontistr_tpu_torch.post.shellpost import check_recoverable, \
    shell_recover
from frontistr_tpu_torch.solver import direct as direct_mod
from frontistr_tpu_torch.solver.cg import pcg
from frontistr_tpu_torch.solver.mixed import refined_cg


HYPER = (mat.HYPERELASTIC_NEOHOOKE, mat.HYPERELASTIC_MOONEYRIVLIN,
         mat.HYPERELASTIC_ARRUDABOYCE)
MATERIALS = (mat.ELASTIC, mat.EPLASTIC, mat.VISCOELASTIC, mat.CREEP,
             mat.USERMATERIAL) + HYPER


def init_block_state(block, table, device) -> dict:
    """Zero gauss state of a solid block (the JAX package's keys: the
    strains and stresses, the plastic state, ``fstat`` of a user
    material, the Prony terms ``vq``/``vq_new`` and the committed
    deviatoric strain ``ven`` of a viscoelastic one); an empty one for a
    shell, solid-shell or beam block, which carries no gauss history."""
    if block.kind != "solid" or table is None:
        return {}
    E, nq = len(block.elem_ids), table.nq
    ns = 6 if table.dim == 3 else 4

    def zeros(*shape):
        return torch.zeros((E, nq) + shape, dtype=torch.float64,
                           device=device)
    z, zs = zeros(ns), zeros()
    st = dict(strain=z, stress=z, strain_bak=z, stress_bak=z,
              pstrain=zs, pstrain_new=zs,
              yielded=torch.zeros((E, nq), dtype=torch.bool,
                                  device=device), back=z)
    m = block.material
    if m.mtype == mat.USERMATERIAL:
        st["fstat"] = zeros(max(m.user_nstatus, 1))
    if m.mtype == mat.VISCOELASTIC and m.visco_consts is not None:
        nterms = len(np.asarray(m.visco_consts).reshape(-1, 2))
        st.update(vq=zeros(nterms, ns), vq_new=zeros(nterms, ns), ven=z)
    return st


def _plastic_params(m: mat.Material) -> PlasticParams:
    """The block's !PLASTIC record as ``PlasticParams`` (MULTILINEAR:
    the (yield stress, plastic strain) rows as the table)."""
    consts = np.asarray(m.plastic_consts)
    table = consts.reshape(-1, 2) if m.hardening.upper() == "MULTILINEAR" \
        else None
    return PlasticParams(m.youngs, m.poisson, m.hardening.upper(),
                         consts.reshape(-1), table=table,
                         yield_func=m.yield_func.upper())


class BlockPrograms:
    """TANGENT / UPDATE for one solid element block (2-D or 3-D) of an
    ELASTIC (isotropic, orthotropic or temperature-dependent), !PLASTIC,
    hyperelastic, viscoelastic, creep or user material; hex8 blocks in
    their formulation (B-bar, F-bar, and IC for linear STATIC decks).
    ``time`` and ``dtime`` are the substep's end time and its increment
    (0 outside a VISCO step), as the rate-dependent materials read
    them."""

    def __init__(self, model: StructModel, block):
        self.block = block
        m = block.material
        dev = model.device
        self.conn = torch.as_tensor(block.conn, dtype=torch.int64,
                                    device=dev)
        self.ke = None
        if block.kind != "solid":
            # shells, solid-shells and beams: a constant tangent ke and
            # qf = ke u (frontistr_tpu/analysis/nonlinear.py:91-107)
            from frontistr_tpu_torch.analysis.static import \
                compute_element_stiffness
            self.ke = compute_element_stiffness(
                dataclasses.replace(model, blocks=[block]))[0]
            self.table, self.mtype, self.flag = None, mat.ELASTIC, \
                mat.INFINITESIMAL
            return
        if m.mtype not in MATERIALS:
            raise NotImplementedError(f"material {m.mtype} in the Newton "
                                      "driver")
        self.table = get_table(block.etype)
        self.dim = self.table.dim
        self.ns = 6 if self.dim == 3 else 4
        if self.dim == 2 and m.mtype not in (mat.ELASTIC, mat.EPLASTIC):
            # the laws are written in six strain components
            raise NotImplementedError(f"material {m.mtype} on the 2-D "
                                      f"element type {block.etype}")
        if self.dim == 2 and m.nlgeom == mat.UPDATELAG:
            # GEOMAT is 3-D only in the JAX package ("UL currently 3D
            # only")
            raise NotImplementedError("updated Lagrange (CAUCHY) on the "
                                      f"2-D element type {block.etype}")
        self.mtype = m.mtype
        self.flag = m.nlgeom
        self.thick = float(block.thick)
        self.pl = _plastic_params(m) if m.mtype == mat.EPLASTIC else None
        self.coords_e = torch.as_tensor(model.coords[block.conn],
                                        device=dev)
        # one material over the block: keep one (1, ...) matrix
        D_np = np.asarray(block.D)
        self._De_shape = D_np.shape
        if D_np.shape[0] > 1 and not np.any(D_np[1:] != D_np[:1]):
            D_np = D_np[:1]
        self.D_e = torch.as_tensor(D_np, dtype=torch.float64, device=dev)
        self.iso_lm = None
        if D_np.shape[0] == 1 and D_np.ndim == 3 and self.dim == 3 and \
                m.mtype == mat.ELASTIC and m.ortho_consts is None:
            E_, nu = float(m.youngs), float(m.poisson)
            self.iso_lm = (E_ * nu / ((1 + nu) * (1 - 2 * nu)),
                           E_ / (2 * (1 + nu)))

        def scalar(v):
            return torch.as_tensor(v, dtype=torch.float64, device=dev)
        if m.mtype in HYPER:
            # NEOHOOKE reads the material's (E, nu); the reference's law
            # ignores the !HYPERELASTIC card values
            self.pk2, self.hyper_tangent = make_hyper_fns(
                m.mtype, (m.youngs, m.poisson)
                if m.mtype == mat.HYPERELASTIC_NEOHOOKE else m.hyper_consts)
        if m.mtype == mat.VISCOELASTIC:
            vt = np.asarray(m.visco_consts).reshape(-1, 2)
            self.v_mus, self.v_taus = scalar(vt[:, 0]), scalar(vt[:, 1])
            self.v_G = m.youngs / (2.0 * (1.0 + m.poisson))
            self.v_K = m.youngs / (3.0 * (1.0 - 2.0 * m.poisson))
            # TRS reduced time at every gauss point: dt' = a(T) dt
            # (Viscoelastic.f90:128)
            self.v_tshift = None
            if m.trs_consts is not None and model.temperature is not None:
                tq = torch.einsum(
                    "qn,en->eq", solid.table_tensor(self.table, "N",
                                                    self.coords_e),
                    scalar(model.temperature)[self.conn])
                self.v_tshift = trs_shift(tq, m.trs_consts, m.trs_def)
        if m.mtype == mat.USERMATERIAL:
            fn = user.get_umat(m.name)
            if fn is None:
                raise ValueError(
                    f"!USER_MATERIAL '{m.name}': no umat registered; "
                    "register one with frontistr_tpu_torch.user."
                    "register_umat or set FRONTISTR_TPU_USER_MODULE")
            self.user_fn = fn
            self.user_matl = scalar(m.user_consts if m.user_consts
                                    is not None else np.zeros(0))
        if m.mtype == mat.CREEP:
            cc = np.asarray(m.creep_consts).reshape(-1)
            self.c_A, self.c_n = float(cc[0]), float(cc[1])
            self.c_m = float(cc[2]) if len(cc) > 2 else 0.0
            self.c_G = m.youngs / (2.0 * (1.0 + m.poisson))

    @property
    def bbar(self) -> bool:
        return self.block.etype == 361 and self.block.formulation == "BBAR"

    @property
    def fbar(self) -> bool:
        return self.block.etype == 361 and self.block.formulation == "FBAR"

    @property
    def ic(self) -> bool:
        return self.block.etype == 361 and self.block.formulation == "IC"

    def _De(self) -> torch.Tensor:
        """Full-shape elastic D (a broadcast view if compressed)."""
        return self.D_e.expand(self._De_shape)

    def _De_q(self) -> torch.Tensor:
        """The elastic D at every gauss point, (E, nq, ns, ns)."""
        D = self._De()
        return D if D.dim() == 4 else \
            D[:, None].expand(-1, self.table.nq, -1, -1)

    def _De_eps(self, eps) -> torch.Tensor:
        """De eps at every gauss point."""
        D = self._De()
        if D.dim() == 4:
            return torch.einsum("eqkl,eql->eqk", D, eps)
        return torch.einsum("ekl,eql->eqk", D, eps)

    def _material_D(self, state, time=0.0, dtime=0.0) -> torch.Tensor:
        if self.mtype in HYPER:
            # the tangent at the current strain, per gauss point
            return self.hyper_tangent(state["strain"])
        if self.mtype == mat.EPLASTIC:
            return plastic_tangent(self.pl, self._De_q(), state["stress"],
                                   state["pstrain_new"], state["back"],
                                   state["yielded"])
        if self.mtype == mat.VISCOELASTIC:
            if self.v_tshift is not None:
                return visco_D(dtime * self.v_tshift, self.v_G, self.v_K,
                               self.v_mus, self.v_taus)
            return visco_D(self.D_e.new_tensor(dtime), self.v_G, self.v_K,
                           self.v_mus, self.v_taus)[None]
        if self.mtype == mat.USERMATERIAL:
            return self.user_fn(self.user_matl, state["strain"],
                                state["stress"], state["fstat"], dtime,
                                time)[0]
        if self.mtype == mat.CREEP:
            return creep_tangent(self._De_q(), state["stress"],
                                 state["pstrain_new"], self.c_G, self.c_A,
                                 self.c_n, self.c_m, time, dtime)
        return self.D_e

    # ---------------- tangent (fstr_StiffMatrix / STF_C3) ----------------
    def tangent(self, u_e, ddu_e, state, time=0.0, dtime=0.0):
        if self.ke is not None:
            return self.ke
        table, flag, x0 = self.table, self.flag, self.coords_e
        total = u_e + ddu_e
        D = self._material_D(state, time, dtime)
        if flag == mat.INFINITESIMAL:
            if self.ic:
                return solid.stiffness_hex8ic(table, x0, D)
            if self.fbar:
                return solid.stiffness_hex8fbar(table, x0, D)
            if self.bbar:
                return solid.stiffness_nlgeom(table, x0, total, D,
                                              state["stress"],
                                              mat.INFINITESIMAL, bbar=True)
            if self.iso_lm is not None:
                return solid.stiffness_linear_iso(table, x0, *self.iso_lm)
            return solid.stiffness_linear(table, x0, D, thick=self.thick)
        if flag == mat.UPDATELAG:
            # D <- D - geomat(sigma) (STF_C3:117-120)
            D = (D[:, None] if D.dim() == 3 else D) - \
                _geomat(state["stress"])
        if self.fbar:
            return solid.stiffness_nlgeom_fbar(table, x0, total, D,
                                               state["stress"], flag)
        return solid.stiffness_nlgeom(table, x0, total, D, state["stress"],
                                      flag, thick=self.thick,
                                      bbar=self.bbar)

    # ---------------- update (fstr_UpdateNewton / UPDATE_C3) -------------
    def update(self, u_e, ddu_e, state, time=0.0, dtime=0.0):
        if self.ke is not None:
            return state, torch.einsum(
                "eij,ej->ei", self.ke, (u_e + ddu_e).reshape(len(self.ke),
                                                             -1))
        table, flag, thick = self.table, self.flag, self.thick
        dt = self.coords_e.dtype
        total = u_e + ddu_e
        if flag == mat.UPDATELAG:
            elem = self.coords_e + u_e + 0.5 * ddu_e   # midpoint config
            elem1 = self.coords_e + total
            disp = ddu_e
        else:
            elem = self.coords_e
            elem1 = None
            disp = total
        dN = solid.table_tensor(table, "dN", elem)
        det, gderiv = jacobians(dN, elem)
        S = solid._selector(self.dim, elem)
        # displacement gradient at the quadrature points: (E, nq, dim, dim)
        dudx = torch.einsum("end,eqnj->eqdj", disp, gderiv)
        # small-strain part (UPDATE_C3:131-139)
        eps = torch.einsum("kdj,eqdj->eqk", S, dudx)
        g0 = None
        if self.bbar or (self.fbar and flag != mat.TOTALLAG):
            # volumetric dilatation correction: centroid reference for
            # B-bar (Update_C3D8Bbar:70-94,151-156), volume average for
            # F-bar (Update_C3D8Fbar:532-541 INFINITE / :587-597 UL)
            if self.bbar:
                g0 = solid.centroid_gderiv(table, elem)
            else:
                g0, _, _ = solid.volavg_gderiv(table, elem)
            dudx0 = torch.einsum("end,enj->edj", disp, g0)
            vol0 = torch.diagonal(dudx0, dim1=-2, dim2=-1).sum(-1) / 3.0
            dvol = vol0[:, None] - \
                torch.diagonal(dudx, dim1=-2, dim2=-1).sum(-1) / 3.0
            eps = torch.cat([eps[..., :3] + dvol[..., None], eps[..., 3:]],
                            -1)

        new_state = dict(state)
        fb_ctx = None
        if flag == mat.TOTALLAG and self.fbar:
            # F-bar Green-Lagrange strain from Fbar = Jr (I + du/dX)
            # (Update_C3D8Fbar:556-565)
            _, g1 = jacobians(dN, self.coords_e + total)
            Jr, g1_ave = _fbar_jr(table, det, dudx, g1)
            eye = torch.eye(3, dtype=dt, device=elem.device)
            Fb = Jr[:, :, None, None] * (eye[None, None] + dudx)
            C = torch.einsum("eqki,eqkj->eqij", Fb, Fb)
            eps = torch.stack([
                0.5 * (C[..., 0, 0] - 1), 0.5 * (C[..., 1, 1] - 1),
                0.5 * (C[..., 2, 2] - 1), C[..., 0, 1], C[..., 1, 2],
                C[..., 2, 0]], dim=-1)
            fb_ctx = (Jr, g1, g1_ave, eps)
            new_state["strain"] = eps
            new_state["stress"] = self._stress_total(eps, state, new_state,
                                                     time, dtime)
        elif flag in (mat.TOTALLAG, mat.INFINITESIMAL):
            if flag == mat.TOTALLAG:
                # Green-Lagrange quadratic terms (UPDATE_C3:154-168)
                eps = eps + torch.einsum("kij,eqdi,eqdj->eqk", 0.5 * S,
                                         dudx, dudx)
            new_state["strain"] = eps
            new_state["stress"] = self._stress_total(eps, state, new_state,
                                                     time, dtime)
        else:  # UPDATELAG: incremental with Jaumann rotation
            new_state["strain"] = state["strain_bak"] + eps
            rot = 0.5 * (dudx - dudx.transpose(-1, -2))
            sig_b = solid._stress_tensor(state["stress_bak"], self.dim)
            dum = rot @ sig_b - sig_b @ rot
            sig = state["stress_bak"] + self._De_eps(eps) + \
                _tensor_to_voigt(dum, self.ns)
            if self.mtype == mat.CREEP and dtime > 0.0:
                # Norton return on the rotated trial (UPDATE_C3
                # UPDATELAG NORTON arm)
                sig, dg, _ = creep_return(sig, self.c_G, self.c_A,
                                          self.c_n, self.c_m, time, dtime)
                new_state["pstrain_new"] = dg
            elif self.mtype == mat.CREEP:
                new_state["pstrain_new"] = torch.zeros_like(
                    state["pstrain_new"])
            new_state["stress"] = sig

        if self.mtype == mat.EPLASTIC:
            sig, p_new, yielded, back = return_mapping(
                self.pl, new_state["stress"], state["pstrain"],
                state["back"])
            new_state.update(stress=sig, pstrain_new=p_new,
                             yielded=yielded, back=back)

        # internal force (UPDATE_C3 tail): B evaluated per flag
        sig = new_state["stress"]
        if flag == mat.TOTALLAG and self.fbar:
            # qf = [Jr^2 (B0 + B1) + B2]^T sigma
            # (Update_C3D8Fbar:663-733 TOTALLAG arm)
            Jr, g1, g1_ave, eps_fb = fb_ctx
            w = solid.table_tensor(table, "weights", elem)
            wdet = w[None, :] * det
            wdet2 = wdet * Jr ** 2
            qf0 = torch.einsum("kdj,eqnj,eqk,eq->end", S, gderiv, sig,
                               wdet2)
            qf1 = torch.einsum("kij,eqdi,eqnj,eqk,eq->end", S, dudx,
                               gderiv, sig, wdet2)
            z1q = (g1_ave[:, None] - g1) / 3.0
            fac = torch.cat([2 * eps_fb[..., :3] + 1.0,
                             2 * eps_fb[..., 3:]], -1)
            sf = torch.einsum("eqk,eqk->eq", sig, fac)
            qf2 = torch.einsum("eq,eqnd,eq->end", sf, z1q, wdet)
            qf = (qf0 + qf1 + qf2).reshape(gderiv.shape[0], -1)
        elif flag == mat.TOTALLAG:
            qf = _qf_totallag(table, S, gderiv, det, dudx, sig, thick)
            if self.bbar:
                qf = qf + _qf_bbar_extra(table, gderiv, g0, det, sig)
        elif flag == mat.UPDATELAG:
            det1, gderiv1 = jacobians(dN, elem1)
            if self.fbar:
                # qf = [B(elem1) + B2]^T sigma Jr^3 w det1
                # (Update_C3D8Fbar:735-766 UPDATELAG arm); Jr and the
                # jacob-weighted g1_ave come from the total displacement
                # on the reference configuration (:430-456)
                det0, g0d = jacobians(dN, self.coords_e)
                dudx_t = torch.einsum("end,eqnj->eqdj", total, g0d)
                Jr, g1_ave = _fbar_jr(table, det0, dudx_t, gderiv1)
                w = solid.table_tensor(table, "weights", elem)
                wdet = w[None, :] * det1 * Jr ** 3
                qf0 = torch.einsum("kdj,eqnj,eqk,eq->end", S, gderiv1,
                                   sig, wdet)
                z1q = (g1_ave[:, None] - gderiv1) / 3.0
                tr_s = sig[..., 0] + sig[..., 1] + sig[..., 2]
                qf2 = torch.einsum("eq,eqnd,eq->end", tr_s, z1q, wdet)
                qf = (qf0 + qf2).reshape(gderiv1.shape[0], -1)
            else:
                qf = solid.internal_force(table, elem1, sig, thick=thick)
                if self.bbar:
                    g01 = solid.centroid_gderiv(table, elem1)
                    qf = qf + _qf_bbar_extra(table, gderiv1, g01, det1,
                                             sig)
        elif self.bbar or self.fbar:
            # the F-bar INFINITE correction has the B-bar row shape with
            # the volume-averaged reference (Update_C3D8Fbar:676-689)
            qf = solid.internal_force(table, self.coords_e, sig)
            qf = qf + _qf_bbar_extra(table, gderiv, g0, det, sig)
        elif self.ic:
            # IC element: qf from the condensed elastic stiffness
            ke = solid.stiffness_hex8ic(table, self.coords_e, self._De())
            qf = torch.einsum("eij,ej->ei", ke,
                              disp.reshape(ke.shape[0], -1))
        else:
            qf = solid.internal_force(table, self.coords_e, sig,
                                      thick=thick)
        return new_state, qf

    def _stress_total(self, eps, state, new_state, time, dtime):
        """Stress from the total strain (INFINITE / TOTALLAG arms)."""
        if self.mtype == mat.USERMATERIAL:
            # the uUpdate plug point (umat.f90:30-41)
            _, sig, new_state["fstat"] = self.user_fn(
                self.user_matl, eps, state["stress"], state["fstat"],
                dtime, time)
            return sig
        if self.mtype in HYPER:
            return self.pk2(eps)
        if self.mtype == mat.VISCOELASTIC and dtime != 0.0:
            dte = dtime * self.v_tshift if self.v_tshift is not None \
                else dtime
            sig, new_state["vq_new"] = visco_update(
                eps, state["vq"], state["ven"], dte, self.v_G, self.v_K,
                self.v_mus, self.v_taus)
            return sig
        if self.mtype == mat.VISCOELASTIC:
            new_state["vq_new"] = state["vq"]
        return self._De_eps(eps)


def _geomat(stress):
    """GEOMAT_C3 (static_LIB_3d.f90): the UL material-matrix
    correction, (E, nq, 6, 6)."""
    s11, s22, s33 = stress[..., 0], stress[..., 1], stress[..., 2]
    s12, s23, s31 = stress[..., 3], stress[..., 4], stress[..., 5]
    G = stress.new_zeros(stress.shape[:2] + (6, 6))
    entries = {(0, 0): 2 * s11, (1, 1): 2 * s22, (2, 2): 2 * s33,
               (0, 3): s12, (1, 3): s12, (1, 4): s23, (2, 4): s23,
               (0, 5): s31, (2, 5): s31,
               (3, 3): 0.5 * (s11 + s22), (4, 4): 0.5 * (s22 + s33),
               (5, 5): 0.5 * (s11 + s33), (3, 4): 0.5 * s31,
               (4, 5): 0.5 * s12, (3, 5): 0.5 * s23}
    for (i, j), v in entries.items():
        G[..., i, j] = v
        G[..., j, i] = v
    return G


def _tensor_to_voigt(t, ns):
    """Tensor -> Voigt: 3-D (11, 22, 33, 12, 23, 31); 2-D (11, 22, 12)
    and a zero fourth component."""
    if ns == 6:
        return torch.stack([t[..., 0, 0], t[..., 1, 1], t[..., 2, 2],
                            t[..., 0, 1], t[..., 1, 2], t[..., 2, 0]], -1)
    return torch.stack([t[..., 0, 0], t[..., 1, 1], t[..., 0, 1],
                        torch.zeros_like(t[..., 0, 0])], -1)


def _fbar_jr(table, det0, dudx0, g1):
    """F-bar volume ratio of both Lagrangian arms (Update_C3D8Fbar:430-456,
    556-560): from the reference jacobians ``det0`` and the displacement
    gradient ``dudx0`` on the reference configuration, Jr = (J_ave / J)^(1/3)
    per gauss point, and the J-weighted element average of the current
    shape derivatives ``g1``.  Returns (Jr (E, nq), g1_ave (E, nn, 3))."""
    eye = torch.eye(3, dtype=dudx0.dtype, device=dudx0.device)
    jacob = torch.linalg.det(eye[None, None] + dudx0)
    w = solid.table_tensor(table, "weights", det0)
    wg0 = w[None, :] * det0
    jwg = wg0 * jacob
    V0J = jwg.sum(dim=1)
    g1_ave = torch.einsum("eq,eqnd->end", jwg, g1) / V0J[:, None, None]
    jacob_ave = V0J / wg0.sum(dim=1)
    Jr = (jacob_ave ** (1.0 / 3.0))[:, None] * jacob ** (-1.0 / 3.0)
    return Jr, g1_ave


def _qf_bbar_extra(table, gderiv, g0, det, stress):
    """B-bar internal-force correction: the modified rows add
    (g0 - g)/3 tr(sigma) per direction column (Update_C3D8Bbar:261-276).
    Returns (E, nn*dim)."""
    w = solid.table_tensor(table, "weights", det)
    wdet = w[None, :] * det
    trs = stress[..., 0] + stress[..., 1] + stress[..., 2]
    corr = (g0[:, None] - gderiv) / 3.0                  # (E, nq, nn, dim)
    E, _, nn, dim = corr.shape
    return torch.einsum("eqnd,eq,eq->end", corr, trs, wdet) \
        .reshape(E, nn * dim)


def _qf_totallag(table, S, gderiv, det, dudx, stress, thick=1.0):
    """qf = (B0 + B1)^T S integrated on the reference configuration
    (UPDATE_C3:252-297; a 2-D block over its thickness)."""
    w = solid.table_tensor(table, "weights", det)
    E, _, nn, dim = gderiv.shape
    wdet = (w * (thick if dim == 2 else 1.0))[None, :] * det
    qf0 = torch.einsum("kdj,eqnj,eqk,eq->end", S, gderiv, stress, wdet)
    # B1[k, (n, d)] = S[k, i, j] dudx[d, i] g[n, j]
    qf1 = torch.einsum("kij,eqdi,eqnj,eqk,eq->end", S, dudx, gderiv, stress,
                       wdet)
    return (qf0 + qf1).reshape(E, nn * dim)


# ---------------- the linear solve of each Newton iteration ---------------

def _precond_policy(sv) -> Optional[str]:
    """The JAX package's preconditioner choice
    (``frontistr_tpu/analysis/nonlinear.py:1036-1043``):
    FRONTISTR_TPU_PRECOND, else the .cnt PRECOND id (3: block-Jacobi;
    10-12, 20, 21, the reference's BILU, SAINV and RIF: multicolor
    block-SSOR, ``solver/ssor.py``; others, and ``cheby`` here: AMG when
    the deck is large enough)."""
    return os.environ.get("FRONTISTR_TPU_PRECOND") or \
        {3: "jacobi", 10: "ssor", 11: "ssor", 12: "ssor", 20: "ssor",
         21: "ssor"}.get(getattr(sv, "precond", 1))


def make_constrained_solver(model: StructModel, free: torch.Tensor,
                            gather: torch.Tensor, mixed: bool,
                            timings: Optional[dict] = None, shard=None):
    """The constrained solve of the whole analysis: the symbolic profiles,
    AMG maps and incidence are built here, once; each call
    ``solve(kes, B, dirichlet_inc, gfac=0.0)`` (``kes`` the element
    blocks' tangents; the model's spring blocks are appended) assembles
    the tangents through K1, sets the preconditioner up and solves

        P K P x + (I-P) x = (B - K d) * P + d * (I-P),  d = dirichlet_inc

    with the refined CG (mixed: float32 cluster CG, float64 matrix-free
    residuals, at most 6 passes) or the float64 CG.  With !EQUATION the
    system is eliminated around both operators, T^T K T, the constants
    scaled by ``gfac`` (``solve.mpc`` holds the tables, None without).
    METHOD=DIRECT without !EQUATION factors K on the host instead.
    ``solve.last_iters``, ``solve.last_passes`` and ``solve.last_relres``
    describe the last call.  ``gather`` is the incidence gather of
    ``femop.incidence_gather(model, device)``.  ``shard`` (a rank's
    ``shard.NewtonShard``) gives the row-sharded ``RowSolver`` instead:
    ``kes`` are then the matrices of the rank's elements when it owns
    them, else of the whole model."""
    sv = model.cfg.solver
    method = check_solver(sv)
    timings = {} if timings is None else timings
    if shard is not None:
        pol = _precond_policy(sv)
        shardmod.check_policy(method, pol)
        return shardmod.RowSolver(model, shard.lm, shard.split, free, mixed,
                                  timings, policy=pol,
                                  select=not shard.owned)
    dev = model.device
    ex_kes, ex_dofs = extras.extra_tensors(model, dev)
    dofs = [torch.as_tensor(b.dofs, dtype=torch.int64, device=dev)
            for b in model.blocks] + ex_dofs
    mpc = extras.mpc_arrays(model.mesh, model.ndof, model.n_dof_total, dev)

    def operator(kes):
        return femop.FEOperator(list(kes) + ex_kes, dofs, gather,
                                model.n_node, model.ndof, free)

    if method in direct_mod.METHODS and mpc is None:
        def solve(kes, B, dirichlet_inc, gfac=0.0):
            # METHOD=DIRECT: host SuperLU on the current tangent
            # (fstr_solve_NonLinear.f90 -> solve_LINEQ)
            with Phase(timings, "solve", dev):
                x = direct_mod.solve_direct(operator(kes), B, dirichlet_inc)
            return torch.as_tensor(x, device=dev)

        solve.last_iters = solve.last_passes = 0
        solve.last_relres = 0.0
        solve.mpc = None
        return solve

    setup = cluster_setup(model, timings, policy=_precond_policy(sv))
    dtype = torch.float32 if mixed else torch.float64

    def solve(kes, B, dirichlet_inc, gfac=0.0):
        op = operator(kes)
        b_c = op.constrained_rhs(B, dirichlet_inc)
        A, M = cluster_operator(setup, model, kes, free, dtype, timings)
        A64 = op.apply_constrained
        if mpc is not None:
            b_c = extras.mpc_reduce_rhs(mpc, A64, b_c, gfac)
            A, A64 = extras.mpc_wrap(mpc, A), extras.mpc_wrap(mpc, A64)
            M = extras.mpc_precond(mpc, M)
        with Phase(timings, "solve", dev):
            if mixed:
                res = refined_cg(A64, A, M, b_c, tol=sv.resid,
                                 inner_tol=1e-6, maxiter=sv.nier,
                                 max_passes=6)
                solve.last_passes = res.passes
            else:
                res = pcg(A, b_c, M=M, tol=sv.resid, maxiter=sv.nier)
                solve.last_passes = 0
            x = res.x if mpc is None else \
                extras.mpc_recover(mpc, res.x, gfac)
        solve.last_iters = int(res.iters)
        solve.last_relres = float(res.relres)
        return x

    solve.last_iters = solve.last_passes = 0
    solve.last_relres = float("nan")
    solve.mpc = mpc
    return solve


# ---------------- contact ---------------------------------------------------

class ContactState:
    """A contact deck's state in the Newton driver and the implicit
    dynamics: the manager, the arm (``contact.contact_arm``) and its
    solve, the SLAGRANGE slots of the current pass; the counterpart of
    the contact parts of the JAX package's ``run_nonlinear_static``,
    ``_newton_substep`` and ``_run_implicit``.  ``eff=(c1, c2)`` with
    the lumped ``mass``: the Newmark effective matrix (dynamics: the
    SLAGRANGE or the penalty arm, never DIRECT or the saddle arm, as in
    the JAX package).  Every search runs in the phase
    ``contact_search``; ``retries`` counts the DIRECT arm's falls back
    on the iterative solve after a singular factor (the JAX package's
    solver retry)."""

    def __init__(self, model: StructModel, cm: ContactManager, gather,
                 timings: dict, eff=None, mass=None):
        self.model, self.cm, self.gather = model, cm, gather
        self.timings, self.eff, self.mass = timings, eff, mass
        dynamic = eff is not None
        self.direct = not dynamic and \
            check_solver(model.cfg.solver) in direct_mod.METHODS
        if self.direct and dist.current() is not None:
            raise NotImplementedError("!SOLVER METHOD=DIRECT with !CONTACT "
                                      "under FRONTISTR_TPU_SHARDS")
        slag_ok = cm.algo == "SLAGRANGE" and not cm.has_friction
        self.slag_mpc = False
        if model.mesh.equations:
            if self.direct:
                print("### WARNING: !EQUATION constraints are not applied "
                      "to the DIRECT contact arms; MPC ignored for this run")
            elif slag_ok:
                self.slag_mpc = contact_mod.contact_mpc_disjoint(cm, model)
                if not self.slag_mpc and dynamic:
                    print("### WARNING: !EQUATION dofs overlap the contact "
                          "surfaces; SLAGRANGE+MPC composition is invalid "
                          "— MPC ignored for this run")
                elif not self.slag_mpc:
                    print("### NOTE: !EQUATION dofs overlap the contact "
                          "surfaces; SLAGRANGE elimination composition is "
                          "invalid — solving the KKT saddle system "
                          "iteratively instead (no-elimination arm)")
        if dynamic:
            self.arm = "slag" if slag_ok else "al"
        else:
            self.arm = contact_mod.contact_arm(model, cm, self.slag_mpc,
                                               self.direct)
        self.char = float(np.abs(model.coords).max()) or 1.0
        self.tol = (cm.ntol if cm.ntol > 0 else 1e-5) * self.char
        self.g_tol = 1e-8 * max(float(np.abs(model.coords).max()), 1.0)
        self.solver = self.slag = self.cn = self.cact = self._al = None
        self.retries = 0

    @classmethod
    def make(cls, model, gather, timings, eff=None, mass=None):
        """The contact state of a deck with a !CONTACT card on a mesh
        !CONTACT PAIR, or None."""
        if not (model.mesh.contact_pairs and model.cfg.contacts):
            return None
        cm = ContactManager(model.mesh, model, model.cfg)
        return cls(model, cm, gather, timings, eff, mass) if cm.active \
            else None

    def build(self, free) -> None:
        """The arm's solve for the step's free mask."""
        m, g, tm = self.model, self.gather, self.timings
        kw = dict(eff=self.eff, mass=self.mass, timings=tm)
        if self.arm == "saddle":
            self.solver, self.slag = contact_mod.make_saddle_contact_solver(
                m, free, g, mpc=bool(m.mesh.equations), **kw)
        elif self.arm == "slag":
            self.solver, self.slag = contact_mod.make_slag_contact_solver(
                m, free, g, mpc=self.slag_mpc, **kw)
        else:
            self.solver = contact_mod.make_contact_solver(
                m, free, g, friction=self.cm.has_friction,
                mpc=not self.direct, **kw)

    def search(self, u_tot: torch.Tensor) -> dict:
        m = self.model
        with Phase(self.timings, "contact_search", m.device):
            return self.cm.search(m.coords + u_tot.cpu().numpy().reshape(
                m.n_node, m.ndof))

    def _host_kes(self, kes):
        ex_kes, ex_dofs = extras.extra_tensors(self.model, "cpu")
        return (list(kes) + ex_kes,
                [b.dofs for b in self.model.blocks] + ex_dofs)

    def _blocks(self, proj, like):
        """The penalty blocks of a search: (cdofs, cke, the contact
        force's plan, the force as a vector like ``like``)."""
        cdofs, cke, cqf, _, _ = self.cm.device_blocks(proj)
        add = IndexAdd.build(cdofs, like.device,
                             keep=(cke != 0.0).any(axis=2) | (cqf != 0.0))
        Qc = add(torch.zeros_like(like), torch.as_tensor(cqf,
                                                         device=like.device))
        return cdofs, cke, add, Qc

    def solve(self, it, kes, B, u_tot, dirichlet_inc, gfac, free):
        """One Newton iteration's increment: a search at ``u_tot``, then
        the arm's solve (the SLAGRANGE active set frozen at the pass's
        first iteration)."""
        cm, m = self.cm, self.model
        dev, n = m.device, m.n_dof_total
        proj = self.search(u_tot)
        if self.slag is not None:
            if it == 1:
                self.freeze(proj)
            # the saddle arm masks the fixed columns itself, as the JAX
            # package's does
            self.cn = self.slag.build(
                proj, cm.all_slaves, self.cact,
                *((free, dirichlet_inc) if self.arm == "slag" else ()))
            if self.direct:
                # METHOD=DIRECT: explicit Lagrange rows and a host
                # saddle-point factor; a body held only by contact can be
                # exactly singular (tangential rigid modes), and then the
                # iterative arm solves it, as the JAX package does
                Bl, g = lag_rows(proj, cm.all_slaves, self.cact, m.ndof,
                                 n, free=free.cpu().numpy())
                try:
                    with Phase(self.timings, "solve", dev):
                        x, _ = direct_mod.solve_direct_lag(
                            *self._host_kes(kes), n, free, B, Bl, g,
                            u_fix=dirichlet_inc)
                    self.solver.last_iters = 0
                    return torch.as_tensor(x, device=dev)
                except RuntimeError:
                    self.retries += 1
            return self.solver(kes, B, dirichlet_inc, self.cn, gfac)
        cdofs, cke, add, Qc = self._blocks(proj, B)
        B = B - Qc
        if self.direct:
            with Phase(self.timings, "solve", dev):
                x = direct_mod.solve_direct_al(
                    *self._host_kes(kes), n, free, B, cdofs, cke,
                    u_fix=dirichlet_inc)
            self.solver.last_iters = 0
            return torch.as_tensor(x, device=dev)
        return self.solver(kes, B, dirichlet_inc,
                           torch.as_tensor(cdofs, dtype=torch.int64,
                                           device=dev),
                           torch.as_tensor(cke, device=dev), add, gfac)

    def freeze(self, proj) -> None:
        """Freeze the SLAGRANGE active set of a pass: the touching,
        closed slots not released by the last scan (fstr_scan_contact_state
        runs between passes, never inside Newton)."""
        self.cact = proj["touching"] & (proj["gap"] <= self.g_tol) & \
            ~self.cm.slag_released
        self.cm._last_cact = self.cact

    # ---- implicit dynamics (the JAX package's _run_implicit) ----
    def dyn_residual(self, B, u_tot, dirichlet_inc, free):
        """A dynamics Newton iteration: a search at ``u_tot``; returns
        (B less the penalty arm's contact force, the convergence
        residual), the SLAGRANGE slots or the penalty blocks kept for
        ``dyn_solve``."""
        proj = self.search(u_tot)
        mpc = self.solver.mpc
        if self.slag is not None:
            self.cn = self.slag.build(proj, self.cm.all_slaves, self.cact,
                                      free, dirichlet_inc)
            self.cm._last_B = B
            r = B if mpc is None else extras.mpc_Tt(mpc, B)
            return B, self.slag.Tt(self.cn, r) * free
        cdofs, cke, add, Qc = self._blocks(proj, B)
        self._al = (torch.as_tensor(cdofs, dtype=torch.int64,
                                    device=B.device),
                    torch.as_tensor(cke, device=B.device), add)
        B = B - Qc
        return B, (B if mpc is None else extras.mpc_Tt(mpc, B))

    def dyn_solve(self, kes, B, dirichlet_inc):
        if self.slag is not None:
            return self.solver(kes, B, dirichlet_inc, self.cn)
        return self.solver(kes, B, dirichlet_inc, *self._al)

    def residual(self, r: torch.Tensor, u_tot: torch.Tensor, free):
        """The convergence residual of ``r`` = gl - Q at ``u_tot``: in the
        reduced space under SLAGRANGE (the active set frozen), less the
        contact force of a new search under the penalty arm; !EQUATION
        reduced too."""
        mpc = self.solver.mpc
        if self.slag is not None:
            self.cm._last_B = r
            if mpc is not None:
                r = extras.mpc_Tt(mpc, r)
            return self.slag.Tt(self.cn, r) * free
        r = r - self._blocks(self.search(u_tot), r)[3]
        if mpc is not None:
            r = extras.mpc_Tt(mpc, r)
        return r * free

    def settled(self, u_tot: torch.Tensor) -> bool:
        """After a converged pass: SLAGRANGE scans the active set
        (fstr_scan_contact_state: release tensile slots, re-activate
        penetrating ones), the penalty arm augments (lambda <- p) and
        tests Uzawa convergence.  True when no further pass is
        needed."""
        cm = self.cm
        proj = self.search(u_tot)
        touching, gap = proj["touching"], proj["gap"]
        if self.slag is not None:
            cact = cm._last_cact
            lam_c = self.slag.pressure(proj, cm.all_slaves, cact,
                                       cm._last_B).cpu().numpy()
            scale = max(float(np.abs(lam_c).max()), 1.0)
            rel_new = cact & (lam_c < -1e-8 * scale)
            act_new = (~cact) & touching & (gap < -self.tol)
            cm.slag_released |= rel_new
            cm.slag_released &= ~act_new
            live = touching & ~cm.slag_released
            pen = float(np.maximum(-gap, 0.0)[live].max()) \
                if live.any() else 0.0
            return not rel_new.any() and not act_new.any() and \
                pen < self.tol
        pen = float(np.maximum(-gap, 0.0)[touching].max()) \
            if touching.any() else 0.0
        lam_pre = cm.lam.copy()
        cm.augment(proj)
        dlam = float(np.abs(cm.lam - lam_pre).max()) if cm.lam.size else 0.0
        return pen < self.tol and dlam <= cm.kn * self.tol

    def active_set(self) -> np.ndarray:
        """The slots in contact: the last pass's frozen set under
        SLAGRANGE, lambda > 0 under the penalty arm."""
        if self.slag is not None:
            return np.asarray(self.cm._last_cact, bool).copy()
        return self.cm.lam > 0


# ---------------- the substep / Newton driver ------------------------------

def _load_group_universe(cfg):
    """All GRPIDs on load cards (CLOAD, DLOAD, TEMPERATURE)."""
    cards = list(cfg.cloads) + list(cfg.dloads) + list(cfg.temperatures)
    return {c.iparam("GRPID", 1) for c in cards}


def _active_sets(cfg, cstep):
    """Per-!STEP active load groups split by the reference's cross-step
    factor rule (fstr_ass_load.f90:69-70): groups active in this step and
    the previous one are held at factor 1.0, groups new in this step ramp
    0 -> 1.  A step without LOAD lines activates everything.

    Returns (sel_held, sel_ramp) as sets of GRPIDs."""
    universe = _load_group_universe(cfg)

    def active(step_idx):
        if step_idx < 1:
            return set()
        lg = cfg.steps[step_idx - 1].load_groups
        return set(lg) if lg else set(universe)

    cur = active(cstep)
    prev = active(cstep - 1)
    return cur & prev, cur - prev


def _assemble_loads_sel(model, cfg, sel, dload=True) -> np.ndarray:
    """External load vector (CLOAD, DLOAD at the reference geometry when
    ``dload``, thermal) of the load groups in ``sel``."""
    if not sel:
        return np.zeros(model.n_dof_total)
    f = collect_cload(model.mesh, cfg.cloads, model.ndof, model.n_node,
                      sel)
    if cfg.dloads and dload:
        f = f + loads.collect_dload(model.mesh, model, cfg.dloads, sel)
    if cfg.temperatures and model.temperature is not None:
        T = loads.collect_temperature(model.mesh, cfg.temperatures,
                                      model.n_node, cfg.reftemp, sel)
        if T is not None:
            f = f + loads.thermal_load(model, T)
    return f


def _follower(model, tensor, sel=None):
    """The follower load of an nlgeom deck with DLOAD cards as
    ``gl(u, lam2)``, assembled on the device at ``coords0 + u``
    (fstr_ass_load.f90:165-196): the first step's ``(f_base + f_dload(u))
    * lam2``, or, for a later !STEP of a multi-step deck, the held part
    ``sel = (sel_held, sel_ramp)`` at factor 1 plus the ramped part at
    lam2.  None without follower loads."""
    if not (model.nlgeom and model.dload_grp is not None):
        return None
    cfg = model.cfg
    if sel is None:
        fol = loads.FollowerDload(model, *model.dload_grp)
        f_base = tensor(model.f_base)
        return lambda u, lam2: (f_base + fol(u)) * lam2
    sel_h, sel_r = sel
    fol_h = loads.FollowerDload(model, cfg.dloads, sel_h)
    fol_r = loads.FollowerDload(model, cfg.dloads, sel_r)
    f_h = tensor(_assemble_loads_sel(model, cfg, sel_h, dload=False))
    f_r = tensor(_assemble_loads_sel(model, cfg, sel_r, dload=False))
    return lambda u, lam2: f_h + fol_h(u) + (f_r + fol_r(u)) * lam2


@dataclasses.dataclass
class NewtonStats:
    substeps: int = 0
    total_iters: int = 0
    max_iters: int = 0
    cutbacks: int = 0
    # one dict per Newton iteration: step, substep, iter, rres, rxnrm,
    # cg_iters, passes, relres and the seconds of its phases (a contact
    # deck: also its contact pass and active slot count)
    history: List[dict] = dataclasses.field(default_factory=list)
    # a contact deck: one dict per converged substep: step, substep, the
    # Newton iterations of each contact pass and the active set after it
    contact: List[dict] = dataclasses.field(default_factory=list)


def check_log(model: StructModel) -> None:
    """Refuse to write the 0.log of a Newton or dynamic run of beams and
    solid-shells only: no node carries a stress there, and the JAX
    package's log writer fails on the empty node set (ROADMAP, queue
    3)."""
    if all(b.kind in ("beam", "beam341", "sshell") for b in model.blocks):
        raise NotImplementedError(
            "the 0.log of an NLSTATIC or DYNAMIC run of beams and "
            "solid-shells only (the JAX package's log writer fails: no "
            "node carries a stress)")


def _check_request(model: StructModel, restart_path=None,
                   log_path=None) -> None:
    check_recoverable(model)
    if log_path is not None:
        check_log(model)
    if dist.current() is not None and restart_path:
        raise NotImplementedError("!RESTART under FRONTISTR_TPU_SHARDS")
    if restart_path and model.mesh.contact_pairs and model.cfg.contacts:
        # the JAX package's static checkpoint holds no contact state, so
        # its resumed ALAGRANGE run leaves the uninterrupted one (ROADMAP,
        # queue 3, fault 8)
        raise NotImplementedError("!RESTART with !CONTACT in the Newton "
                                  "driver")


def host_states(states) -> List[dict]:
    """The gauss states as dicts of host numpy arrays (a checkpoint's
    payload)."""
    return [{k: v.cpu().numpy() for k, v in s.items()} for s in states]


def device_states(host, like, device) -> List[dict]:
    """Host gauss states back on ``device``, each array in the dtype of
    the same key of ``like`` (the zero states; a key ``like`` lacks keeps
    its own dtype)."""
    return [{k: torch.as_tensor(np.asarray(v), device=device,
                                dtype=ref[k].dtype if k in ref else None)
             for k, v in h.items()} for h, ref in zip(host, like)]


def load_checkpoint(path: str, states, blocks, device):
    """A checkpoint of the Newton driver: the ``.npz`` (a file starting
    with ``PK``) or the reference's blob stream (``io/hecmw_restart.py``;
    a file the reference binary wrote resumes here).  Returns (u as a
    host array, t, step count, states on ``device``), as
    ``frontistr_tpu/analysis/nonlinear.py:1756-1776`` reads it."""
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"PK":
        rz = load_restart(path)
        u, t, sc, st = rz["u"], rz["t"], rz["step_count"], rz["states"]
    else:
        u, t, sc, st = import_solid_state(path, host_states(states), blocks)
    return (np.asarray(u, np.float64), float(np.asarray(t)),
            int(np.asarray(sc)), device_states(st, states, device))


def save_checkpoint(path: str, u, t: float, dt: float, step_count: int,
                    states, blocks, Q=None) -> None:
    """The committed state every ``restart_freq`` substeps
    (fstr_write_restart cadence, fstr_solve_NLGEOM.f90:204-207): u, t,
    the step count and the gauss states in the ``.npz``, or with
    FRONTISTR_TPU_RESTART_FORMAT=hecmw the reference's blob stream (u,
    QFORCE, strain and stress by gauss point, the plastic strain and
    yield flag as its status arrays)."""
    hs = host_states(states)
    un = u.cpu().numpy()
    if os.environ.get("FRONTISTR_TPU_RESTART_FORMAT", "").lower() == "hecmw":
        export_solid_state(path, un, np.zeros_like(un) if Q is None
                           else Q.cpu().numpy(), hs, blocks,
                           step_count=step_count, ctime=t, dtime=dt,
                           steptime=t)
    else:
        save_restart(path, dict(u=un, t=np.asarray(t),
                                step_count=np.asarray(step_count),
                                states=hs))


def run_nonlinear_static(model: StructModel, log_path: Optional[str] = None,
                         timings: Optional[dict] = None,
                         restart_path: Optional[str] = None,
                         restart_freq: int = 0) -> StaticResult:
    """Substep / Newton driver on ``model.device``.  Returns the final
    ``StaticResult``; ``result.newton`` holds the ``NewtonStats``,
    ``result.iters`` the total Newton iterations.  With ``log_path`` it
    writes the 0.log block of every substep and FSTR.sta beside it.
    ``restart_path`` (the !RESTART card): when the file exists the run
    resumes from it (the first step's time and the step count restored);
    with ``restart_freq`` > 0 a checkpoint is written there every
    ``restart_freq`` committed substeps (phases ``restart_load`` and
    ``restart_save``)."""
    _check_request(model, restart_path, log_path)
    timings = {} if timings is None else timings
    cfg = model.cfg
    ndof = model.ndof
    n = model.n_dof_total
    dev = model.device
    u = torch.zeros(n, dtype=torch.float64, device=dev)
    # a sharded run: the rank's elements (or the whole model) and rows
    shard = shardmod.newton_shard(model)
    emodel = shard.lm.model if shard is not None and shard.owned else model
    programs = [BlockPrograms(emodel, b) for b in emodel.blocks]
    states = [init_block_state(b, p.table, dev)
              for b, p in zip(emodel.blocks, programs)]

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)

    u_fix_total = tensor(old_ops.full_fixed_vector(n, model.fixed_dofs,
                                                   model.fixed_vals))
    free = tensor(old_ops.make_free_mask(n, model.fixed_dofs))
    gather = femop.incidence_gather(emodel, dev)
    f_total = tensor(model.f_ext)
    sta_path = None
    if log_path is not None:
        sta_path = os.path.join(os.path.dirname(os.path.abspath(log_path))
                                or ".", "FSTR.sta")
        sta_init(sta_path)
    stats = NewtonStats()
    policy = solve_policy(dev, "NLSTATIC")
    mixed = policy == "mixed"
    solver = None
    contact = ContactState.make(model, gather, timings)
    step_count = 0
    result = None
    Q_last = None
    resume = None
    if restart_path and os.path.exists(restart_path):
        with Phase(timings, "restart_load", dev):
            u0, t0, sc0, states = load_checkpoint(restart_path, states,
                                                  model.blocks, dev)
            u = tensor(u0)
            resume = (t0, sc0)

    multi = len(cfg.steps) > 1
    f_held = None
    f_ramp = f_total
    follow = None if multi else _follower(model, tensor)
    for cstep, step in enumerate(cfg.steps, start=1):
        if multi:
            # per-!STEP BC/load bookkeeping: this step's Dirichlet set,
            # loads split into held (active in the previous step too ->
            # factor 1.0, fstr_ass_load.f90:69-70) and ramped parts
            bgrp = set(step.boundary_groups) if step.boundary_groups \
                else None
            fx_d, fx_v = collect_boundary(model.mesh, cfg.boundaries,
                                          ndof, bgrp)
            u_fix_total = tensor(old_ops.full_fixed_vector(n, fx_d, fx_v))
            free = tensor(old_ops.make_free_mask(n, fx_d))
            sel_held, sel_ramp = _active_sets(cfg, cstep)
            f_held = tensor(_assemble_loads_sel(model, cfg, sel_held))
            f_ramp = tensor(_assemble_loads_sel(model, cfg, sel_ramp))
            follow = _follower(model, tensor, (sel_held, sel_ramp))
        if contact is not None:
            # the JAX package builds the cluster solver here too, but no
            # contact solve uses it
            contact.build(free)
        elif multi or solver is None:
            solver = make_constrained_solver(model, free, gather, mixed,
                                             timings, shard=shard)
        t_end = step.elapsetime
        dt = step.initdt
        ainc = _ainc_params(cfg, step)
        ainc_stat = 0
        tpoints = _time_points(cfg, step)
        t = 0.0
        if resume is not None and cstep == 1:
            t, step_count = resume
        sub = 0
        cb_count = 0
        while t < t_end - 1e-12:
            dt = min(dt, t_end - t)
            if tpoints is not None:
                # land substeps exactly on !TIME_POINTS
                # (get_remain_to_next_timepoints, fstr_Ctrl_TimeInc.f90:219)
                nxt = tpoints[tpoints > t + 1e-12 * t_end]
                if len(nxt):
                    dt = min(dt, float(nxt[0]) - t)
            lam2 = (t + dt) / t_end
            lam1 = t / t_end
            sub += 1
            # the rate-dependent materials' clock: the substep's end time
            # and, in a VISCO step only, its increment
            tincr = dt if step.solution == "VISCO" else 0.0
            passes = []
            for cont_it in range(step.max_contiter if contact else 1):
                converged, du, new_states, iters, Q_last = _newton_substep(
                    emodel, programs, states, u, f_ramp, free, u_fix_total,
                    lam1, lam2, step, gather, solver, f_held=f_held,
                    follow=follow, timings=timings, stats=stats,
                    tag=(cstep, sub, cont_it + 1), ctime=t + dt,
                    tincr=tincr, contact=contact, shard=shard)
                passes.append(iters)
                if contact is None or not converged or \
                        contact.settled(u + du):
                    break
            if contact is not None and converged:
                stats.contact.append(dict(
                    step=cstep, substep=sub, passes=passes,
                    active=contact.active_set()))
            stats.total_iters += iters
            stats.max_iters = max(stats.max_iters, iters)
            if not converged:
                cb_count += 1
                stats.cutbacks += 1
                if sta_path:
                    sta_status(sta_path, cstep, sub, 1, iters, iters, t,
                               dt, cutback=cb_count,
                               message="Failed to converge due to "
                               "MAXITER.")
                ainc_stat = -1
                if cb_count > ainc["CBbound"] or dt <= step.mindt:
                    if sta_path:
                        sta_final(sta_path, False)
                    raise RuntimeError(
                        f"Newton failed to converge at step {cstep} "
                        f"substep {sub} (dt={dt})")
                # cutback ratio Rc (fstr_TimeInc_SetTimeIncrement)
                dt = dt * ainc["Rc"]
                sub -= 1
                continue
            cb_count = 0
            if sta_path:
                sta_status(sta_path, cstep, sub, 1, iters,
                           stats.total_iters, t, dt)
            t += dt
            u = u + du
            # commit state (fstr_UpdateState)
            states = [_commit_state(s) for s in new_states]
            stats.substeps += 1
            step_count += 1
            if restart_path and restart_freq > 0 and \
                    step_count % restart_freq == 0:
                with Phase(timings, "restart_save", dev):
                    save_checkpoint(restart_path, u, t, dt, step_count,
                                    states, model.blocks, Q_last)
            if log_path is not None:
                with Phase(timings, "post", dev):
                    result = _postprocess(model, states, u, Q=Q_last,
                                          shard=shard)
                    _append_log(log_path, model, result, step_count)
            if step.inc_type == "AUTO":
                # !AUTOINC_PARAM heuristics (fstr_Ctrl_TimeInc.f90:168-210)
                dec = iters > min(ainc["bound_s"])
                inc_ok = iters <= min(ainc["bound_l"])
                if dec:
                    ainc_stat = min(ainc_stat, 0) - 1
                elif inc_ok:
                    ainc_stat = max(ainc_stat, 0) + 1
                else:
                    ainc_stat = 0
                if ainc_stat >= ainc["NRtimes_l"]:
                    dt = min(dt * ainc["Rl"], step.maxdt)
                elif ainc_stat <= -ainc["NRtimes_s"]:
                    dt = max(dt * ainc["Rs"], step.mindt)

    if result is None:
        with Phase(timings, "post", dev):
            result = _postprocess(model, states, u, Q=Q_last, shard=shard)
            if log_path is not None:
                _append_log(log_path, model, result, max(step_count, 1))
    if sta_path:
        sta_final(sta_path, True)
    result.iters = stats.total_iters
    result.policy = policy
    result.passes = sum(h["passes"] for h in stats.history)
    result.newton = stats
    result.timings = timings
    return result


def _time_points(cfg, step):
    """!TIME_POINTS NAME=..., TIME=STEP|TOTAL [,GENERATE] -> sorted array
    of step-relative times (fstr_ctrl_get_TIMEPOINTS,
    fstr_ctrl_common.f90:655-690)."""
    name = (getattr(step, "timepoints", "") or "").upper()
    cards = getattr(cfg, "time_points", [])
    if not cards:
        return None
    for c in cards:
        if name and (c.param("NAME") or "").upper() != name:
            continue
        rows = c.rows_f()
        if c.param("GENERATE") is not None:
            r = rows[0] + [0.0]
            ts = np.arange(r[0], r[1] + 1e-12, max(r[2], 1e-30))
        else:
            ts = np.asarray([r[0] for r in rows if r])
        return np.sort(ts)
    return None


def _ainc_params(cfg, step):
    """!AUTOINC_PARAM card (fstr_get_AUTOINC, fstr_ctrl_common.f90:572-640)
    with init_AincParam defaults (m_step.f90:160-180)."""
    p = dict(Rs=0.25, Rl=1.25, bound_s=(10, 50, 10), bound_l=(1, 1, 1),
             NRtimes_s=1, NRtimes_l=2, Rc=0.25, CBbound=5)
    name = (step.aincparam or "").upper()
    for c in getattr(cfg, "autoinc_params", []):
        if name and (c.param("NAME") or "").upper() != name:
            continue
        rows = c.rows_f()
        if len(rows) > 0 and rows[0]:
            r = rows[0] + [0] * 5
            p["Rs"] = r[0] or p["Rs"]
            p["bound_s"] = tuple(int(v) for v in r[1:4])
            p["NRtimes_s"] = int(r[4]) or 1
        if len(rows) > 1 and rows[1]:
            r = rows[1] + [0] * 5
            p["Rl"] = r[0] or p["Rl"]
            p["bound_l"] = tuple(int(v) for v in r[1:4])
            p["NRtimes_l"] = int(r[4]) or 1
        if len(rows) > 2 and rows[2]:
            r = rows[2] + [0] * 2
            p["Rc"] = r[0] or p["Rc"]
            p["CBbound"] = int(r[1]) or p["CBbound"]
        break
    return p


def _commit_state(s):
    if not s:
        return s
    out = dict(s)
    out["strain_bak"] = s["strain"]
    out["stress_bak"] = s["stress"]
    out["pstrain"] = s["pstrain_new"]
    if "vq" in s:
        # updateViscoElasticState: the new Prony terms and the committed
        # deviatoric strain
        out["vq"] = s["vq_new"]
        eps = s["strain"]
        th = (eps[..., 0] + eps[..., 1] + eps[..., 2]) / 3.0
        out["ven"] = torch.cat([eps[..., :3] - th[..., None],
                                0.5 * eps[..., 3:]], -1)
    return out


def _element_values(v: torch.Tensor, p: BlockPrograms, n_node: int,
                    ndof: int) -> torch.Tensor:
    return v.reshape(n_node, ndof)[p.conn]


def _newton_substep(model, programs, states, u, f_total, free, u_fix_total,
                    lam1, lam2, step, gather, solve, f_held=None,
                    follow=None, timings=None, stats=None, tag=(1, 1, 1),
                    ctime=0.0, tincr=0.0, contact=None, shard=None):
    """One substep's Newton loop from the committed ``(u, states)``;
    ``follow(u, lam2)`` (``_follower``) replaces the external load at
    the start of every iteration; ``ctime``/``tincr`` the materials'
    time and increment; ``contact`` a contact deck's ``ContactState``
    (its arm solves instead of ``solve``); ``tag`` (step, substep,
    contact pass); ``shard`` a rank's ``shard.NewtonShard`` (``model``
    then holds the rank's elements when it owns them: QFORCE is right on
    its rows and is all-gathered).  Returns (converged, du, states,
    iterations, Q)."""
    sync = shard.sync if shard is not None else None
    if contact is not None:
        solve = contact.solver
    n_node, ndof = model.n_node, model.ndof
    dev = model.device
    timings = {} if timings is None else timings
    du = torch.zeros_like(u)
    # prescribed displacement increment of this substep (fstr_AddBC)
    dufix = u_fix_total * (lam2 - lam1)
    if model.rot_bcs:
        # rotational BC: the incremental Rodrigues rotation of the current
        # slave positions about the center (fstr_AddBC.f90:112-160)
        u_np = u.cpu().numpy()
        for ent in model.rot_bcs:
            dofs_r, vals_r = rot_bc_disp(ent, model.coords, u=u_np,
                                         factor=lam2 - lam1)
            dufix[torch.as_tensor(dofs_r, device=dev)] = \
                torch.as_tensor(vals_r, device=dev)
    # multi-step decks: a held part (factor 1.0) plus the ramped part
    gl = f_total * lam2 if f_held is None else f_held + f_total * lam2
    states_cur = states
    conv = False
    iters = 0
    with Phase(timings, "update", dev):
        Q_cur = _qforce(model, programs, states_cur, u, du, gather, ctime,
                        tincr, sync=sync)
    for it in range(1, step.max_iter + 1):
        iters = it
        t0 = dict(timings)
        with Phase(timings, "tangent", dev):
            kes = [p.tangent(_element_values(u, p, n_node, ndof),
                             _element_values(du, p, n_node, ndof), s,
                             ctime, tincr)
                   for p, s in zip(programs, states_cur)]
        if follow is not None:
            with Phase(timings, "follower_load", dev):
                gl = follow(u + du, lam2)
        B = gl - Q_cur
        dirichlet_inc = dufix if it == 1 else torch.zeros_like(dufix)
        gfac = (lam2 - lam1) if it == 1 else 0.0
        if contact is None:
            dx = solve(kes, B, dirichlet_inc, gfac)
        else:
            dx = contact.solve(it, kes, B, u + du, dirichlet_inc, gfac,
                               free)
        del kes
        with Phase(timings, "update", dev):
            du = du + dx
            # stress/state update + internal force, one pass per block
            new_states, qfs = [], []
            for p, s in zip(programs, states_cur):
                ns_, qf = p.update(_element_values(u, p, n_node, ndof),
                                   _element_values(du, p, n_node, ndof), s,
                                   ctime, tincr)
                new_states.append(ns_)
                qfs.append(qf)
            states_cur = new_states
            Q = femop.gather_sum(qfs + _spring_forces(model, u + du),
                                 gather)
            if sync is not None:
                Q = sync(Q)
            Q_cur = Q
            # !EQUATION: the residual in the reduced space, so the forces
            # a constraint carries cancel (fstr_Update_NDForce_MPC)
            if contact is not None:
                Bres = contact.residual(gl - Q, u + du, free)
            else:
                Bres = (gl - Q if solve.mpc is None else
                        extras.mpc_Tt(solve.mpc, gl - Q)) * free
            # one device->host transfer per Newton iteration
            res_n, qnrm, xnrm, dunrm, n_yield = _conv_norms(
                Bres, Q, dx, du, new_states, shard)
        if qnrm < 1e-8:
            qnrm = 1.0
        if it == 1:
            dunrm = xnrm
        rres = res_n / qnrm
        rxnrm = xnrm / max(dunrm, 1e-300)
        if stats is not None:
            rec = dict(step=tag[0], substep=tag[1], iter=it, rres=rres,
                       rxnrm=rxnrm, cg_iters=solve.last_iters,
                       passes=solve.last_passes, relres=solve.last_relres,
                       yielded=int(n_yield))
            if contact is not None:
                rec.update(contact_pass=tag[2],
                           active=int(np.count_nonzero(contact.active_set()))
                           if contact.slag is not None else -1)
            for k in ("tangent", "assembly", "amg_setup", "solve",
                      "update", "follower_load", "contact_search"):
                rec[k] = timings.get(k, 0.0) - t0.get(k, 0.0)
            stats.history.append(rec)
        if os.environ.get("FRONTISTR_TPU_DEBUG_NEWTON"):
            # per-iteration Newton residual trace (the reference prints
            # these at fstr_solve_NonLinear.f90 loglevel ILOG)
            print(f" Newton it={it:3d}  rres={rres:.6e}  "
                  f"rxnrm={rxnrm:.6e}")
        if not model.nlgeom and _all_linear(programs):
            conv = True
            break
        if rres < step.converg or rxnrm < step.converg:
            conv = True
            break
        if rres > step.maxres:
            return False, du, states_cur, iters, Q_cur
    return conv, du, states_cur, iters, Q_cur


def _conv_norms(Bres, Q, dx, du, states, shard=None):
    """|Bres|, |Q|, |dx|, |du| and the count of yielded gauss points in
    one host transfer (the vectors are whole on every rank; a rank that
    owns its elements counts the gauss points of its owned ones, summed
    over the ranks)."""
    v = torch.sqrt(torch.stack([torch.dot(Bres, Bres), torch.dot(Q, Q),
                                torch.dot(dx, dx), torch.dot(du, du)]))
    if shard is not None and shard.owned:
        ny = shard.yielded(states).to(v.dtype)
    else:
        ny = sum((s["yielded"].sum() for s in states if s),
                 v.new_zeros(())).to(v.dtype)
    return [float(x) for x in torch.cat([v, ny[None]]).cpu()]


def _all_linear(programs):
    return all(p.flag == mat.INFINITESIMAL and p.mtype == mat.ELASTIC
               for p in programs)


def _spring_forces(model, u_tot):
    """The spring blocks' force rows k u (E, ndof) at the total
    displacement, in ``model.extras`` order."""
    ex_kes, ex_dofs = extras.extra_tensors(model, u_tot.device)
    return [torch.einsum("eij,ej->ei", k, u_tot[d])
            for k, d in zip(ex_kes, ex_dofs)]


def _qforce(model, programs, states, u, du, gather, time=0.0, dtime=0.0,
            sync=None):
    """Global internal force QFORCE from the per-block updates and the
    springs (``sync``: a sharded rank's all-gather of its rows)."""
    qfs = [p.update(_element_values(u, p, model.n_node, model.ndof),
                    _element_values(du, p, model.n_node, model.ndof),
                    s, time, dtime)[1]
           for p, s in zip(programs, states)]
    Q = femop.gather_sum(qfs + _spring_forces(model, u + du), gather)
    return Q if sync is None else sync(Q)


def _postprocess(model, states, u, Q=None, shard=None) -> StaticResult:
    """The result of the committed state; a rank that owns its elements
    smooths them and gathers the whole result (``NewtonShard.post``)."""
    if shard is not None and shard.owned:
        return shard.post(_postprocess(shard.lm.model, states, u, Q))
    un = u.cpu().numpy().reshape(model.n_node, model.ndof)
    # REACTION = the converged internal force minus the applied load
    # (fstrSOLID%REACTION, static_make_result.f90:97-102)
    reaction = None
    if Q is not None:
        reaction = Q.cpu().numpy().reshape(model.n_node, model.ndof) - \
            np.asarray(model.f_ext).reshape(model.n_node, model.ndof)
    if any(b.kind == "shell" for b in model.blocks):
        sm = shell_recover(model, un)
    else:
        # shell-less non-solid blocks have no continuum gauss state
        block_data = [dict(etype=b.etype, conn=b.conn,
                           gauss_strain=s["strain"],
                           gauss_stress=s["stress"]) if s else
                      postnodal.skip_block(b, model.dim, model.device)
                      for b, s in zip(model.blocks, states)]
        sm = postnodal.smooth(model.n_node, block_data, model.dim)
    return StaticResult(
        u=un, nodal_strain=sm["strain"], nodal_stress=sm["stress"],
        nodal_mises=sm["mises"], node_count=sm["count"],
        elem_strain=np.concatenate(sm["estrain"]),
        elem_stress=np.concatenate(sm["estress"]),
        elem_mises=np.concatenate(sm["emises"]),
        elem_ids=np.concatenate([b.elem_ids for b in model.blocks]),
        iters=0, relres=0.0, policy="", passes=0, reaction=reaction)


def _append_log(log_path, model, result, step_no):
    logio.write_static_log(
        log_path, step_no, model.dim, result.u, result.nodal_strain,
        result.nodal_stress, result.nodal_mises, result.elem_strain,
        result.elem_stress, result.elem_mises, model.mesh.node_ids,
        result.elem_ids, append=os.path.exists(log_path) and step_no > 1,
        node_count=result.node_count)
