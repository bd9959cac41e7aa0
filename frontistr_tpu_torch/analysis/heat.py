"""Heat conduction, steady and transient (torch port of
``frontistr_tpu/analysis/heat.py``; reference fistr1/src/analysis/heat/):

  - temperature-dependent conductivity and capacity from piecewise-linear
    tables, clamped at both ends (heat_init.f90:196-231 funcA/funcB;
    ``_interp``, the counterpart of ``jnp.interp``)
  - conductance matrices k_e = int kappa(T) grad N . grad N dV
    (heat_LIB_THERMAL.f90 heat_THERMAL_<etype>), the 541 gap interface,
    and the lumped capacity (heat_LIB_CAPACITY.f90; HRZ for the
    second-order types)
  - !FIXTEMP, !CFLUX, !DFLUX (face flux S1..S6 and body generation BF),
    !SFLUX, !FILM/!SFILM (K += int h N N^T, f += int h Tamb N,
    heat_LIB_FILM.f90), !RADIATE/!SRADIATE (the quartic factorisation
    about the current temperature, heat_LIB_RADIATE.f90:95-107), !ZERO
    and the moving !WELD_LINE source
  - steady: the fixed-point loop on ||T_new - T_old||_2 <= eps
    (heat_solve_SS.f90); transient: backward Euler with the capacity
    lumped at the step's starting T and the same fixed-point loop inside
    every step (heat_solve_TRAN.f90).

The model (``build_heat_model``, ``weld_flux``) is host numpy, as in the
JAX package.  The element routines and the solve run on
``model.device``: a Jacobi-preconditioned CG on the matrix-free
``femop.FEOperator`` at one dof a node, over the volume, interface and
surface-film blocks.  Per-node sums (the capacity, the film right-hand
side) go through the incidence gather-sum in element order, so a run
repeats to the bit on the card.  The JAX package runs a plain transient
deck as one ``lax.scan`` and a weld-line deck as an eager loop; both
compute the same numbers, and the port has one loop: one host read of
the fixed-point change per iteration and one of the log's extrema per
step.  !EQUATION ties temperatures by the dependent-dof elimination at
one dof a node (``assembly/extras.py``), their constants at factor 1
(temperatures are totals).  METHOD=DIRECT assembles K + C/dt into CSR
and factors it on the host at every fixed-point pass, as the
conductances change with T (``solver/direct.py``); with !EQUATION it
takes the eliminated CG, as in the JAX package.  !RESTART checkpoints a
transient run (T, t and the step count) every FREQUENCY steps and
resumes from it; a steady run ignores the card, as the JAX package's
does.  In a sharded run (``parallel/dist.py``; the JAX package's
``_HeatSolver`` nshard arm) each solve is the row-sharded CG of
``shard.row_pcg`` over the rank's elements' rows, the temperatures whole
on every rank; !RESTART and METHOD=DIRECT there raise
``NotImplementedError`` naming themselves.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from frontistr_tpu_torch.assembly import extras, femop
from frontistr_tpu_torch.assembly.loads import FACE_TABLES
from frontistr_tpu_torch.device import Phase, resolve
from frontistr_tpu_torch.elements.tables import ETYPE_INFO, get_table
from frontistr_tpu_torch.fem.isoparam import jacobians
from frontistr_tpu_torch.fem.solid import table_tensor
from frontistr_tpu_torch.io.ctrlio import AnalysisConfig, HeatConfig
from frontistr_tpu_torch.io.meshio import Mesh
from frontistr_tpu_torch.io.restart import load_restart, save_restart
from frontistr_tpu_torch.parallel import dist
from frontistr_tpu_torch.parallel import shard as shardmod
from frontistr_tpu_torch.solver import direct
from frontistr_tpu_torch.solver.cg import pcg

F64 = torch.float64
HEAT_ETYPES = (231, 232, 241, 242, 341, 342, 351, 352, 361, 362)
HRZ_ETYPES = (232, 242, 342, 352, 362)     # HRZ-lumped capacity


@dataclasses.dataclass
class HeatBlock:
    etype: int
    elem_ids: np.ndarray
    conn: np.ndarray
    thick: float
    cond_table: np.ndarray      # (n, 2) (value, temp) rows
    rho_table: np.ndarray
    cp_table: np.ndarray
    # interface element (541): (thick, hh, rr1, rr2) from
    # !SECTION TYPE=INTERFACE; None for volume elements
    iface: Optional[tuple] = None


@dataclasses.dataclass
class WeldLine:
    """!WELD_LINE moving heat source (fstr_ctrl_get_WELDLINE
    'RRRR' + 'S IRRRR': I,U,coe,v / egrp,xyz,n1,n2,distol,tstart;
    applied as heat_mat_ass_bc_DFLUX.f90:112-180 — total power
    I*U*coe spread over the volume of the elements whose centroid
    along axis ``xyz`` lies within ``distol`` of the torch position
    n1 + v*(t - tstart))."""
    current: float
    voltage: float
    coe: float
    v: float
    xyz: int                                  # 1/2/3 = x/y/z
    n1: float
    n2: float
    distol: float
    tstart: float
    elems: List[tuple]                        # (block_idx, elem_sel rows)


@dataclasses.dataclass
class HeatModel:
    mesh: Mesh
    cfg: AnalysisConfig
    n_node: int
    coords: np.ndarray
    dim: int
    blocks: List[HeatBlock]
    fixtemp_nodes: np.ndarray
    fixtemp_vals: np.ndarray
    f_const: np.ndarray                       # CFLUX + DFLUX contributions
    films: List[tuple]                        # (block_idx, elem_sel, face, h, sink)
    radiates: List[tuple]                     # (block_idx, elem_sel, face, rr, sink)
    zero_temp: float = 0.0
    weldlines: List[WeldLine] = dataclasses.field(default_factory=list)
    device: torch.device = torch.device("cpu")


def _mat_table(md, item, default=0.0):
    rows = md.items.get(item) if md else None
    if not rows:
        return np.asarray([[default, 0.0]])
    out = []
    for r in rows:
        v = r[0]
        t = r[1] if len(r) > 1 else 0.0
        out.append([v, t])
    return np.asarray(out)


def _interp(table, T: torch.Tensor) -> torch.Tensor:
    """Piecewise linear in temperature, clamped at both ends (heat_init
    funcA/B): ``jnp.interp(T, table[:, 1], table[:, 0])`` step for step
    (the right-sided search, the segment's slope, a zero-width segment
    taking its left value), and a one-row table a constant.  ``table``
    is a numpy (n, 2) array of (value, temp) rows or its tensor on T's
    device."""
    tab = torch.as_tensor(table, dtype=T.dtype, device=T.device)
    vals, temps = tab[:, 0].contiguous(), tab[:, 1].contiguous()
    n = tab.shape[0]
    if n == 1:
        return torch.zeros_like(T) + vals[0]
    i = torch.searchsorted(temps, T.contiguous(), right=True).clamp(1, n - 1)
    t0, v0 = temps[i - 1], vals[i - 1]
    dx = temps[i] - t0
    df = vals[i] - v0
    flat = dx.abs() <= np.spacing(np.finfo(np.float64).eps)
    f = torch.where(flat, v0,
                    v0 + ((T - t0) / torch.where(flat, 1.0, dx)) * df)
    f = torch.where(T < temps[0], vals[0], f)
    return torch.where(T > temps[-1], vals[-1], f)


def build_heat_model(mesh: Mesh, cfg: AnalysisConfig,
                     device="cuda") -> HeatModel:
    """The host model of a heat deck, its solve placed on ``device``
    (default the card; without one, an error)."""
    dev = resolve(device)
    blocks = []
    for b in mesh.blocks:
        if b.etype != 541 and b.etype not in HEAT_ETYPES:
            raise NotImplementedError(f"element type {b.etype} in heat "
                                      "analysis")
    dim = max(ETYPE_INFO[b.etype][0] for b in mesh.blocks
              if b.etype in ETYPE_INFO)
    for b in mesh.blocks:
        sec = mesh.sections[b.section_id] if mesh.sections else None
        md = mesh.materials.get(sec.material) if sec else None
        thick = sec.values[0] if sec and sec.values else 1.0
        if b.etype == 541:
            # gap/interface element: !SECTION TYPE=INTERFACE carries
            # (thickness, conductance, rr1, rr2)
            # (heat_mat_ass_conductivity.f90:123-129)
            v = list(sec.values) + [0.0] * 4 if sec else [1.0, 0.0, 0, 0]
            blocks.append(HeatBlock(
                b.etype, b.elem_ids, b.conn, v[0],
                cond_table=_mat_table(md, 3),
                rho_table=_mat_table(md, 1),
                cp_table=_mat_table(md, 2),
                iface=(v[0], v[1], v[2], v[3])))
            continue
        blocks.append(HeatBlock(
            b.etype, b.elem_ids, b.conn, thick,
            cond_table=_mat_table(md, 3),
            rho_table=_mat_table(md, 1),
            cp_table=_mat_table(md, 2)))

    n_node = mesh.n_node
    # FIXTEMP
    fnodes, fvals = [], []
    for c in cfg.fixtemps:
        for row in c.data:
            grp, val = row[0], float(row[1]) if len(row) > 1 else 0.0
            if grp in mesh.node_groups:
                idx = mesh.node_groups[grp]
            else:
                try:
                    idx = np.asarray([mesh.id2idx[int(grp)]])
                except (ValueError, KeyError):
                    continue
            fnodes.append(idx)
            fvals.append(np.full(len(idx), val))
    fixtemp_nodes = (np.concatenate(fnodes) if fnodes
                     else np.zeros(0, np.int64))
    fixtemp_vals = np.concatenate(fvals) if fvals else np.zeros(0)

    # constant flux loads
    f = np.zeros(n_node)
    for c in cfg.cfluxes:
        for row in c.data:
            grp, val = row[0], float(row[1])
            if grp in mesh.node_groups:
                f[mesh.node_groups[grp]] += val
            else:
                try:
                    f[mesh.id2idx[int(grp)]] += val
                except (ValueError, KeyError):
                    pass

    eid2loc = {}
    for bi, b in enumerate(blocks):
        for k, eid in enumerate(b.elem_ids):
            eid2loc[int(eid)] = (bi, k)

    def elems_of(grp):
        eids = mesh.elem_groups.get(grp)
        if eids is None:
            try:
                eids = np.asarray([int(grp)])
            except ValueError:
                return {}
        by_block: Dict[int, List[int]] = {}
        for eid in eids:
            loc = eid2loc.get(int(eid))
            if loc:
                by_block.setdefault(loc[0], []).append(loc[1])
        return by_block

    coords = mesh.coords[:, :dim]
    for c in cfg.dfluxes:
        for row in c.data:
            grp, ltype, val = row[0], row[1].upper(), float(row[2])
            for bi, rows_ in elems_of(grp).items():
                b = blocks[bi]
                sel = np.asarray(rows_, np.int64)
                if ltype == "BF":       # body heat generation
                    t = get_table(b.etype)
                    ce = coords[b.conn[sel]]
                    J = np.einsum("qni,enj->eqij", t.dN, ce)
                    det = np.abs(np.linalg.det(J))
                    scale = b.thick if dim == 2 else 1.0
                    vect = np.einsum("qn,eq,q->en", t.N, det * scale,
                                     t.weights) * val
                    np.add.at(f, b.conn[sel].reshape(-1), vect.reshape(-1))
                elif ltype.startswith("S"):
                    face = int(ltype[1:])
                    if face == 0:
                        continue
                    vect, lnodes = _surface_integral_N(
                        b, coords, sel, face, dim)
                    np.add.at(f, b.conn[sel][:, lnodes].reshape(-1),
                              (val * vect).reshape(-1))

    # surface-group cards: !SFLUX/!SFILM/!SRADIATE address SGROUP
    # (elem, face) pairs and route into the same face kernels as the
    # element-group DFLUX-S/FILM/RADIATE arms (fstr_ctrl_heat.f90
    # fstr_ctrl_get_SFLUX/SFILM/SRADIATE; applied via the Q_SUF arm of
    # heat_mat_ass_bc_DFLUX.f90:32-41 and its FILM/RADIATE analogs)
    def faces_of(grp):
        pairs = mesh.surf_groups.get(grp)
        if pairs is None:
            print(f"### WARNING: surface group '{grp}' not in mesh; "
                  f"card ignored")
            return {}
        by_bf: Dict[tuple, List[int]] = {}
        for eid, face in np.asarray(pairs, np.int64):
            loc = eid2loc.get(int(eid))
            if loc:
                by_bf.setdefault((loc[0], int(face)), []).append(loc[1])
        return by_bf

    for c in cfg.sfluxes:
        for row in c.data:
            grp, val = row[0], float(row[1])
            for (bi, face), rows_ in faces_of(grp).items():
                b = blocks[bi]
                sel = np.asarray(rows_, np.int64)
                vect, lnodes = _surface_integral_N(b, coords, sel, face,
                                                   dim)
                np.add.at(f, b.conn[sel][:, lnodes].reshape(-1),
                          (val * vect).reshape(-1))

    films, radiates = [], []
    for c in cfg.sfilms:
        for row in c.data:
            grp, h = row[0], float(row[1])
            sink = float(row[2]) if len(row) > 2 else 0.0
            for (bi, face), rows_ in faces_of(grp).items():
                films.append((bi, np.asarray(rows_, np.int64), face, h,
                              sink))
    for c in cfg.sradiates:
        for row in c.data:
            grp, rr = row[0], float(row[1])
            sink = float(row[2]) if len(row) > 2 else 0.0
            for (bi, face), rows_ in faces_of(grp).items():
                radiates.append((bi, np.asarray(rows_, np.int64), face,
                                 rr, sink))
    for c in cfg.films:
        for row in c.data:
            grp, ltype = row[0], row[1].upper()
            h, sink = float(row[2]), float(row[3]) if len(row) > 3 else 0.0
            face = int(ltype[1:]) if ltype.startswith("F") else 1
            for bi, rows_ in elems_of(grp).items():
                films.append((bi, np.asarray(rows_, np.int64), face, h,
                              sink))
    for c in cfg.radiates:
        for row in c.data:
            grp, ltype = row[0], row[1].upper()
            rr, sink = float(row[2]), float(row[3]) if len(row) > 3 else 0.0
            face = int(ltype[1:]) if ltype.startswith("R") else 1
            for bi, rows_ in elems_of(grp).items():
                radiates.append((bi, np.asarray(rows_, np.int64), face, rr,
                                 sink))

    weldlines = []
    for c in cfg.weldlines:
        if len(c.data) < 2:
            print("### WARNING: !WELD_LINE needs two data lines; ignored")
            continue
        r0 = [float(v) for v in c.data[0][:4]]
        r1 = c.data[1]
        egrp = r1[0]
        eids = mesh.elem_groups.get(egrp)
        if eids is None:
            print(f"### WARNING: weld line element group '{egrp}' not in "
                  f"mesh; card ignored")
            continue
        elems: Dict[int, List[int]] = {}
        for eid in eids:
            loc = eid2loc.get(int(eid))
            if loc:
                elems.setdefault(loc[0], []).append(loc[1])
        weldlines.append(WeldLine(
            current=r0[0], voltage=r0[1], coe=r0[2], v=r0[3],
            xyz=int(float(r1[1])), n1=float(r1[2]), n2=float(r1[3]),
            distol=float(r1[4]), tstart=float(r1[5]),
            elems=[(bi, np.asarray(rs, np.int64))
                   for bi, rs in elems.items()]))

    return HeatModel(mesh, cfg, n_node, coords, dim, blocks, fixtemp_nodes,
                     fixtemp_vals, f, films, radiates,
                     zero_temp=mesh.zero_temp, weldlines=weldlines,
                     device=dev)


def _surface_integral_N(block, coords, sel, face, dim):
    """int N dS over a face for selected elements: (Esel, nsur), lnodes."""
    ftype, lnodes = FACE_TABLES[block.etype][face - 1]
    ft = get_table(ftype)
    fc = coords[block.conn[sel]][:, lnodes, :]
    out = np.zeros((len(sel), len(lnodes)))
    for q in range(ft.nq):
        g = np.einsum("end,nf->edf", fc, ft.dN[q])
        if dim == 3:
            area = np.linalg.norm(np.cross(g[:, :, 0], g[:, :, 1]), axis=1)
        else:
            area = np.linalg.norm(g[:, :, 0], axis=1) * block.thick
        out += ft.weights[q] * area[:, None] * ft.N[q][None, :]
    return out, lnodes


def weld_flux(model: HeatModel, t_mid: float) -> Optional[np.ndarray]:
    """Nodal rhs from active weld lines at evaluation time ``t_mid``.

    heat_mat_ass_bc_DFLUX.f90:112-180: total power I*U*coe is spread
    uniformly over the volume of the elements whose centroid along the
    torch axis lies within ``distol`` of position n1 + v*(t - tstart);
    active only inside [tstart, tstart + (n2-n1)/v].
    """
    if not model.weldlines:
        return None
    f = np.zeros(model.n_node)
    for wl in model.weldlines:
        tend = wl.tstart + (wl.n2 - wl.n1) / wl.v
        if t_mid < wl.tstart or t_mid > tend:
            continue
        wpos = wl.n1 + wl.v * (t_mid - wl.tstart)
        val = wl.current * wl.voltage * wl.coe
        fw = np.zeros(model.n_node)
        vol = 0.0
        for bi, sel in wl.elems:
            b = model.blocks[bi]
            cmean = model.coords[b.conn[sel], wl.xyz - 1].mean(axis=1)
            act = sel[np.abs(cmean - wpos) < wl.distol]
            if act.size == 0:
                continue
            t = get_table(b.etype)
            ce = model.coords[b.conn[act]]
            J = np.einsum("qni,enj->eqij", t.dN, ce)
            det = np.abs(np.linalg.det(J))
            scale = b.thick if model.dim == 2 else 1.0
            vect = np.einsum("qn,eq,q->en", t.N, det * scale,
                             t.weights) * val
            np.add.at(fw, b.conn[act].reshape(-1), vect.reshape(-1))
            vol += float(((det * scale) @ t.weights).sum())
        if vol > 0:
            f += fw / vol
    return f


def conduct_ke(table, coords_e: torch.Tensor, T_e: torch.Tensor,
               cond_table, thick: float, dim: int) -> torch.Tensor:
    """Batched conductance matrices (E, nn, nn) with kappa(T) at the
    gauss points."""
    dN = table_tensor(table, "dN", coords_e)
    det, gderiv = jacobians(dN, coords_e)
    N = table_tensor(table, "N", coords_e)
    w = table_tensor(table, "weights", coords_e)
    Tq = torch.einsum("qn,en->eq", N, T_e)
    kap = _interp(cond_table, Tq)                        # (E, nq)
    scale = thick if dim == 2 else 1.0
    wdet = (w * scale)[None, :] * det.abs() * kap
    # sum_q sum_j w g[n, j] g[m, j] as one batched product over (q, j)
    E, nq, nn, d = gderiv.shape
    g = gderiv.transpose(1, 2).reshape(E, nn, nq * d)
    gw = (gderiv * wdet[:, :, None, None]).transpose(1, 2).reshape(
        E, nn, nq * d)
    return torch.bmm(g, gw.transpose(1, 2))


def _quad_area(fc: torch.Tensor) -> torch.Tensor:
    """Area of the quad faces ``fc`` (E, 4, 3) by 2x2 Gauss
    (heat_get_area)."""
    qt = get_table(241)
    a = fc.new_zeros(fc.shape[0])
    for q in range(qt.nq):
        g = torch.einsum("end,nf->edf", fc,
                         torch.as_tensor(qt.dN[q], dtype=fc.dtype,
                                         device=fc.device))
        a = a + float(qt.weights[q]) * torch.linalg.vector_norm(
            torch.linalg.cross(g[:, :, 0], g[:, :, 1], dim=1), dim=1)
    return a


def interface_ke_541(coords_e: torch.Tensor, T_e: torch.Tensor, tzero,
                     thick, hh, rr1, rr2) -> torch.Tensor:
    """8-node gap interface conductance (heat_THERMAL_541,
    heat_LIB_THERMAL.f90:902-1007): nodes 1-4 / 5-8 are the paired quad
    faces; coupling = gap conductance hh/thick plus radiation linearized
    about the current absolute temperatures (T - tzero, tzero = !ZERO),
    with face areas SA/SB by 2x2 Gauss (heat_get_area)."""
    SA = _quad_area(coords_e[:, :4])
    SB = _quad_area(coords_e[:, 4:])
    tz = T_e - tzero
    r1 = rr1 ** 0.25
    r2 = rr2 ** 0.25
    ta, tb = tz[:, :4], tz[:, 4:]
    common = ((r1 * ta) ** 2 + (r2 * tb) ** 2) * (r1 * ta + r2 * tb)
    HA = common * r1
    HB = common * r2
    HHH = hh / thick
    K = coords_e.new_zeros((coords_e.shape[0], 8, 8))
    i = torch.arange(4, device=coords_e.device)
    K[:, i, i] = (HHH + HA) * SA[:, None] * 0.25
    K[:, i + 4, i + 4] = (HHH + HB) * SB[:, None] * 0.25
    off = -(HHH + 0.5 * (HA + HB)) * (0.5 * (SA + SB))[:, None] * 0.25
    K[:, i, i + 4] = off
    K[:, i + 4, i] = off
    return K


def lumped_capacity(table, coords_e: torch.Tensor, T_e: torch.Tensor,
                    rho_table, cp_table, thick, dim,
                    hrz=False) -> torch.Tensor:
    """Lumped capacity diag: int rho(T) c(T) N_i dV (heat_LIB_CAPACITY).

    hrz=True uses HRZ lumping — the consistent diagonal int N_i^2 scaled
    by total/diagonal mass, S0(J) = M_JJ*(2*TOTM-TOTD)/TOTD in
    heat_CAPACITY_342 etc. — which the reference applies to the
    SECOND-order etypes, whose row-sum corner integrals go negative
    (negative lumped capacity = unstable transient)."""
    dN = table_tensor(table, "dN", coords_e)
    det, _ = jacobians(dN, coords_e)
    N = table_tensor(table, "N", coords_e)
    w = table_tensor(table, "weights", coords_e)
    Tq = torch.einsum("qn,en->eq", N, T_e)
    rc = _interp(rho_table, Tq) * _interp(cp_table, Tq)
    scale = thick if dim == 2 else 1.0
    wdet = (w * scale)[None, :] * det.abs() * rc
    if hrz:
        diag = torch.einsum("qn,eq->en", N * N, wdet)
        tot = wdet.sum(dim=1)
        return diag * (tot / diag.sum(dim=1))[:, None]
    return torch.einsum("qn,eq->en", N, wdet)


def _surface_film_terms(ft, fc: torch.Tensor, T_f: torch.Tensor, coef,
                        sink, kind, tzero, thick, dim):
    """(Esel, nsur, nsur) surface matrix + (Esel, nsur) rhs for FILM/RADIATE."""
    E, nsur = fc.shape[:2]
    kmat = fc.new_zeros((E, nsur, nsur))
    fvec = fc.new_zeros((E, nsur))
    for q in range(ft.nq):
        N = torch.as_tensor(ft.N[q], dtype=fc.dtype, device=fc.device)
        dNq = torch.as_tensor(ft.dN[q], dtype=fc.dtype, device=fc.device)
        g = torch.einsum("end,nf->edf", fc, dNq)
        if dim == 3:
            area = torch.linalg.vector_norm(
                torch.linalg.cross(g[:, :, 0], g[:, :, 1], dim=1), dim=1)
        else:
            area = torch.linalg.vector_norm(g[:, :, 0], dim=1) * thick
        if kind == "film":
            cc = coef * torch.ones_like(area)
        else:
            Tq = torch.einsum("n,en->e", N, T_f)
            t1 = Tq - tzero
            t2 = sink - tzero
            cc = coef * (t1 + t2) * (t1 * t1 + t2 * t2)
        wa = float(ft.weights[q]) * area * cc
        kmat = kmat + wa[:, None, None] * (N[None, :, None] *
                                           N[None, None, :])
        fvec = fvec + wa[:, None] * N[None, :] * sink
    return kmat, fvec


def _node_gather(conns, n_node: int, device) -> torch.Tensor:
    """(n_node, maxinc, 1) incidence of ``conns`` for ``femop.gather_sum``
    at one dof a node."""
    inc, _ = femop.build_incidence(conns, n_node)
    return torch.as_tensor(inc, dtype=torch.int64, device=device)[:, :, None]


@dataclasses.dataclass
class HeatResult:
    T: np.ndarray
    steps: int
    iters: int                  # fixed-point iterations over all steps
    times: List[float]
    # one dict per step: "fp" fixed-point iterations, "cg" CG iterations
    # of each solve, "solve_s" seconds of each solve
    history: List[dict] = dataclasses.field(default_factory=list)
    timings: dict = dataclasses.field(default_factory=dict)   # seconds
    solver: object = None       # the _HeatSolver (its last system)


def _check_request(model: HeatModel) -> None:
    cfg = model.cfg
    if dist.current() is not None:
        if cfg.restart is not None:
            raise NotImplementedError("!RESTART under FRONTISTR_TPU_SHARDS")
        if cfg.solver.method.upper() in direct.METHODS:
            raise NotImplementedError("!SOLVER METHOD=DIRECT under "
                                      "FRONTISTR_TPU_SHARDS")
    if cfg.contacts:
        # the JAX package's heat analysis never reads the card
        raise NotImplementedError("!CONTACT in HEAT")


class _HeatSolver:
    """The heat solve on ``model.device``: the element routines at the
    current T, then CG on the constrained system
    A(x) = P (K + C/dt) P x + (I - P) x (P the free mask) with the
    Jacobi preconditioner, tol = RESID, maxiter = max(NIER, 2000)."""

    def __init__(self, model: HeatModel, timings: dict):
        self.model, self.timings = model, timings
        dev = self.dev = model.device
        n = model.n_node

        def tensor(a, dtype=F64):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        coords = tensor(model.coords)
        conns, self.vol = [], []
        for b in model.blocks:
            conn = tensor(b.conn, torch.int64)
            tabs = tuple(tensor(t) for t in (b.cond_table, b.rho_table,
                                             b.cp_table))
            self.vol.append((b, conn, coords[conn], tabs))
            conns.append(b.conn)
        self.surf = []
        for kind, entries in (("film", model.films),
                              ("rad", model.radiates)):
            for (bi, sel, face, coef, sink) in entries:
                b = model.blocks[bi]
                ftype, lnodes = FACE_TABLES[b.etype][face - 1]
                fconn = b.conn[sel][:, lnodes]
                fconn_t = tensor(fconn, torch.int64)
                self.surf.append((kind, get_table(ftype), coords[fconn_t],
                                  fconn_t, coef, sink, b.thick))
                conns.append(fconn)
        self.dofs = [c for _, c, _, _ in self.vol] + \
            [s[3] for s in self.surf]
        self.gather = _node_gather(conns, n, dev)
        self.surf_gather = _node_gather(conns[len(self.vol):], n, dev) \
            if self.surf else None
        cap = [b.conn for b in model.blocks if b.iface is None]
        self.cap_gather = _node_gather(cap, n, dev)
        free = np.ones(n)
        free[model.fixtemp_nodes] = 0.0
        self.free = tensor(free)
        u_fix = np.zeros(n)
        u_fix[model.fixtemp_nodes] = model.fixtemp_vals
        self.u_fix = tensor(u_fix)
        self.f_const = tensor(model.f_const)
        sv = model.cfg.solver
        self.tol, self.maxiter = sv.resid, max(sv.nier, 2000)
        self.mpc = extras.mpc_arrays(model.mesh, 1, n, dev)
        self.direct = (sv.method.upper() in direct.METHODS
                       and self.mpc is None)
        self.last = None           # the last solve's system and solution
        self.split = shardmod.current_split(n, 1)
        if self.split is not None:
            # a sharded run: the rank's elements of every block and face
            sp = self.split
            self.sel = [torch.as_tensor(shardmod._touch(c, sp.n0,
                                                        sp.n1_real)[0],
                                        device=dev) for c in conns]
            self.dofs_l = [d[s] for d, s in zip(self.dofs, self.sel)]
            self.gather_l = _node_gather(
                [c[s.cpu().numpy()] for c, s in zip(conns, self.sel)], n,
                dev)

    def capacity(self, T: torch.Tensor) -> torch.Tensor:
        """Lumped capacity per node at T (gap interfaces carry none)."""
        m = self.model
        rows = [lumped_capacity(get_table(b.etype), ce, T[conn], tabs[1],
                                tabs[2], b.thick, m.dim,
                                hrz=b.etype in HRZ_ETYPES)
                for b, conn, ce, tabs in self.vol if b.iface is None]
        return femop.gather_sum(rows, self.cap_gather)

    def step(self, T, dt_inv_C=None, T_prev=None, f_extra=None):
        """The temperatures solving the system assembled at ``T``;
        returns (T_new, CG iterations)."""
        m = self.model
        with Phase(self.timings, "elements", self.dev):
            kes = []
            for b, conn, ce, tabs in self.vol:
                if b.iface is not None:
                    th, hh, rr1, rr2 = b.iface
                    kes.append(interface_ke_541(ce, T[conn], m.zero_temp,
                                                th, hh, rr1, rr2))
                else:
                    kes.append(conduct_ke(get_table(b.etype), ce, T[conn],
                                          tabs[0], b.thick, m.dim))
            f = self.f_const
            if f_extra is not None:
                f = f + torch.as_tensor(f_extra, dtype=F64, device=self.dev)
            rows = []
            for (kind, ft, fc, fconn, coef, sink, thick) in self.surf:
                kmat, fvec = _surface_film_terms(
                    ft, fc, T[fconn], coef, sink, kind, m.zero_temp, thick,
                    m.dim)
                kes.append(kmat)
                rows.append(fvec)
            if rows:
                f = f + femop.gather_sum(rows, self.surf_gather)
            if dt_inv_C is not None:
                f = f + dt_inv_C * T_prev
            else:
                dt_inv_C = torch.zeros_like(T)
        with Phase(self.timings, "solve", self.dev):
            return self._solve(kes, f, dt_inv_C)

    def _solve(self, kes, f, dt_inv_C):
        free, u_fix = self.free, self.u_fix
        op = femop.FEOperator(kes=kes, dofs=self.dofs, gather=self.gather,
                              n_node=self.model.n_node, ndof=1,
                              free_mask=free)

        def A(x):
            xf = x * free
            y = op.matvec(xf) + dt_inv_C * xf
            return y * free + x * (1.0 - free)

        if self.direct:
            # METHOD=DIRECT: host SuperLU on K + diag(C/dt), refactored
            # every pass (heat_solve_main -> solve_LINEQ)
            import scipy.sparse as sp
            Kc = direct.assemble_csr(kes, self.dofs, self.model.n_node) + \
                sp.diags(direct.host(dt_inv_C))
            x = direct.factor_constrained(Kc, free)(f, u_fix)
            return torch.as_tensor(x, device=self.dev), 0
        y_fix = op.matvec(u_fix) + dt_inv_C * u_fix
        b_c = (f - y_fix) * free + u_fix * (1.0 - free)
        if self.split is not None:
            op = femop.FEOperator(
                kes=[k[s] for k, s in zip(kes, self.sel)], dofs=self.dofs_l,
                gather=self.gather_l, n_node=self.model.n_node, ndof=1,
                free_mask=free)
        D = (op.diag_blocks().reshape(-1) + dt_inv_C) * free ** 2
        D = torch.where(D == 0, 1.0, D)
        A_cg = A
        M = lambda r: r / D  # noqa: E731
        if self.split is not None:
            # rows sharded, x all-gathered, dots all-reduced
            x, res = shardmod.row_pcg(self.split, A, b_c, M, self.tol,
                                      self.maxiter, mpc=self.mpc, gfac=1.0)
            if self.mpc is not None:
                x = extras.mpc_recover(self.mpc, x, 1.0)
            self.last = dict(kes=kes, dofs=self.dofs, dt_inv_C=dt_inv_C,
                             b=b_c, x=x, free=free)
            return x, res.iters
        if self.mpc is not None:
            # T_dep = sum c T_m + const at every solve (factor 1)
            b_c = extras.mpc_reduce_rhs(self.mpc, A, b_c, 1.0)
            A_cg = extras.mpc_wrap(self.mpc, A)
            M = extras.mpc_precond(self.mpc, M)
        res = pcg(A_cg, b_c, M=M, tol=self.tol, maxiter=self.maxiter)
        x = res.x if self.mpc is None else \
            extras.mpc_recover(self.mpc, res.x, 1.0)
        self.last = dict(kes=kes, dofs=self.dofs, dt_inv_C=dt_inv_C,
                         b=b_c, x=x, free=free)
        return x, res.iters


def run_heat(mesh: Mesh, cfg: AnalysisConfig,
             log_path: Optional[str] = None, on_interval=None,
             device="cuda", timings: Optional[dict] = None,
             restart_path: Optional[str] = None,
             restart_freq: int = 0) -> HeatResult:
    """Steady or transient heat of ``mesh`` under the deck ``cfg`` on
    ``device`` (default the card; without one, an error).
    ``on_interval(step, t, T)`` (T the device tensor) fires after every
    committed step; the runner writes the per-interval result files with
    it (heat_solve_TRAN.f90:268-270).  ``timings`` gathers the seconds of
    the phases "model", "elements", "solve", "log", "restart_load" and
    "restart_save".
    ``restart_path`` (the !RESTART card, transient runs only): when the
    file exists the run resumes from its T, t and step count (backward
    Euler has no other history); with ``restart_freq`` > 0 it is written
    every ``restart_freq`` steps (heat_solve_TRAN.f90's restart
    block)."""
    timings = {} if timings is None else timings
    dev = resolve(device)
    with Phase(timings, "model", dev):
        model = build_heat_model(mesh, cfg, dev)
    _check_request(model)
    n = model.n_node
    h = cfg.heat or HeatConfig()
    T = torch.zeros(n, dtype=F64, device=dev)
    ic = model.mesh.initial_conditions.get("TEMPERATURE")
    if ic is not None:
        T[torch.as_tensor(ic[:, 0].astype(np.int64), device=dev)] = \
            torch.as_tensor(ic[:, 1], dtype=F64, device=dev)
    itmax = max(h.itmax, 1)
    eps = max(h.eps, 1e-12)
    solver = _HeatSolver(model, timings)
    history: List[dict] = []

    def fixed_point(T, dt_inv_C=None, f_extra=None):
        """The fixed-point loop on T-dependent properties: at least one
        solve, at most ITMAX, until ||T_new - T|| <= EPS."""
        T_prev = T
        rec = dict(fp=0, cg=[], solve_s=[])
        for _ in range(itmax):
            s0 = timings.get("solve", 0.0)
            T_new, cg = solver.step(T, dt_inv_C, T_prev, f_extra)
            rec["cg"].append(cg)
            rec["solve_s"].append(timings["solve"] - s0)
            chg = float(torch.linalg.vector_norm(T_new - T))
            T = T_new
            rec["fp"] += 1
            if chg <= eps:
                break
        history.append(rec)
        return T

    def extrema(T):
        """(max, argmax, min, argmin); the first index on ties, as
        ``np.argmax`` takes it."""
        v = torch.stack([T.max(), T.argmax().to(F64), T.min(),
                         T.argmin().to(F64)]).tolist()
        return v[0], int(v[1]), v[2], int(v[3])

    def log_step(step, t, ext):
        if log_path:
            with Phase(timings, "log", dev):
                _write_heat_log(log_path, model, ext, step, t,
                                append=step > 1)

    times: List[float] = []
    if not h.fixed_dt > 0.0:
        # steady: fixed point on temperature-dependent properties
        # (heat_solve_SS.f90 loop)
        T = fixed_point(T)
        steps, times = 1, [0.0]
        log_step(1, 0.0, extrema(T))
        if on_interval is not None:
            on_interval(1, 0.0, T)
    else:
        dt, t_total = h.fixed_dt, h.total_time
        t, steps = 0.0, 0
        if restart_path and os.path.exists(restart_path):
            with Phase(timings, "restart_load", dev):
                rd = load_restart(restart_path)
                T = torch.as_tensor(np.asarray(rd["T"]), dtype=F64,
                                    device=dev)
                t, steps = float(rd["t"]), int(rd["steps"])
            print(f"### heat restart: resuming at step {steps}, t={t:g}")
        while t < t_total - 1e-12:
            dt_cur = min(dt, t_total - t)
            f_weld = weld_flux(model, t + 0.5 * dt_cur)
            with Phase(timings, "elements", dev):
                dt_inv_C = solver.capacity(T) / dt_cur
            T = fixed_point(T, dt_inv_C, f_weld)
            t += dt_cur
            steps += 1
            times.append(t)
            if restart_path and restart_freq > 0 and \
                    steps % restart_freq == 0:
                with Phase(timings, "restart_save", dev):
                    save_restart(restart_path, {"T": T.cpu().numpy(),
                                                "t": t, "steps": steps})
            log_step(steps, t, extrema(T))
            if on_interval is not None:
                on_interval(steps, t, T)
    return HeatResult(T.cpu().numpy(), steps,
                      sum(r["fp"] for r in history), times, history,
                      timings, solver)


def _write_heat_log(path, model, ext, istep, time_, append=False):
    """One step's block of the heat 0.log; ``ext`` = (max, argmax, min,
    argmin) over the nodes."""
    tmax, imax, tmin, imin = ext
    ids = model.mesh.node_ids
    with open(path, "a" if append else "w") as f:
        if not append:
            f.write(" fstr_setup: OK\n \n")
        f.write(f" ISTEP ={istep:6d}\n")
        f.write(f" Time  ={time_:10.3f}\n")
        f.write(f" Maximum Temperature :{tmax:10.3f}\n")
        f.write(f" Maximum Node No.    :{int(ids[imax]):10d}\n")
        f.write(f" Minimum Temperature :{tmin:10.3f}\n")
        f.write(f" Minimum Node No.    :{int(ids[imin]):10d}\n")
