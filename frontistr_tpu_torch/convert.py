"""Carry a model and its Newton state built elsewhere into the port.

``model_from_numpy`` takes the numpy fields of a model of the JAX
package (``frontistr_tpu.assembly.model.StructModel``: coords, block
connectivity, dofs, elastic matrices, section type and thickness, the
block's kind (solid, shell, sshell, beam, beam341) with a beam's seven
section values and a 641 block's fiber radius and angles, the
material's constants (plastic, hyperelastic, Prony rows and TRS, creep,
the E(T) table, orthotropic, user), Dirichlet dofs and values, external
force) and builds the port's ``StructModel`` on a device, plus
the element matrices as device tensors when given.  ``states_from_numpy``
turns per-block Newton states (dicts of arrays: stress, strain, the
plastic state ``pstrain``/``pstrain_new``/``yielded``/``back`` and the
rest of ``init_block_state``) into the port's, and
``plastic_params_from_numpy`` a ``PlasticParams`` of the JAX package into
the port's, and ``heat_model_from_numpy`` a heat model
(``frontistr_tpu.analysis.heat.HeatModel``) into the port's.  They read
attributes and arrays only and import nothing of JAX, so the parity
tests can feed both packages identical inputs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from frontistr_tpu_torch.analysis import heat
from frontistr_tpu_torch.assembly.model import (KBlock, StructModel,
                                                beam_section, fiber_params)
from frontistr_tpu_torch.device import resolve
from frontistr_tpu_torch.fem import material as mat
from frontistr_tpu_torch.fem.plastic import PlasticParams


def model_from_numpy(src, device="cuda",
                     kes: Optional[Sequence[np.ndarray]] = None):
    """Port ``StructModel`` on ``device`` (default the card; without one,
    an error) from ``src``'s numpy fields.  The mesh is carried as it is,
    ``mesh.structured`` included.

    Returns the model, or ``(model, kes)`` with the element matrices as
    float64 tensors on ``device`` when ``kes`` is given."""
    dev = resolve(device)
    blocks = []
    for b in src.blocks:
        sm = b.material
        beam = b.kind in ("beam", "beam341")

        def arr(name):
            v = getattr(sm, name, None)
            return None if v is None else np.asarray(v, np.float64)
        m = mat.Material(sm.name, mtype=sm.mtype, youngs=sm.youngs,
                         poisson=sm.poisson, density=sm.density,
                         expansion=sm.expansion, nlgeom=int(sm.nlgeom),
                         yield_func=sm.yield_func, hardening=sm.hardening,
                         plastic_consts=arr("plastic_consts"),
                         hyper_consts=arr("hyper_consts"),
                         visco_consts=arr("visco_consts"),
                         trs_consts=arr("trs_consts"),
                         trs_def=getattr(sm, "trs_def", "WLF"),
                         creep_consts=arr("creep_consts"),
                         elastic_table=arr("elastic_table"),
                         ortho_consts=arr("ortho_consts"),
                         user_consts=arr("user_consts"),
                         user_nstatus=int(getattr(sm, "user_nstatus", 0)))
        blocks.append(KBlock(
            int(b.etype), np.asarray(b.elem_ids),
            np.asarray(b.conn, np.int32), np.asarray(b.dofs, np.int32),
            np.asarray(b.D, np.float64), float(b.thick), int(b.iset),
            np.asarray(b.density, np.float64), m, int(b.sect_id),
            formulation=b.formulation, kind=b.kind,
            section=beam_section(src.mesh, b.sect_id) if beam else None,
            fiber=fiber_params(src.mesh, b.sect_id)
            if b.kind == "beam341" else (0.0, None)))
    model = StructModel(
        mesh=src.mesh, cfg=src.cfg, ndof=int(src.ndof), dim=int(src.dim),
        n_node=int(src.n_node),
        coords=np.asarray(src.coords, np.float64), blocks=blocks,
        fixed_dofs=np.asarray(src.fixed_dofs, np.int64),
        fixed_vals=np.asarray(src.fixed_vals, np.float64),
        f_ext=np.asarray(src.f_ext, np.float64), device=dev,
        nlgeom=bool(src.nlgeom), reftemp=float(src.reftemp),
        temperature=None if src.temperature is None
        else np.asarray(src.temperature, np.float64),
        f_base=None if src.f_base is None
        else np.asarray(src.f_base, np.float64),
        dload_grp=src.dload_grp,
        extras=tuple([np.asarray(a) for a in field]
                     for field in getattr(src, "extras", ([],) * 4)[:3])
        + (list(getattr(src, "extras", ([],) * 4)[3]),),
        rot_bcs=list(getattr(src, "rot_bcs", [])))
    if kes is None:
        return model
    return model, [torch.tensor(np.asarray(k, np.float64), device=dev)
                   for k in kes]


def states_from_numpy(states, device="cuda"):
    """Per-block Newton states on ``device``: each array of each dict as
    a tensor, float64 (bool arrays stay bool)."""
    dev = resolve(device)
    out = []
    for st in states:
        d = {}
        for k, v in st.items():
            a = np.array(v)
            d[k] = torch.as_tensor(a if a.dtype == np.bool_ else
                                   a.astype(np.float64), device=dev)
        out.append(d)
    return out


def plastic_params_from_numpy(src) -> PlasticParams:
    """The port's ``PlasticParams`` from one with the same fields (the
    JAX package's ``fem.plastic.PlasticParams``)."""
    return PlasticParams(
        float(src.youngs), float(src.poisson), str(src.hardening),
        np.asarray(src.consts, np.float64),
        table=None if src.table is None
        else np.asarray(src.table, np.float64),
        yield_func=str(src.yield_func))


def heat_model_from_numpy(src, device="cuda") -> heat.HeatModel:
    """Port ``HeatModel`` solved on ``device`` from ``src``'s fields: the
    coordinates, the blocks (connectivity, material tables, interface
    section), the FIXTEMP set, the constant flux, the film and radiation
    entries and the weld lines.  The mesh and deck are carried as they
    are."""
    blocks = [heat.HeatBlock(
        int(b.etype), np.asarray(b.elem_ids), np.asarray(b.conn),
        float(b.thick), np.asarray(b.cond_table, np.float64),
        np.asarray(b.rho_table, np.float64),
        np.asarray(b.cp_table, np.float64),
        None if b.iface is None else tuple(float(v) for v in b.iface))
        for b in src.blocks]

    def entries(rows):
        return [(int(bi), np.asarray(sel, np.int64), int(face), float(c),
                 float(sink)) for bi, sel, face, c, sink in rows]

    welds = [heat.WeldLine(
        float(w.current), float(w.voltage), float(w.coe), float(w.v),
        int(w.xyz), float(w.n1), float(w.n2), float(w.distol),
        float(w.tstart),
        [(int(bi), np.asarray(sel, np.int64)) for bi, sel in w.elems])
        for w in src.weldlines]
    return heat.HeatModel(
        src.mesh, src.cfg, int(src.n_node),
        np.asarray(src.coords, np.float64), int(src.dim), blocks,
        np.asarray(src.fixtemp_nodes, np.int64),
        np.asarray(src.fixtemp_vals, np.float64),
        np.asarray(src.f_const, np.float64), entries(src.films),
        entries(src.radiates), zero_temp=float(src.zero_temp),
        weldlines=welds, device=resolve(device))
