"""External loads of the solid slice: !DLOAD and !TEMPERATURE (torch
port of ``frontistr_tpu/assembly/loads.py``; reference fstr_ass_load +
DL_C3, fistr1/src/analysis/static/fstr_ass_load.f90:18-439,
fistr1/src/lib/static_LIB_3d.f90).

- The host part is numpy, as in the JAX package: body forces BX/BY/BZ,
  GRAV, CENT, face pressures P1..P6 and surface-group pressures (S/P0)
  through ``collect_dload`` (a shell block's through ``shell_dload``); nodal temperatures (``collect_temperature``),
  gauss thermal strains and the thermal load ``int B^T D eps_th``.  They
  run once per step.
- ``FollowerDload`` is the follower load of the Newton driver: the same
  DLOAD cards re-assembled at ``coords0 + u`` every Newton iteration
  (DLOAD_follow=1 under nlgeom, fstr_ass_load.f90:165-196), on the
  device, from static per-(block, face, card) tables.

Face numbering tables from getSubFace
(fistr1/src/lib/element/element.f90:188-360), converted to 0-based.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from frontistr_tpu_torch.assembly import segsum as segmod
from frontistr_tpu_torch.elements.tables import get_table
from frontistr_tpu_torch.fem.isoparam import (det_inv_small,
                                              strain_selector_2d,
                                              strain_selector_3d)
from frontistr_tpu_torch.fem.shell import shell_dload
from frontistr_tpu_torch.fem.solid import table_tensor

# etype -> list of (face_etype, [0-based local node ids]) indexed by face-1
FACE_TABLES: Dict[int, List] = {
    341: [(231, [0, 1, 2]), (231, [3, 1, 0]), (231, [3, 2, 1]),
          (231, [3, 0, 2])],
    342: [(232, [0, 1, 2, 4, 5, 6]), (232, [3, 1, 0, 8, 4, 7]),
          (232, [3, 2, 1, 9, 5, 8]), (232, [3, 0, 2, 7, 6, 9])],
    361: [(241, [0, 1, 2, 3]), (241, [7, 6, 5, 4]), (241, [4, 5, 1, 0]),
          (241, [5, 6, 2, 1]), (241, [6, 7, 3, 2]), (241, [7, 4, 0, 3])],
    # the faces of the heat slice's other element types
    362: [(242, [0, 1, 2, 3, 8, 9, 10, 11]),
          (242, [7, 6, 5, 4, 14, 13, 12, 15]),
          (242, [4, 5, 1, 0, 12, 17, 8, 16]),
          (242, [5, 6, 2, 1, 13, 18, 9, 17]),
          (242, [6, 7, 3, 2, 14, 19, 10, 18]),
          (242, [7, 4, 0, 3, 15, 16, 11, 19])],
    351: [(231, [0, 1, 2]), (231, [5, 4, 3]), (241, [3, 4, 1, 0]),
          (241, [4, 5, 2, 1]), (241, [5, 3, 0, 2])],
    352: [(232, [0, 1, 2, 6, 7, 8]), (232, [5, 4, 3, 10, 9, 11]),
          (242, [3, 4, 1, 0, 9, 13, 6, 12]),
          (242, [4, 5, 2, 1, 10, 14, 7, 13]),
          (242, [5, 3, 0, 2, 11, 12, 8, 14])],
    # 2D edges (faces of plane elements; face elements are line2/line3)
    231: [(111, [0, 1]), (111, [1, 2]), (111, [2, 0])],
    232: [(112, [0, 1, 3]), (112, [1, 2, 4]), (112, [2, 0, 5])],
    241: [(111, [0, 1]), (111, [1, 2]), (111, [2, 3]), (111, [3, 0])],
    242: [(112, [0, 1, 4]), (112, [1, 2, 5]), (112, [2, 3, 6]),
          (112, [3, 0, 7])],
}

_LTYPE = {"BX": 1, "BY": 2, "BZ": 3, "GRAV": 4, "CENT": 5,
          "P1": 10, "P2": 20, "P3": 30, "P4": 40, "P5": 50, "P6": 60,
          "P0": 100, "S": 100}


def _volume_shape_integrals(etype: int, coords_e: np.ndarray, dim: int,
                            thick: float):
    """The element table and det J per gauss point, (E, nq)."""
    t = get_table(etype)
    J = np.einsum("qni,enj->eqij", t.dN, coords_e)
    det = np.linalg.det(J)
    scale = thick if dim == 2 else 1.0
    return t, det * scale


def _body_force(etype, coords_e, dim, thick, ltype, params, rho):
    """DL_C3 volume-load arm.  Returns (E, nn, dim) force vectors."""
    t, wdet = _volume_shape_integrals(etype, coords_e, dim, thick)
    E, nn, _ = coords_e.shape
    val = params[0]
    if ltype in (1, 2, 3):
        pl = np.einsum("qn,eq,q->en", t.N, wdet, t.weights)
        out = np.zeros((E, nn, dim))
        out[:, :, ltype - 1] = val * pl
        return out
    if ltype == 4:  # GRAV
        v = np.asarray(params[1:1 + dim])
        v = v / np.linalg.norm(v)
        pl = np.einsum("qn,eq,q->en", t.N, wdet, t.weights)
        return val * rho * pl[:, :, None] * v[None, None, :]
    if ltype == 5:  # CENT: omega=val, axis point A=params[1:4], dir R=params[4:7]
        A = np.asarray(params[1:1 + 3])[:dim]
        R = np.asarray(params[4:4 + 3])[:dim]
        xq = np.einsum("qn,end->eqd", t.N, coords_e)       # qp coords
        proj = (np.einsum("eqd,d->eq", xq - A, R) /
                np.dot(R, R))[:, :, None] * R[None, None, :]
        ph = xq - (A + proj)                               # radial arm
        coef = rho * val * val * ph                        # (E, nq, dim)
        return np.einsum("qn,eq,q,eqd->end", t.N, wdet, t.weights, coef)
    raise ValueError(f"ltype {ltype}")


def _face_pressure(etype, coords_e, dim, thick, face_no, val):
    """DL_C3 surface-load arm (normal pressure).  (E, nn, dim)."""
    ftype, lnodes = FACE_TABLES[etype][face_no - 1]
    ft = get_table(ftype)
    fc = coords_e[:, lnodes, :]                            # (E, nsur, dim)
    E = coords_e.shape[0]
    out = np.zeros((E,) + coords_e.shape[1:])
    for q in range(ft.nq):
        N = ft.N[q]
        dN = ft.dN[q]                                      # (nsur, fdim)
        g = np.einsum("end,nf->edf", fc, dN)               # (E, dim, fdim)
        if dim == 3:
            normal = np.cross(g[:, :, 0], g[:, :, 1])      # area-weighted
        else:                     # an edge of a 2-D block, its thickness
            normal = np.stack([-g[:, 1, 0], g[:, 0, 0]], axis=1) * thick
        w = ft.weights[q] * val
        out[:, lnodes, :] += w * N[None, :, None] * normal[:, None, :]
    return out


def collect_temperature(mesh, cards, n_node: int, default: float,
                        grpid_filter=None):
    """!TEMPERATURE cards -> nodal temperature field (per node-group
    constant values, default the reference temperature); None when no
    card names a node of the mesh."""
    T = np.full(n_node, default)
    found = False
    for c in cards:
        gid = c.iparam("GRPID", 1)
        if grpid_filter is not None and gid not in grpid_filter:
            continue
        for row in c.data:
            grp = row[0]
            val = float(row[1]) if len(row) > 1 else 0.0
            if grp in mesh.node_groups:
                T[mesh.node_groups[grp]] = val
                found = True
            else:
                try:
                    nid = int(grp)
                    if nid in mesh.id2idx:
                        T[mesh.id2idx[nid]] = val
                        found = True
                except ValueError:
                    pass
    return T if found else None


def thermal_strains(model, block, temperature: np.ndarray):
    """Thermal strain at the gauss points: eps_th = alpha (T - ref) on the
    normal components (UPDATE_C3 EPSTH, static_LIB_3d.f90).
    Returns (E, nq, 6)."""
    t = get_table(block.etype)
    T_e = temperature[block.conn]                         # (E, nn)
    tq = np.einsum("qn,en->eq", t.N, T_e)                 # (E, nq)
    alpha = float(block.material.expansion)
    ns = block.D.shape[-1]
    eps = np.zeros(T_e.shape[:1] + (t.nq, ns))
    dT = alpha * (tq - model.reftemp)
    for k in range(3 if model.dim == 3 else 2):     # 2-D: UPDATE_C2 EPSTH
        eps[:, :, k] = dT
    return eps


def thermal_load(model, temperature: np.ndarray) -> np.ndarray:
    """TLOAD: f = int B^T D eps_th dV (TLOAD_C3)."""
    ndof = model.ndof
    f = np.zeros(model.n_node * ndof)
    S = strain_selector_3d() if model.dim == 3 else strain_selector_2d()
    for b in model.blocks:
        t = get_table(b.etype)
        coords_e = model.coords[b.conn]
        J = np.einsum("qni,enj->eqij", t.dN, coords_e)
        det = np.linalg.det(J)
        Jinv = np.linalg.inv(J)
        g = np.einsum("qni,eqji->eqnj", t.dN, Jinv)
        scale = b.thick if model.dim == 2 else 1.0
        wdet = (t.weights * scale)[None, :] * det
        epsth = thermal_strains(model, b, temperature)
        if b.D.ndim == 4:
            sig = np.einsum("eqkl,eql->eqk", b.D, epsth)
        else:
            sig = np.einsum("ekl,eql->eqk", b.D, epsth)
        vect = np.einsum("kdj,eqnj,eqk,eq->end", S, g, sig, wdet)
        dofs = (b.conn[:, :, None] * ndof + np.arange(ndof)[None, None, :])
        np.add.at(f, dofs.reshape(-1), vect.reshape(-1))
    return f


def collect_dload(mesh, model, cards, grpid_filter=None,
                  coords=None) -> np.ndarray:
    """Assemble !DLOAD cards into a global load vector.

    ``coords`` overrides the node positions (the follower load's
    deformed geometry)."""
    ndof = model.ndof
    if coords is None:
        coords = model.coords
    f = np.zeros(model.n_node * ndof)
    for (bi, sel, face, ltype, params, token) in _dload_groups(
            mesh, model, cards, grpid_filter):
        b = model.blocks[bi]
        coords_e = coords[b.conn[sel]]
        rho = float(b.material.density)
        if b.kind == "shell":
            # shell_dload: the body-force tokens, any pressure as P0
            vect = shell_dload(
                torch.as_tensor(np.asarray(coords_e, np.float64)), b.thick,
                rho, token if token in ("BX", "BY", "BZ", "GRAV", "CENT")
                else "P0", np.asarray(params), b.etype).numpy()
        elif b.kind != "solid":
            # the JAX package reads a solid's tables for them and fails
            raise NotImplementedError(f"!DLOAD on {b.kind} blocks "
                                      f"({b.etype})")
        elif ltype < 10:
            vect = _body_force(b.etype, coords_e, model.dim, b.thick,
                               ltype, params, rho)
        elif ltype >= 100:
            continue            # S/P0 on solids needs a surface group
        else:
            vect = _face_pressure(b.etype, coords_e, model.dim, b.thick,
                                  face, params[0])
        dofs = (b.conn[sel][:, :, None] * ndof +
                np.arange(ndof)[None, None, :])
        np.add.at(f, dofs.reshape(-1), vect.reshape(-1))
    return f


def _dload_groups(mesh, model, cards, grpid_filter=None):
    """Static card grouping shared by collect_dload and FollowerDload:
    yields (bi, rows, face, ltype, params, token)."""
    eid2loc = {}
    for bi, b in enumerate(model.blocks):
        for k, eid in enumerate(b.elem_ids):
            eid2loc[int(eid)] = (bi, k)

    def group(eids, faces, ltype, params, token):
        by_block: Dict[tuple, List] = {}
        for idx, eid in enumerate(eids):
            loc = eid2loc.get(int(eid))
            if loc is None:
                continue
            face = int(faces[idx]) if faces is not None else ltype // 10
            by_block.setdefault((loc[0], face), []).append(loc[1])
        for (bi, face), rows in by_block.items():
            yield (bi, np.asarray(rows, np.int64), face, ltype, params,
                   token)

    for c in cards:
        gid = c.iparam("GRPID", 1)
        if grpid_filter is not None and gid not in grpid_filter:
            continue
        for row in c.data:
            grp = row[0]
            lt_tok = row[1].upper()
            ltype = _LTYPE.get(lt_tok)
            if ltype is None:
                continue
            params = [float(v) for v in row[2:]] + [0.0] * 7
            params = np.asarray(params[:7])
            if ltype == 100:
                sg = mesh.surf_groups.get(grp)
                if sg is not None:
                    for face in np.unique(sg[:, 1]):
                        sel = sg[sg[:, 1] == face]
                        yield from group(sel[:, 0], None, int(face) * 10,
                                         params, lt_tok)
                    continue
            eids = mesh.elem_groups.get(grp)
            if eids is None:
                try:
                    eids = np.asarray([int(grp)])
                except ValueError:
                    continue
            yield from group(eids, None, ltype, params, lt_tok)


class FollowerDload(torch.nn.Module):
    """The DLOAD cards ``cards`` (load groups ``grpid_filter``) as a
    function of the displacement: ``f(u)``, assembled at ``coords0 + u``
    on the model's device.

    Everything static is put on the device at construction: pressure
    entries of one face type are concatenated into one table of face
    nodes and one of pressures, beside the face type's shape tables, and
    each body-force entry (BX/BY/BZ, GRAV, CENT) keeps its element type's
    tables.  A call is then one gather of the deformed face coordinates
    and one batched face integral (over gauss points and face nodes) per
    face type, one gather and integral per body-force entry, and one sum
    of every entry's nodal forces per node in a fixed order
    (``segsum.IndexAdd``, K1's planes entry on the card), so that a
    relaunch, and a run resumed from a checkpoint, repeats the load bit
    for bit (``index_add_``'s atomics on the card do not).  S/P0 rows without a
    surface group contribute nothing, as in ``collect_dload``.  The
    load's tangent is not added to the stiffness, as in the JAX
    package."""

    def __init__(self, model, cards, grpid_filter=None):
        super().__init__()
        dev = model.device
        self.n_node, self.ndof, self.dim = model.n_node, model.ndof, \
            model.dim
        faces: Dict[int, list] = {}
        self.body = []
        body_nodes = []
        for (bi, rows, face, ltype, params, _) in _dload_groups(
                model.mesh, model, cards, grpid_filter):
            b = model.blocks[bi]
            if b.kind != "solid":
                # as collect_dload: a DLOAD lands on solid blocks only
                raise NotImplementedError(f"!DLOAD on {b.kind} blocks "
                                          f"({b.etype})")
            conn = b.conn[rows]
            if ltype >= 100:
                continue
            if ltype < 10:
                body_nodes.append(conn.reshape(-1))
                self.body.append((_shape_tensors(b.etype, dev),
                                  torch.as_tensor(conn, dtype=torch.int64,
                                                  device=dev),
                                  ltype, params, float(b.material.density),
                                  b.thick if model.dim == 2 else 1.0))
                continue
            ftype, lnodes = FACE_TABLES[b.etype][face - 1]
            # an edge of a 2-D block carries its section's thickness
            faces.setdefault(ftype, []).append(
                (conn[:, lnodes], np.full(len(rows), float(params[0]) * (
                    b.thick if model.dim == 2 else 1.0))))
        self.faces = []
        for ftype, ents in faces.items():
            self.faces.append((_shape_tensors(ftype, dev), torch.as_tensor(
                np.concatenate([c for c, _ in ents]), dtype=torch.int64,
                device=dev), torch.as_tensor(
                np.concatenate([v for _, v in ents]), dtype=torch.float64,
                device=dev)))
        self.register_buffer("coords0", torch.as_tensor(
            np.asarray(model.coords, np.float64), device=dev))
        # the nodes of every entry in the order ``forward`` lists them
        nodes = [np.concatenate([c for c, _ in ents]).reshape(-1)
                 for ents in faces.values()] + body_nodes
        self.add = None
        if nodes:
            idx = (np.concatenate(nodes).astype(np.int64)[:, None]
                   * self.ndof + np.arange(self.dim)).reshape(-1)
            self.add = segmod.IndexAdd.build(idx, dev)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        dim = self.dim
        xd = self.coords0 + u.reshape(self.n_node, self.ndof)[:, :dim]
        vals = []
        for (dN, N, w), fnodes, pv in self.faces:
            fc = xd[fnodes]                              # (Ef, nsur, dim)
            g = torch.einsum("end,qnf->eqdf", fc, dN)    # (Ef, nq, dim, fd)
            if dim == 3:
                normal = torch.linalg.cross(g[..., 0], g[..., 1], dim=-1)
            else:                               # the edge's outer normal
                normal = torch.stack([-g[..., 1, 0], g[..., 0, 0]], -1)
            out = torch.einsum("q,e,qn,eqd->end", w, pv, N, normal)
            vals.append(out.reshape(-1))
        for tabs, conn, ltype, params, rho, scale in self.body:
            vals.append(_body_force_t(tabs, xd[conn], ltype, params,
                                      rho, scale).reshape(-1))
        f = u.new_zeros(self.n_node * self.ndof)
        if self.add is None:
            return f
        return self.add(f, torch.cat(vals))


def _shape_tensors(etype, device):
    """(dN (nq, nn, d), N (nq, nn), weights (nq)) of ``etype``, float64 on
    ``device``."""
    like = torch.empty(0, dtype=torch.float64, device=device)
    return tuple(table_tensor(get_table(etype), name, like)
                 for name in ("dN", "N", "weights"))


def _body_force_t(tabs, coords_e, ltype, params, rho, scale=1.0):
    """Torch twin of ``_body_force``, with the element type's
    ``_shape_tensors`` and ``scale`` the thickness of a 2-D block:
    (E, nn, dim)."""
    dN, N, w = tabs
    dt, dev = coords_e.dtype, coords_e.device
    dim = coords_e.shape[-1]
    J = torch.einsum("qni,enj->eqij", dN, coords_e)
    wdet = det_inv_small(J)[0] * scale
    val = float(params[0])
    if ltype in (1, 2, 3):
        pl = torch.einsum("qn,eq,q->en", N, wdet, w)
        out = coords_e.new_zeros(coords_e.shape)
        out[:, :, ltype - 1] = val * pl
        return out
    if ltype == 4:                                   # GRAV
        v = np.asarray(params[1:1 + dim])
        v = torch.as_tensor(v / np.linalg.norm(v), dtype=dt, device=dev)
        pl = torch.einsum("qn,eq,q->en", N, wdet, w)
        return val * rho * pl[:, :, None] * v[None, None, :]
    if ltype == 5:                                   # CENT
        A = torch.as_tensor(np.asarray(params[1:4])[:dim], dtype=dt,
                            device=dev)
        R = np.asarray(params[4:7])[:dim]
        Rt = torch.as_tensor(R, dtype=dt, device=dev)
        xq = torch.einsum("qn,end->eqd", N, coords_e)
        proj = (torch.einsum("eqd,d->eq", xq - A, Rt) /
                float(np.dot(R, R)))[:, :, None] * Rt[None, None, :]
        coef = rho * val * val * (xq - (A + proj))
        return torch.einsum("qn,eq,q,eqd->end", N, wdet, w, coef)
    raise ValueError(f"ltype {ltype}")
