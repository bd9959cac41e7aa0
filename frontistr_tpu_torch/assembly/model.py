"""Host-side model builder: mesh + control deck -> element blocks, BCs and
loads (torch port of ``frontistr_tpu/assembly/model.py``, the slice the
solid analyses need: the 2-D solids tri3/tri6/quad4/quad8 (plane stress,
plane strain or axisymmetric by the section's sect_opt, with its
thickness) and the 3-D solids tet4/tet10, prism6/prism15 and hex8/hex20,
of an ELASTIC (isotropic, temperature-dependent, or orthotropic in a
section's !ORIENTATION frame), !PLASTIC, !HYPERELASTIC, !VISCOELASTIC
(with !TRS), !CREEP or !USER_MATERIAL material; CLOAD (with a torque about
ROT_CENTER), DLOAD and TEMPERATURE loads, the temperatures given by node
group or read from a heat run's result, ``!TEMPERATURE, READRESULT``;
rotational !BOUNDARY rows about ROT_CENTER; !SPRING blocks in
``model.extras``, ``assembly/extras.py``; the mesh's !EQUATION cards are
eliminated by each analysis; a registered uload adds its force); and
the shells 731/741/743 and 611 beams as a 6-dof model, the solid-shells
761/781 and 641 beams as 3-dof blocks, linear elastic, as the JAX
package builds them.

The model itself stays host numpy, as in the JAX package: the symbolic
profiles are built from it on the host, and ``analysis/static.py`` moves
what the device needs onto ``model.device``.  Cards the port does not
run yet raise ``NotImplementedError`` naming the card, so a deck never
runs with part of it silently dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from frontistr_tpu_torch import user
from frontistr_tpu_torch.assembly import extras, loads
from frontistr_tpu_torch.device import resolve
from frontistr_tpu_torch.elements.tables import get_table
from frontistr_tpu_torch.fem import material as mat
from frontistr_tpu_torch.fem.beam import DEFAULT_SECTION
from frontistr_tpu_torch.io.ctrlio import AnalysisConfig, Card, CntMaterial
from frontistr_tpu_torch.io.meshio import Mesh


@dataclasses.dataclass
class KBlock:
    """One element-type block ready for batched kernels."""
    etype: int
    elem_ids: np.ndarray        # (E,)
    conn: np.ndarray            # (E, nn) node idx (FSTR ordering)
    dofs: np.ndarray            # (E, nn*ndof) global dof idx
    D: np.ndarray               # (E, ns, ns) elastic matrices
    thick: float
    iset: int                   # sect type for 2D (PLANE_STRESS/...)
    density: np.ndarray         # (E,)
    material: mat.Material      # block-uniform material record
    sect_id: int = 0
    formulation: str = "FI"
    kind: str = "solid"         # solid, shell, sshell, beam or beam341
    # a beam block's seven !SECTION values (reference vector, area, Iyy,
    # Izz, Jx) and a 641 block's fiber radius and six angles (degrees)
    section: Optional[tuple] = None
    fiber: tuple = (0.0, None)


@dataclasses.dataclass
class StructModel:
    mesh: Mesh
    cfg: AnalysisConfig
    ndof: int
    dim: int
    n_node: int
    coords: np.ndarray          # (n_node, dim)
    blocks: List[KBlock]
    fixed_dofs: np.ndarray      # (nfix,) int
    fixed_vals: np.ndarray      # (nfix,)
    f_ext: np.ndarray           # (n_node*ndof,)
    device: torch.device = torch.device("cpu")
    nlgeom: bool = False
    temperature: Optional[np.ndarray] = None   # (n_node,) nodal temperature
    # follower loads: the load vector without DLOAD, and the DLOAD cards
    # with the first step's load groups to re-assemble it at u
    f_base: Optional[np.ndarray] = None
    dload_grp: Optional[tuple] = None          # (cards, lgrp)
    reftemp: float = 0.0
    # spring blocks: (conns, dofs, kes, nns) from assembly.extras
    extras: tuple = ([], [], [], [])
    # rotational BOUNDARY entries (ROT_CENTER): applied via rot_bc_disp
    rot_bcs: list = dataclasses.field(default_factory=list)

    @property
    def n_dof_total(self) -> int:
        return self.n_node * self.ndof


def _resolve_material(mesh: Mesh, cnt_mats: Dict[str, CntMaterial],
                      name: str) -> mat.Material:
    """Merge mesh !MATERIAL items with .cnt !MATERIAL subcards; the .cnt
    definition wins (fstr_setup.f90 pass 2).  The isotropic elastic and
    !PLASTIC subcards belong to this slice; any other raises."""
    m = mat.Material(name)
    md = mesh.materials.get(name)
    if md is not None:
        it1 = md.items.get(1)
        if it1:
            row = it1[0]
            m.youngs = row[0]
            if len(row) > 1:
                m.poisson = row[1]
        it2 = md.items.get(2)
        if it2:
            m.density = it2[0][0]
        it3 = md.items.get(3)
        if it3:
            m.expansion = it3[0][0]
    cm = cnt_mats.get(name)
    if cm is None and "" in cnt_mats:
        # header-less material cards bind to the mesh-defined material
        cm = cnt_mats[""]
    if cm is None:
        return m
    if cm.fluid is not None:
        raise NotImplementedError("!FLUID material card")

    def _flag(card, default):
        # strain measure under nlgeom (fstr_ctrl_material.f90): INFINITE,
        # CAUCHY (updated Lagrange), KIRCHHOFF (total Lagrange)
        return (mat.INFINITESIMAL if card.has("INFINITE") else
                mat.UPDATELAG if card.has("CAUCHY") else
                mat.TOTALLAG if card.has("KIRCHHOFF") else default)
    if cm.elastic is not None:
        rows = cm.elastic.rows_f()
        if (cm.elastic.param("TYPE") or "").upper().startswith("ORTHO"):
            c9 = [v for row in rows for v in row][:9]
            m.ortho_consts = np.asarray(c9)
            m.youngs, m.poisson = c9[0], c9[3]
        else:
            # rows of (E, nu, temperature): temperature-dependent when
            # more than one (elastic_at_T)
            m.elastic_table = np.asarray(rows)
            m.youngs, m.poisson = rows[0][0], rows[0][1]
        m.nlgeom = _flag(cm.elastic, mat.TOTALLAG)
    if cm.density is not None:
        m.density = cm.density.rows_f()[0][0]
    if cm.expansion is not None:
        m.expansion = cm.expansion.rows_f()[0][0]
    if cm.hyperelastic is not None:
        m.mtype = (cm.hyperelastic.param("TYPE") or "MOONEY-RIVLIN").upper()
        m.hyper_consts = np.asarray(cm.hyperelastic.rows_f()[0])
        m.nlgeom = _flag(cm.hyperelastic, mat.TOTALLAG)
    if cm.plastic is not None:
        c = cm.plastic
        m.mtype = mat.EPLASTIC
        m.yield_func = (c.param("YIELD") or "MISES").upper()
        m.hardening = (c.param("HARDEN") or "LINEAR").upper()
        m.plastic_consts = np.asarray(
            [v for row in c.rows_f() for v in row]).reshape(
                len(c.data), -1) if c.data else None
        # a plastic block's strain measure defaults to updated Lagrange
        m.nlgeom = _flag(c, mat.UPDATELAG)
    if cm.viscoelastic is not None:
        m.mtype = mat.VISCOELASTIC
        m.visco_consts = np.asarray(cm.viscoelastic.rows_f())
        m.nlgeom = _flag(cm.viscoelastic, mat.TOTALLAG)
    if cm.trs is not None:
        m.trs_consts = np.asarray(cm.trs.rows_f())
        m.trs_def = (cm.trs.param("DEFINITION") or "WLF").upper()
    if cm.creep is not None:
        m.mtype = mat.CREEP
        m.creep_consts = np.asarray(cm.creep.rows_f()[0])
        m.nlgeom = _flag(cm.creep, mat.UPDATELAG)
    if cm.user_material is not None:
        # '!USER_MATERIAL, NSTATUS=n' and rows of constants
        # (fstr_ctrl_material.f90:31-51); the update comes from the
        # frontistr_tpu_torch.user registry
        m.mtype = mat.USERMATERIAL
        m.user_nstatus = cm.user_material.iparam("NSTATUS", 1)
        rows = cm.user_material.rows_f()
        m.user_consts = np.asarray([v for row in rows for v in row]) \
            if rows else np.zeros(0)
        m.nlgeom = _flag(cm.user_material, mat.INFINITESIMAL)
    return m


def _resolve_node_group(mesh: Mesh, token: str) -> np.ndarray:
    """BC target: node group name or a literal node id."""
    if token in mesh.node_groups:
        return mesh.node_groups[token]
    try:
        nid = int(token)
    except ValueError:
        return np.zeros(0, np.int64)
    if nid in mesh.id2idx:
        return np.asarray([mesh.id2idx[nid]], dtype=np.int64)
    return np.zeros(0, np.int64)


def collect_boundary(mesh: Mesh, cards: List[Card], ndof: int,
                     grpid_filter=None):
    """!BOUNDARY rows: (group, dof_start, dof_end, value)."""
    fixed: Dict[int, float] = {}
    for c in cards:
        gid = c.iparam("GRPID", 1)
        if grpid_filter is not None and gid not in grpid_filter:
            continue
        if c.param("ROT_CENTER"):
            continue      # rotational BC rows: collect_rot
        for row in c.data:
            grp = row[0]
            ds = int(float(row[1])) if len(row) > 1 else 1
            de = int(float(row[2])) if len(row) > 2 else ds
            val = float(row[3]) if len(row) > 3 else 0.0
            nodes = _resolve_node_group(mesh, grp)
            for d in range(ds, de + 1):
                if d > ndof:
                    continue
                for n in nodes:
                    fixed[int(n) * ndof + (d - 1)] = val
    if not fixed:
        return np.zeros(0, np.int64), np.zeros(0)
    keys = np.asarray(sorted(fixed), dtype=np.int64)
    vals = np.asarray([fixed[int(k)] for k in keys])
    return keys, vals


def collect_cload(mesh: Mesh, cards: List[Card], ndof: int, n_node: int,
                  grpid_filter=None) -> np.ndarray:
    f = np.zeros(n_node * ndof)
    for c in cards:
        gid = c.iparam("GRPID", 1)
        if grpid_filter is not None and gid not in grpid_filter:
            continue
        if c.param("ROT_CENTER"):
            for ent in collect_rot(mesh, [c], ndof):
                f += torque_forces(mesh, ent, mesh.coords)
            continue
        for row in c.data:
            grp = row[0]
            d = int(float(row[1]))
            val = float(row[2])
            nodes = _resolve_node_group(mesh, grp)
            if d <= ndof:
                f[nodes * ndof + (d - 1)] += val
    return f


def collect_rot(mesh: Mesh, cards: List[Card], ndof: int,
                grpid_filter=None):
    """ROT_CENTER entries on !BOUNDARY/!CLOAD: one per card, with the
    rotation or torque vector accumulated across rows (fstr_AddBC.f90:
    70-85, fstr_ass_load.f90:51-93).  Returns dicts with 'nodes' (the
    slave nodes), 'center' (the center group's nodes), 'vec' (3,)."""
    out = []
    for c in cards:
        cg = c.param("ROT_CENTER")
        if not cg:
            continue
        gid = c.iparam("GRPID", 1)
        if grpid_filter is not None and gid not in grpid_filter:
            continue
        vec = np.zeros(3)
        nodes = None
        for row in c.data:
            if len(row) >= 4:               # BOUNDARY: ds, de, val
                ds, de = int(float(row[1])), int(float(row[2]))
                val = float(row[3])
            else:                           # CLOAD: dof, val
                ds = de = int(float(row[1]))
                val = float(row[2])
            for d in range(ds, de + 1):
                vec[(d - 1) % 3] = val
            nodes = _resolve_node_group(mesh, row[0])
        center = _resolve_node_group(mesh, cg)
        if nodes is None or len(nodes) == 0 or len(center) == 0:
            continue
        out.append(dict(nodes=nodes, center=center, vec=vec))
    return out


def torque_forces(mesh: Mesh, ent, coords) -> np.ndarray:
    """Torque CLOAD: per slave node F = (T/n)(a x r)/|a x r|^2, a the
    unit axis, r the position relative to the center
    (fstr_ass_load.f90:95-133): each node carries torque T/n."""
    ndof = coords.shape[1] if coords.ndim == 2 else 3
    f = np.zeros(mesh.n_node * 3)
    vec = ent["vec"]
    T = float(np.linalg.norm(vec))
    if T < 1e-16:
        return f.reshape(mesh.n_node, 3)[:, :ndof].reshape(-1)
    a = vec / T
    c = coords[ent["center"]].mean(axis=0)
    tn = T / len(ent["nodes"])
    for n in ent["nodes"]:
        r = coords[int(n)] - c
        v = np.cross(a, r)
        nv2 = float(v @ v)
        if nv2 < 1e-16:
            raise ValueError("torque node coincides with the rotation "
                             "center (fstr_ass_load.f90:126)")
        f[3 * int(n):3 * int(n) + 3] = (tn / nv2) * v
    return f.reshape(mesh.n_node, 3)[:, :ndof].reshape(-1)


def rodrigues(vec: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Rotate r (n, 3) by the rotation vector vec (angle = |vec|)."""
    th = float(np.linalg.norm(vec))
    if th < 1e-16:
        return r.copy()
    k = vec / th
    return (r * np.cos(th) + np.cross(k, r) * np.sin(th)
            + np.outer(r @ k, k) * (1.0 - np.cos(th)))


def rot_bc_disp(ent, coords, u=None, factor: float = 1.0) -> tuple:
    """Prescribed displacement increment of a rotational BC: du =
    R(factor vec) r - r, r the current slave position relative to the
    center (fstr_AddBC.f90:112-160).  Returns (dofs, values)."""
    nd = coords.shape[1]
    cur = coords if u is None else coords + u.reshape(-1, nd)
    c = cur[ent["center"]].mean(axis=0)
    r = cur[ent["nodes"]] - c
    r3 = np.zeros((len(r), 3))
    r3[:, :nd] = r
    du = rodrigues(ent["vec"] * factor, r3) - r3
    dofs = (np.asarray(ent["nodes"])[:, None] * nd
            + np.arange(nd)[None, :]).reshape(-1)
    return dofs.astype(np.int64), du[:, :nd].reshape(-1)


def _orientation_frame(cfg: AnalysisConfig, sect_id: int):
    """The 3x3 local frame (rows the local axes) of '!SECTION, SECNUM=n,
    ORIENTATION=name', from '!ORIENTATION, DEFINITION=COORDINATES' points
    a, b, c (fstr_setup.f90:1517-1570: x = (a-c)/|a-c|, z = x cross
    (b-c), y = z cross x); None when the section names none."""
    name = None
    for c in cfg.sections:
        if c.iparam("SECNUM", 0) == sect_id + 1:
            name = (c.param("ORIENTATION") or "").upper() or None
    if name is None:
        return None
    known = [(c.param("NAME") or "").upper() for c in cfg.orientations]
    if name not in known:
        raise ValueError(f"!SECTION references undefined ORIENTATION "
                         f"'{name}' (defined: {known or 'none'})")
    for c in cfg.orientations:
        if (c.param("NAME") or "").upper() != name:
            continue
        dfn = (c.param("DEFINITION") or "COORDINATES").upper()
        if dfn != "COORDINATES":
            raise NotImplementedError("ORIENTATION DEFINITION=NODES")
        vals = [float(v) for v in c.rows_f()[0]] + [0.0] * 9
        a, b, c0 = (np.asarray(vals[k:k + 3]) for k in (0, 3, 6))
        f1 = (a - c0) / np.linalg.norm(a - c0)
        f3 = np.cross(f1, b - c0)
        f3 = f3 / np.linalg.norm(f3)
        return np.stack([f1, np.cross(f3, f1), f3])
    return None


def _iset_from_section(sec) -> int:
    # fstr_setup.f90:1012-1021: sect_opt 0 -> plane stress, 1 -> plane
    # strain, 2 -> axisymmetric
    return {0: mat.PLANE_STRESS, 1: mat.PLANE_STRAIN,
            2: mat.AXISYMMETRIC}.get(sec.opt, mat.PLANE_STRESS)


SOLID2D_ETYPES = (231, 232, 241, 242)           # plane solids, 2 dofs a node
SOLID3D_ETYPES = (341, 342, 351, 352, 361, 362)
SHELL_ETYPES = (731, 741, 743)  # MITC3/4/9 shells, 6 dofs a node
SSHELL_ETYPES = (761, 781)      # solid-shell packing, 3 dofs a node
BEAM6_ETYPES = (611,)           # 2-node beam, 6 dofs a node
BEAM3_ETYPES = (641,)           # the beam packed as four 3-dof nodes
SIX_ETYPES = SHELL_ETYPES + BEAM6_ETYPES
SLICE_ETYPES = SOLID2D_ETYPES + SOLID3D_ETYPES + SIX_ETYPES + \
    SSHELL_ETYPES + BEAM3_ETYPES                # the ported element types


def contact_family(cfg: AnalysisConfig) -> Optional[str]:
    """The analysis family of a deck whose !CONTACT card the JAX package
    drops without effect (ROADMAP, queue 3, fault 2), or None: contact
    runs in STATIC, NLSTATIC and implicit DYNAMIC only.  Explicit
    dynamics, the frequency response, EIGEN and the Lanczos part of
    STATICEIGEN never read the card there."""
    sol = cfg.solution_type.upper()
    d = cfg.dynamic
    if sol in ("STATIC", "NLSTATIC"):
        return None
    if sol == "DYNAMIC":
        if d is not None and d.idx_resp == 2:
            return "frequency response"
        if d is not None and d.idx_eqa == 11:
            return "explicit dynamics"
        return None
    return sol


def check_slice(mesh: Mesh, cfg: AnalysisConfig) -> None:
    """Raise on any card or element type of the deck outside the ported
    slice.  !EMBED raises too: the JAX package parses it, warns and
    drops it (``frontistr_tpu/run.py:180-181``); so does !CONTACT in a
    family where the JAX package drops it (``contact_family``), and so
    do the cards its 6-dof model build leaves out (``check_six``)."""
    if cfg.embeds:
        raise NotImplementedError("!EMBED card")
    fam = contact_family(cfg)
    if cfg.contacts and fam is not None:
        raise NotImplementedError(f"!CONTACT in {fam}")
    for b in mesh.blocks:
        if b.etype not in SLICE_ETYPES:
            raise NotImplementedError(
                f"element type {b.etype} (the port runs the 2-D solids "
                "231, 232, 241 and 242, the 3-D solids 341, 342, 351, "
                "352, 361 and 362, the shells 731, 741 and 743, the "
                "solid-shells 761 and 781 and the beams 611 and 641 so "
                "far)")
    six = [b for b in mesh.blocks if b.etype in SIX_ETYPES]
    if six and len(six) < len(mesh.blocks):
        # frontistr_tpu/assembly/model.py:366-367
        raise NotImplementedError("mixed shell/solid meshes")
    if six:
        check_six(mesh, cfg)
    if {b.etype in SOLID2D_ETYPES for b in mesh.blocks} == {True, False}:
        raise NotImplementedError("2-D and 3-D solids in one mesh")


def check_six(mesh: Mesh, cfg: AnalysisConfig) -> None:
    """The JAX package's 6-dof model build (``_build_shell_model``) reads
    the !BOUNDARY, !CLOAD and !DLOAD cards and drops the rest without a
    word: the port refuses what it would drop, and !EQUATION and
    !CONTACT, which it does not run on 6-dof models."""
    if user.has_uload():
        raise NotImplementedError("a registered uload on a 6-dof model")
    for name, cards in (("!SPRING", cfg.springs),
                        ("!TEMPERATURE", cfg.temperatures),
                        ("!CONTACT", cfg.contacts),
                        ("!EQUATION", mesh.equations),
                        ("ROT_CENTER", [c for c in cfg.boundaries +
                                        cfg.cloads
                                        if c.param("ROT_CENTER")])):
        if cards:
            raise NotImplementedError(f"{name} on a 6-dof (shell or "
                                      "beam) model")


def formulation_361(cfg: AnalysisConfig, section_id: int) -> str:
    """The hex8 formulation: IC for linear STATIC, B-bar under nlgeom
    (fstr_setup.f90:365-379), overridden by ``!ELEMOPT, 361=`` and then
    by the block section's ``FORM361`` (fstr_ctrl_common.f90:311-320);
    IC under nlgeom falls back to B-bar (fstr_setup.f90:841-845)."""
    form = "BBAR" if cfg.nlgeom else "IC"
    if cfg.elemopt361:
        form = {1: "FI", 2: "BBAR", 3: "IC", 4: "FBAR"}.get(cfg.elemopt361,
                                                          form)
    for c in cfg.sections:
        if c.iparam("SECNUM", 0) == section_id + 1:
            f361 = (c.param("FORM361") or "").upper()
            if f361 in ("FI", "BBAR", "IC", "FBAR"):
                form = f361
    if cfg.nlgeom and form == "IC":
        form = "BBAR"
    return form


def beam_section(mesh: Mesh, sect_id: int) -> tuple:
    """A beam block's seven !SECTION values, or ``beam.DEFAULT_SECTION``
    when the section gives fewer (the JAX package's rule)."""
    sec = mesh.sections[sect_id] if mesh.sections else None
    return tuple(float(v) for v in sec.values[:7]) \
        if sec and len(sec.values) >= 7 else DEFAULT_SECTION


def fiber_params(mesh: Mesh, sect_id: int) -> tuple:
    """A 641 block's fiber radius and six angles from the extended
    !MATERIAL ELASTIC row (E, nu, radius, angle1..6;
    fstr_get_prop.f90:91-99), else (0.0, None)."""
    sec = mesh.sections[sect_id] if mesh.sections else None
    md = mesh.materials.get(sec.material) if sec else None
    rows = md.items.get(1) if md is not None else None
    row = rows[0] if rows else []
    if len(row) >= 9:
        return float(row[2]), tuple(float(v) for v in row[3:9])
    return 0.0, None


def _struct_block(mesh: Mesh, cfg: AnalysisConfig, b, ndof: int) -> KBlock:
    """A shell, solid-shell or beam block: linear elastic, infinitesimal
    (``frontistr_tpu/assembly/model.py:385-411, 534-573``)."""
    sec = mesh.sections[b.section_id] if mesh.sections else None
    mname = sec.material if sec else next(iter(mesh.materials), "")
    m = _resolve_material(mesh, cfg.materials, mname)
    m.nlgeom = mat.INFINITESIMAL
    E, nn = b.conn.shape
    dofs = (b.conn[:, :, None] * ndof +
            np.arange(ndof)[None, None, :]).reshape(E, nn * ndof)
    D1 = mat.elastic_D(m.youngs, m.poisson, mat.D3)
    kind = ("shell" if b.etype in SHELL_ETYPES else
            "sshell" if b.etype in SSHELL_ETYPES else
            "beam" if b.etype in BEAM6_ETYPES else "beam341")
    thick = sec.values[0] if sec and sec.values and kind != "beam341" \
        else 1.0
    beam = kind in ("beam", "beam341")
    return KBlock(b.etype, b.elem_ids, b.conn, dofs.astype(np.int32),
                  np.broadcast_to(D1, (E,) + D1.shape).copy(), thick,
                  mat.D3, np.full(E, m.density), m, b.section_id,
                  kind=kind,
                  section=beam_section(mesh, b.section_id) if beam
                  else None,
                  fiber=fiber_params(mesh, b.section_id)
                  if kind == "beam341" else (0.0, None))


def build_struct_model(mesh: Mesh, cfg: AnalysisConfig,
                       device="cuda") -> StructModel:
    """The model on ``device`` (default the card; without one, an
    error).  Shells and 611 beams make a 6-dof model, as in the JAX
    package (``_build_shell_model``: the !BOUNDARY, !CLOAD and !DLOAD
    cards, no follower load); solid-shells and 641 beams are 3-dof blocks
    beside the solids."""
    dev = resolve(device)
    check_slice(mesh, cfg)
    six = bool(mesh.blocks) and mesh.blocks[0].etype in SIX_ETYPES
    dim = 2 if mesh.blocks and mesh.blocks[0].etype in SOLID2D_ETYPES \
        else 3
    ndof = 6 if six else dim
    n_node = mesh.n_node
    coords = mesh.coords[:, :dim].copy()

    blocks: List[KBlock] = []
    for b in mesh.blocks:
        if b.etype not in SOLID2D_ETYPES + SOLID3D_ETYPES:
            blocks.append(_struct_block(mesh, cfg, b, ndof))
            continue
        table = get_table(b.etype)
        sec = mesh.sections[b.section_id] if mesh.sections else None
        mname = sec.material if sec else next(iter(mesh.materials), "")
        m = _resolve_material(mesh, cfg.materials, mname)
        # the JAX package's rule: under nlgeom an INFINITESIMAL flag
        # becomes TOTALLAG; linear STATIC runs infinitesimal
        if cfg.nlgeom:
            m.nlgeom = mat.TOTALLAG if m.nlgeom == mat.INFINITESIMAL \
                else m.nlgeom
        else:
            m.nlgeom = mat.INFINITESIMAL
        E = len(b.elem_ids)
        thick, iset = 1.0, mat.D3
        if dim == 2:
            # the section's sect_opt and thickness (fstr_setup.f90)
            iset = _iset_from_section(sec) if sec else mat.PLANE_STRESS
            thick = sec.values[0] if sec and sec.values else 1.0
        if m.ortho_consts is not None and dim == 3:
            D1 = mat.elastic_D_ortho(m.ortho_consts)
            frame = _orientation_frame(cfg, b.section_id)
            if frame is not None:
                D1 = mat.rotate_D(D1, frame)
        else:
            # a 2-D orthotropic block takes the isotropic D of (E1, nu12),
            # as in the JAX package
            D1 = mat.elastic_D(m.youngs, m.poisson, iset)
        D = np.broadcast_to(D1, (E,) + D1.shape).copy()
        nn = table.nn
        dofs = (b.conn[:, :, None] * ndof +
                np.arange(ndof)[None, None, :]).reshape(E, nn * ndof)
        form = formulation_361(cfg, b.section_id) if b.etype == 361 \
            else "FI"
        blocks.append(KBlock(b.etype, b.elem_ids, b.conn,
                             dofs.astype(np.int32), D, thick, iset,
                             np.full(E, m.density), m, b.section_id,
                             formulation=form))

    step = cfg.steps[0]
    grpid = set(step.boundary_groups) if step.boundary_groups else None
    fixed_dofs, fixed_vals = collect_boundary(mesh, cfg.boundaries, ndof,
                                              grpid)
    rot_bcs = collect_rot(mesh, cfg.boundaries, ndof, grpid)
    if rot_bcs:
        # rotational BC slaves are Dirichlet in all dofs; the linear path
        # takes the full-angle Rodrigues values, the Newton loop replaces
        # them incrementally per substep
        add_d, add_v = zip(*(rot_bc_disp(ent, coords) for ent in rot_bcs))
        keep = ~np.isin(fixed_dofs, np.concatenate(add_d))
        fixed_dofs = np.concatenate([fixed_dofs[keep], *add_d])
        fixed_vals = np.concatenate([fixed_vals[keep], *add_v])
        order = np.argsort(fixed_dofs)
        fixed_dofs, fixed_vals = fixed_dofs[order], fixed_vals[order]
    lgrp = set(step.load_groups) if step.load_groups else None
    f_ext = collect_cload(mesh, cfg.cloads, ndof, n_node, lgrp)
    model = StructModel(mesh, cfg, ndof, dim, n_node, coords, blocks,
                        fixed_dofs, fixed_vals, f_ext, device=dev,
                        nlgeom=cfg.nlgeom and not six, reftemp=cfg.reftemp)
    model.rot_bcs = rot_bcs
    model.extras = extras.collect_extras(model, grpid)
    if six:
        # the 6-dof model: dead DLOAD only, no follower record
        if cfg.dloads:
            model.f_ext = model.f_ext + loads.collect_dload(
                mesh, model, cfg.dloads, lgrp)
        return model
    # dead DLOAD and thermal loads of the first step's load groups; the
    # Newton driver re-assembles DLOAD at u under nlgeom (follower)
    if cfg.dloads:
        model.f_base = model.f_ext.copy()
        model.dload_grp = (cfg.dloads, lgrp)
        model.f_ext = model.f_ext + loads.collect_dload(mesh, model,
                                                        cfg.dloads, lgrp)
    if cfg.temperatures:
        T = loads.collect_temperature(mesh, cfg.temperatures, n_node,
                                      cfg.reftemp, lgrp)
        if T is None and getattr(cfg, "temp_read_field", None) is not None:
            # READRESULT import (readtemp.f90): the nodal field of a heat
            # run's result file, set by the runner
            T = np.asarray(cfg.temp_read_field, float)
        if T is not None:
            model.temperature = T
            # temperature-dependent E(T), nu(T): per-gauss-point D before
            # the thermal load is assembled (elastic_at_T)
            for b in model.blocks:
                et = b.material.elastic_table
                if et is not None and len(np.asarray(et)) > 1:
                    t = get_table(b.etype)
                    tq = np.einsum("qn,en->eq", t.N, T[b.conn])
                    b.D = mat.elastic_D_batch(*mat.elastic_at_T(et, tq),
                                              b.iset)
            tl = loads.thermal_load(model, T)
            model.f_ext = model.f_ext + tl
            if model.f_base is not None:
                model.f_base = model.f_base + tl
    # the uload plug point (uload.f90 'uloading'): the registered extra
    # external force
    fu = user.uload_total(model.coords, ndof)
    if fu is not None:
        model.f_ext = model.f_ext + np.asarray(fu).reshape(-1)
        if model.f_base is not None:
            model.f_base = model.f_base + np.asarray(fu).reshape(-1)
    return model
