"""Host-side model builder: mesh + control deck -> element blocks, BCs and
loads (torch port of ``frontistr_tpu/assembly/model.py``, the slice the
linear-elastic STATIC path needs).

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

from frontistr_tpu_torch.elements.tables import get_table
from frontistr_tpu_torch.fem import material as mat
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
    kind: str = "solid"


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

    @property
    def n_dof_total(self) -> int:
        return self.n_node * self.ndof


def _resolve_material(mesh: Mesh, cnt_mats: Dict[str, CntMaterial],
                      name: str) -> mat.Material:
    """Merge mesh !MATERIAL items with .cnt !MATERIAL subcards; the .cnt
    definition wins (fstr_setup.f90 pass 2).  Only the isotropic elastic
    subcards belong to this slice; any other raises."""
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
        cm = cnt_mats[""]
    if cm is None:
        return m
    for sub in ("plastic", "hyperelastic", "viscoelastic", "trs", "creep",
                "user_material", "fluid"):
        if getattr(cm, sub) is not None:
            raise NotImplementedError(f"!{sub.upper()} material card")
    if cm.elastic is not None:
        if (cm.elastic.param("TYPE") or "").upper().startswith("ORTHO"):
            raise NotImplementedError("!ELASTIC, TYPE=ORTHOTROPIC")
        rows = cm.elastic.rows_f()
        if len(rows) > 1:
            raise NotImplementedError("temperature-dependent !ELASTIC")
        m.youngs, m.poisson = rows[0][0], rows[0][1]
    if cm.density is not None:
        m.density = cm.density.rows_f()[0][0]
    if cm.expansion is not None:
        m.expansion = cm.expansion.rows_f()[0][0]
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
            raise NotImplementedError("!BOUNDARY, ROT_CENTER")
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
            raise NotImplementedError("!CLOAD, ROT_CENTER")
        for row in c.data:
            grp = row[0]
            d = int(float(row[1]))
            val = float(row[2])
            nodes = _resolve_node_group(mesh, grp)
            if d <= ndof:
                f[nodes * ndof + (d - 1)] += val
    return f


SLICE_ETYPES = (341,)     # element types the ported slice runs


def check_slice(mesh: Mesh, cfg: AnalysisConfig) -> None:
    """Raise on any card or element type of the deck outside the ported
    slice."""
    unported = [("!DLOAD", cfg.dloads), ("!TEMPERATURE", cfg.temperatures),
                ("!SPRING", cfg.springs), ("!CONTACT", cfg.contacts),
                ("!EMBED", cfg.embeds), ("!EQUATION", mesh.equations),
                ("!ORIENTATION", cfg.orientations)]
    for name, cards in unported:
        if cards:
            raise NotImplementedError(f"{name} card")
    for b in mesh.blocks:
        if b.etype not in SLICE_ETYPES:
            raise NotImplementedError(
                f"element type {b.etype} (the port runs tet4, 341, so far)")


def build_struct_model(mesh: Mesh, cfg: AnalysisConfig,
                       device="cpu") -> StructModel:
    check_slice(mesh, cfg)
    dim = ndof = 3
    n_node = mesh.n_node
    coords = mesh.coords[:, :dim].copy()

    blocks: List[KBlock] = []
    for b in mesh.blocks:
        table = get_table(b.etype)
        sec = mesh.sections[b.section_id] if mesh.sections else None
        mname = sec.material if sec else next(iter(mesh.materials), "")
        m = _resolve_material(mesh, cfg.materials, mname)
        m.nlgeom = mat.TOTALLAG if cfg.nlgeom else mat.INFINITESIMAL
        E = len(b.elem_ids)
        D1 = mat.elastic_D(m.youngs, m.poisson, mat.D3)
        D = np.broadcast_to(D1, (E,) + D1.shape).copy()
        nn = table.nn
        dofs = (b.conn[:, :, None] * ndof +
                np.arange(ndof)[None, None, :]).reshape(E, nn * ndof)
        blocks.append(KBlock(b.etype, b.elem_ids, b.conn,
                             dofs.astype(np.int32), D, 1.0, mat.D3,
                             np.full(E, m.density), m, b.section_id))

    step = cfg.steps[0]
    grpid = set(step.boundary_groups) if step.boundary_groups else None
    fixed_dofs, fixed_vals = collect_boundary(mesh, cfg.boundaries, ndof,
                                              grpid)
    lgrp = set(step.load_groups) if step.load_groups else None
    f_ext = collect_cload(mesh, cfg.cloads, ndof, n_node, lgrp)
    return StructModel(mesh, cfg, ndof, dim, n_node, coords, blocks,
                       fixed_dofs, fixed_vals, f_ext,
                       device=torch.device(device), nlgeom=cfg.nlgeom)
