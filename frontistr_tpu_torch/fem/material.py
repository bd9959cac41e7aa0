"""Constitutive models — elastic matrices and material parameter records.

Linear isotropic elasticity replicates calElasticMatrix
(fistr1/src/lib/physics/ElasticLinear.f90), section types per
fistr1/src/lib/physics/material.f90:75-79:
  D3 (=-1), PlaneStress(=1), Planestrain(=0), AxisSymetric(=2), Shell(=3).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# section type enum (material.f90:75-79)
D3 = -1
PLANE_STRAIN = 0
PLANE_STRESS = 1
AXISYMMETRIC = 2
SHELL = 3

# mtype families (subset of mMaterial's constants, same semantics)
ELASTIC = "ELASTIC"
ORTHOELASTIC = "ORTHOELASTIC"
EPLASTIC = "EPLASTIC"
HYPERELASTIC_NEOHOOKE = "NEOHOOKE"
HYPERELASTIC_MOONEYRIVLIN = "MOONEY-RIVLIN"
HYPERELASTIC_ARRUDABOYCE = "ARRUDA-BOYCE"
VISCOELASTIC = "VISCOELASTIC"
CREEP = "NORTON"
USERMATERIAL = "USERMATERIAL"

# nlgeom flags (mMaterial kINFINITE/kTOTALLAG/kUPDATELAG semantics)
INFINITESIMAL = 0
TOTALLAG = 1
UPDATELAG = 2


@dataclasses.dataclass
class Material:
    """Host-side material record (the analogue of tMaterial,
    fistr1/src/lib/physics/material.f90:56-108)."""
    name: str
    mtype: str = ELASTIC
    nlgeom: int = INFINITESIMAL
    youngs: float = 0.0
    poisson: float = 0.0
    density: float = 0.0
    expansion: float = 0.0
    # plasticity (Mises; yield stress table or (sigma_y, H) pair)
    yield_func: str = "MISES"
    hardening: str = "LINEAR"   # LINEAR / MULTILINEAR / SWIFT / RAMBERG-OSGOOD / KINEMATIC / COMBINED
    plastic_consts: Optional[np.ndarray] = None       # raw !PLASTIC rows
    # hyperelastic constants (c10, c01, d / c10 d / c1 lambda_m d)
    hyper_consts: Optional[np.ndarray] = None
    # viscoelastic Prony series rows (g_i, tau_i)
    visco_consts: Optional[np.ndarray] = None
    trs_consts: Optional[np.ndarray] = None     # (T0, C1, C2)
    trs_def: str = "WLF"                        # WLF / ARRHENIUS
    # Norton creep (A, n, m)
    creep_consts: Optional[np.ndarray] = None
    # temperature-dependent elastic table rows: (E, nu, temp)
    elastic_table: Optional[np.ndarray] = None
    # orthotropic constants (E1,E2,E3,nu12,nu13,nu23,G12,G13,G23)
    ortho_consts: Optional[np.ndarray] = None
    # !USER_MATERIAL constants + state count (uMatlMatrix/uUpdate matl)
    user_consts: Optional[np.ndarray] = None
    user_nstatus: int = 0
    # heat: rows of (value..., temp) tables
    heat_density: Optional[np.ndarray] = None
    heat_capacity: Optional[np.ndarray] = None
    heat_conductivity: Optional[np.ndarray] = None


def elastic_D_ortho(c9) -> np.ndarray:
    """Orthotropic 3D elastic matrix in the material frame
    (ElasticLinear.f90 calElasticMatrix_ortho:111-170); Voigt order
    (11,22,33,12,23,13)."""
    E1, E2, E3, n12, n13, n23, G12, G13, G23 = [float(v) for v in c9[:9]]
    n21 = E2 / E1 * n12
    n32 = E3 / E2 * n23
    n31 = E3 / E1 * n13
    d = 1.0 / (1 - n12 * n21 - n23 * n32 - n31 * n13 - 2 * n21 * n32 * n13)
    D = np.zeros((6, 6))
    D[0, 0] = E1 * (1 - n23 * n32) * d
    D[1, 1] = E2 * (1 - n13 * n31) * d
    D[2, 2] = E3 * (1 - n12 * n21) * d
    D[0, 1] = D[1, 0] = E1 * (n21 + n31 * n23) * d
    D[0, 2] = D[2, 0] = E1 * (n31 + n21 * n32) * d
    D[1, 2] = D[2, 1] = E2 * (n32 + n12 * n31) * d
    D[3, 3], D[4, 4], D[5, 5] = G12, G23, G13
    return D


def voigt_transform(b) -> np.ndarray:
    """6x6 engineering-Voigt strain transform for frame rows b (local axes
    in global components): eps_local = tm @ eps_global
    (utilities.f90 transformation:327-360)."""
    tm = np.zeros((6, 6))
    pair = [(0, 1), (1, 2), (2, 0)]
    for i in range(3):
        for j in range(3):
            tm[i, j] = b[i, j] ** 2
        for k, (p, q) in enumerate(pair):
            tm[i, 3 + k] = b[i, p] * b[i, q]
    for k, (i, j) in enumerate(pair):
        for m in range(3):
            tm[3 + k, m] = 2.0 * b[i, m] * b[j, m]
        for l, (p, q) in enumerate(pair):
            tm[3 + k, 3 + l] = b[i, p] * b[j, q] + b[i, q] * b[j, p]
    return tm


def rotate_D(D_local, frame) -> np.ndarray:
    """D_global = tm^T D_local tm (calElasticMatrix_ortho:168-169)."""
    tm = voigt_transform(np.asarray(frame))
    return tm.T @ D_local @ tm


def elastic_D_batch(EE, PP, sect_type: int) -> np.ndarray:
    """Vectorized isotropic elastic matrices: EE, PP (...,) ->
    (..., ns, ns).  Used for temperature-dependent E(T), nu(T) evaluated
    at gauss points (calElasticMatrix with fetch_TableData MC_ISOELASTIC,
    ElasticLinear.f90:24-43)."""
    EE = np.asarray(EE, float)
    PP = np.asarray(PP, float)
    shp = EE.shape
    if sect_type == D3:
        D = np.zeros(shp + (6, 6))
        c = EE / ((1 + PP) * (1 - 2 * PP))
        for i in range(3):
            D[..., i, i] = c * (1 - PP)
            for j in range(3):
                if i != j:
                    D[..., i, j] = c * PP
        g = 0.5 * EE / (1 + PP)
        for i in (3, 4, 5):
            D[..., i, i] = g
        return D
    if sect_type == PLANE_STRESS:
        D = np.zeros(shp + (4, 4))
        c1 = EE / (1 - PP * PP)
        D[..., 0, 0] = D[..., 1, 1] = c1
        D[..., 0, 1] = D[..., 1, 0] = c1 * PP
        D[..., 2, 2] = c1 * 0.5 * (1 - PP)
        return D
    raise NotImplementedError("temperature-dependent D for this section")


def elastic_at_T(table_rows: np.ndarray, T):
    """(E(T), nu(T)) from !ELASTIC rows (E, nu, temp) by linear interp."""
    rows = np.asarray(table_rows)
    temps = rows[:, 2] if rows.shape[1] > 2 else np.arange(len(rows))
    return (np.interp(T, temps, rows[:, 0]),
            np.interp(T, temps, rows[:, 1]))


def elastic_D(youngs, poisson, sect_type: int) -> np.ndarray:
    """Isotropic elastic matrix (ElasticLinear.f90 calElasticMatrix)."""
    ee, pp = float(youngs), float(poisson)
    if sect_type == D3:
        D = np.zeros((6, 6))
        c = ee / ((1 + pp) * (1 - 2 * pp))
        D[0, 0] = D[1, 1] = D[2, 2] = c * (1 - pp)
        off = c * pp
        D[0, 1] = D[0, 2] = D[1, 0] = D[1, 2] = D[2, 0] = D[2, 1] = off
        g = ee / (1 + pp) * 0.5
        D[3, 3] = D[4, 4] = D[5, 5] = g
        return D
    if sect_type == PLANE_STRESS:
        D = np.zeros((4, 4))
        c1 = ee / (1 - pp * pp)
        D[0, 0] = D[1, 1] = c1
        D[0, 1] = D[1, 0] = c1 * pp
        D[2, 2] = c1 * 0.5 * (1 - pp)
        return D
    if sect_type == PLANE_STRAIN:
        D = np.zeros((4, 4))
        c1 = ee / ((1 + pp) * (1 - 2 * pp))
        D[0, 0] = D[1, 1] = c1 * (1 - pp)
        D[0, 1] = D[1, 0] = c1 * pp
        D[2, 2] = ee / (2 * (1 + pp))
        return D
    if sect_type == AXISYMMETRIC:
        D = np.zeros((4, 4))
        c1 = ee * (1 - pp) / ((1 + pp) * (1 - 2 * pp))
        c2 = (1 - 2 * pp) / (2 * (1 - pp))
        rr = pp / (1 - pp)
        D[0, 0] = D[1, 1] = D[3, 3] = c1
        D[0, 1] = D[1, 0] = c1 * rr
        D[0, 3] = D[3, 0] = c1 * rr
        D[1, 3] = D[3, 1] = c1 * rr
        D[2, 2] = c1 * c2
        return D
    raise ValueError(f"unsupported sect_type {sect_type}")
