"""Batched solid element kernels, 2-D and 3-D (torch port of
``frontistr_tpu/fem/solid.py``): the small-strain arms
(``stiffness_linear``, its isotropic closed form ``stiffness_linear_iso``,
``strains_at_gauss``, ``internal_force``; reference STF_C3 / UPDATE_C3,
fistr1/src/lib/static_LIB_3d.f90:47-205), the geometrically nonlinear
tangent (``stiffness_nlgeom``, TOTALLAG and UPDATELAG, with the hex8
B-bar correction of STF_C3D8Bbar; STF_C3:137-204), the hex8 F-bar
tangents (``stiffness_hex8fbar``, ``stiffness_nlgeom_fbar``; STF_C3D8Fbar,
static_LIB_Fbar.f90) and the incompatible-mode hex8 arm
(``stiffness_hex8ic`` / ``strains_at_gauss_hex8ic``; reference
STF_C3D8IC / UpdateST_C3D8IC, static_LIB_3dIC.f90).

Each element block is one batched product chain.  The JAX package cuts
large blocks into ``lax.map`` chunks to bound TPU temporaries; a card
holds the whole block (the float64 tangent of 1,971,054 tets is
2.27 GB), so the port runs it in one pass.
"""

from __future__ import annotations

import numpy as np
import torch

from frontistr_tpu_torch.elements.tables import ElementTable, shape_deriv
from frontistr_tpu_torch.fem.isoparam import (b_matrix, det_inv_small,
                                              jacobians, strain_selector_2d,
                                              strain_selector_3d)
from frontistr_tpu_torch.fem.material import INFINITESIMAL, TOTALLAG, \
    UPDATELAG


# device copies of the static tables, one per (table, dtype, device): the
# Newton driver calls these functions every iteration, and a fresh copy
# would be a host-to-device transfer each time
_DEVICE_TABLES: dict = {}


def _uploaded(key, make, like: torch.Tensor) -> torch.Tensor:
    key = key + (like.dtype, like.device)
    t = _DEVICE_TABLES.get(key)
    if t is None:
        t = _DEVICE_TABLES[key] = torch.as_tensor(
            make(), dtype=like.dtype, device=like.device)
    return t


def _selector(dim: int, like: torch.Tensor) -> torch.Tensor:
    return _uploaded(("S", dim), lambda: strain_selector_3d() if dim == 3
                     else strain_selector_2d(), like)


def table_tensor(table: ElementTable, name: str,
                 like: torch.Tensor) -> torch.Tensor:
    """``table.<name>`` ("dN", "N", "weights", "points"; "dN0": the shape
    derivatives at the centroid) in ``like``'s dtype and device, uploaded
    once."""
    return _uploaded((table.etype, name), lambda: shape_deriv(
        table.etype, np.zeros(table.dim)) if name == "dN0"
        else getattr(table, name), like)


def stiffness_linear(table: ElementTable, coords_e: torch.Tensor,
                     D_e: torch.Tensor, thick: float = 1.0) -> torch.Tensor:
    """Small-strain elastic stiffness for a block of elements.

    Args:
      table: static element tables.
      coords_e: (E, nn, dim).
      D_e: (E, ns, ns) elastic matrices, (1, ns, ns) for a
        block-constant material, or (E, nq, ns, ns) per quadrature point
        (E(T), nu(T); a material tangent).
      thick: section thickness (2D only; STF_C2 PARAM1).

    Returns: (E, nn*dim, nn*dim) element stiffness.
    """
    E, nn, _ = coords_e.shape
    det, gderiv = jacobians(table_tensor(table, "dN", coords_e), coords_e)
    S = _selector(table.dim, coords_e)
    w = table_tensor(table, "weights", coords_e)
    scale = thick if table.dim == 2 else 1.0
    ns = S.shape[0]
    m = nn * table.dim
    nq = table.nq
    B = torch.einsum("kdj,eqnj->eqknd", S, gderiv).reshape(E, nq, ns, m)
    if D_e.dim() == 4:
        DB = torch.matmul(D_e, B)
    else:
        # DB[e,q,k,j] = D[e,k,l] B[e,q,l,j]: one (E, ns, nq*m) matmul
        B2 = B.transpose(1, 2).reshape(E, ns, nq * m)
        DB = torch.matmul(D_e, B2).reshape(E, ns, nq, m).transpose(1, 2)
    wdet = (w * scale)[None, :] * det                       # (E, nq)
    DB = DB * wdet[:, :, None, None]
    # k[e,i,j] = sum_{q,k} B[e,q,k,i] DB[e,q,k,j]
    Bt = B.reshape(E, nq * ns, m)
    DBt = DB.reshape(E, nq * ns, m)
    return torch.matmul(Bt.transpose(1, 2), DBt)


def stiffness_linear_iso(table: ElementTable, coords_e: torch.Tensor,
                         lam: float, mu: float) -> torch.Tensor:
    """Isotropic small-strain stiffness in closed form (3D only):
        ke[(a,i),(b,j)] = int lam g_ai g_bj + mu (d_ij g_a.g_b + g_aj g_bi)
    one gram product of sqrt(w det)-scaled derivatives per element.
    Matches ``stiffness_linear(table, x, elastic_D(E, nu, D3))`` to f64
    rounding (same quadrature)."""
    det, g = jacobians(table_tensor(table, "dN", coords_e), coords_e)
    wg = table_tensor(table, "weights", coords_e)[None, :] * det
    gs = g * torch.sqrt(wg)[..., None, None]
    E, q, n, _ = g.shape
    G = gs.reshape(E, q, n * 3)
    M5 = torch.matmul(G.transpose(1, 2), G).reshape(E, n, 3, n, 3)
    S = torch.einsum("eakbk->eab", M5)                  # grad . grad
    ke = lam * M5 + mu * M5.permute(0, 1, 4, 3, 2)
    eye = torch.eye(3, dtype=coords_e.dtype, device=coords_e.device)
    ke = ke + mu * S[:, :, None, :, None] * eye[None, None, :, None, :]
    return ke.reshape(E, n * 3, n * 3)


def _stress_tensor(sig: torch.Tensor, dim: int = 3) -> torch.Tensor:
    """Voigt stress -> full tensor: 3-D (11, 22, 33, 12, 23, 13) -> 3x3,
    2-D (11, 22, 12, ...) -> 2x2."""
    if dim == 2:
        s11, s22, s12 = sig[..., 0], sig[..., 1], sig[..., 2]
        return torch.stack([torch.stack([s11, s12], -1),
                            torch.stack([s12, s22], -1)], -2)
    s11, s22, s33, s12, s23, s13 = (sig[..., i] for i in range(6))
    return torch.stack([torch.stack([s11, s12, s13], -1),
                        torch.stack([s12, s22, s23], -1),
                        torch.stack([s13, s23, s33], -1)], -2)


def _expand_D(D_e: torch.Tensor, E: int) -> torch.Tensor:
    """A block-constant (1, ...) material matrix as an (E, ...) view."""
    return D_e.expand((E,) + tuple(D_e.shape[1:])) if D_e.shape[0] == 1 \
        else D_e


def centroid_gderiv(table: ElementTable, elem: torch.Tensor):
    """Global derivatives at the element centroid, (E, nn, dim): the
    B-bar dilatation reference (STF_C3D8Bbar, static_LIB_C3D8.f90)."""
    dN0 = table_tensor(table, "dN0", elem)
    _, g0 = jacobians(dN0[None], elem)
    return g0[:, 0]


def _bbar_correction(g: torch.Tensor, g0: torch.Tensor) -> torch.Tensor:
    """Rows 1..3 of the B correction: +(g0 - g)/3 on every direction
    column (STF_C3D8Bbar).  Returns (E, 3, nn*dim) to add to B; the
    F-bar small-strain correction has the same form with the
    volume-averaged reference (static_LIB_Fbar.f90:166-178)."""
    E, nn, dim = g.shape
    corr = (g0 - g) / 3.0
    return corr[:, None].expand(E, 3, nn, dim).reshape(E, 3, nn * dim)


def volavg_gderiv(table: ElementTable, elem: torch.Tensor, jacob=None):
    """Volume-averaged global derivatives: the F-bar dilatation reference
    (STF_C3D8Fbar gderiv1_ave, static_LIB_Fbar.f90:85-118).  With
    ``jacob`` (per-gauss J = det F) the weights are jacob * w det, as in
    the finite-strain arms; else jacob = 1 (INFINITE).  Returns
    (g_ave (E, nn, dim), det, gderiv)."""
    det, g = jacobians(table_tensor(table, "dN", elem), elem)
    wg = table_tensor(table, "weights", elem)[None, :] * det
    jwg = wg if jacob is None else wg * jacob
    denom = jwg.sum(dim=1)
    g_ave = torch.einsum("eq,eqnd->end", jwg, g) / denom[:, None, None]
    return g_ave, det, g


def stiffness_hex8fbar(table: ElementTable, coords_e: torch.Tensor,
                       D_e: torch.Tensor) -> torch.Tensor:
    """Small-strain F-bar hex8 stiffness (STF_C3D8Fbar INFINITE arm,
    static_LIB_Fbar.f90:26-180): B with rows 1-3 corrected by the
    volume-averaged dilatation, B-bar = B + (g_ave - g)/3.  D_e: (E, 6, 6),
    (1, 6, 6) or (E, nq, 6, 6)."""
    E, nn, dim = coords_e.shape
    D_e = _expand_D(D_e, E)
    g_ave, det, gderiv = volavg_gderiv(table, coords_e)
    S = _selector(3, coords_e)
    w = table_tensor(table, "weights", coords_e)
    m = nn * dim
    nq = table.nq
    B = torch.einsum("kdj,eqnj->eqknd", S, gderiv).reshape(E, nq, 6, m)
    corr = _bbar_correction(
        gderiv.reshape(E * nq, nn, dim),
        g_ave[:, None].expand(E, nq, nn, dim).reshape(E * nq, nn, dim))
    B = torch.cat([B[:, :, :3] + corr.reshape(E, nq, 3, m), B[:, :, 3:]],
                  dim=2)
    if D_e.dim() == 4:
        DB = torch.einsum("eqkl,eqlm->eqkm", D_e, B)
    else:
        DB = torch.einsum("ekl,eqlm->eqkm", D_e, B)
    wdet = w[None, :] * det
    return torch.einsum("eqki,eqkj,eq->eij", B, DB, wdet)


def stiffness_nlgeom_fbar(table: ElementTable, coords_e: torch.Tensor,
                          u_e: torch.Tensor, D_e: torch.Tensor,
                          stress_e: torch.Tensor, flag: int) -> torch.Tensor:
    """F-bar tangent with geometric terms (STF_C3D8Fbar TOTALLAG /
    UPDATELAG arms, static_LIB_Fbar.f90:120-334): the material part with
    B-bar = Jr^2 (B0 + B1) + B2 (TL) or B + B2 (UL), the initial-stress
    part BN^T S BN with the F-bar-corrected BN, and the d(dFbar)
    second-variation block."""
    E, nn, dim = coords_e.shape
    D_e = _expand_D(D_e, E)
    dt, dev = coords_e.dtype, coords_e.device
    dN = table_tensor(table, "dN", coords_e)
    m = nn * dim
    S = _selector(3, coords_e)
    w = table_tensor(table, "weights", coords_e)
    eye = torch.eye(3, dtype=dt, device=dev)

    elem1 = coords_e + u_e
    elem = elem1 if flag == UPDATELAG else coords_e

    # averages on the reference mesh (det0, g0) with jacob weights
    det0, g0 = jacobians(dN, coords_e)
    dudx0 = torch.einsum("end,eqnj->eqdj", u_e, g0)
    F = eye[None, None] + dudx0
    jacob = torch.linalg.det(F)
    Jratio = jacob ** (-1.0 / 3.0)
    _, g1 = jacobians(dN, elem1)
    wg0 = w[None, :] * det0
    jwg = wg0 * jacob
    V0J = jwg.sum(dim=1)
    g1_ave = torch.einsum("eq,eqnd->end", jwg, g1) / V0J[:, None, None]
    jacob_ave = V0J / wg0.sum(dim=1)
    Jr = (jacob_ave ** (1.0 / 3.0))[:, None] * Jratio      # (E, nq)
    # gderiv2_ave cross term (static_LIB_Fbar.f90:100-110)
    g2 = (torch.einsum("eq,eqni,eqmj->enimj", jwg, g1, g1)
          - torch.einsum("eq,eqmi,eqnj->enimj", jwg, g1, g1)) \
        / V0J[:, None, None, None, None]

    det, gderiv = jacobians(dN, elem)
    wgt = w[None, :] * det
    k = torch.zeros((E, m, m), dtype=dt, device=dev)
    for q in range(table.nq):
        g = gderiv[:, q]
        B = b_matrix(S, g)                                 # (E, 6, m)
        if flag == TOTALLAG:
            dudx = torch.einsum("end,enj->edj", u_e, g)
            B1 = torch.einsum("kij,edi,enj->eknd", S, dudx, g) \
                .reshape(E, 6, m)
            Fb = Jr[:, q, None, None] * (eye[None] + dudx)
            C = torch.einsum("eki,ekj->eij", Fb, Fb)
            dstrain = torch.stack([
                0.5 * (C[:, 0, 0] - 1), 0.5 * (C[:, 1, 1] - 1),
                0.5 * (C[:, 2, 2] - 1), C[:, 0, 1], C[:, 1, 2],
                C[:, 2, 0]], dim=1)                        # (E, 6)
            z1 = (g1_ave - g1[:, q]) / 3.0                 # (E, nn, 3)
            fac = torch.cat([2 * dstrain[:, :3] + 1.0, 2 * dstrain[:, 3:]],
                            dim=1)
            B2 = torch.einsum("ek,end->eknd", fac, z1).reshape(E, 6, m)
            Bbar = Jr[:, q, None, None] ** 2 * (B + B1) + B2
            coeff = Jr[:, q]
            sff = torch.einsum("ek,ek->e", stress_e[:, q], dstrain)
            gq1 = g1[:, q]
            wg = wgt[:, q]
        else:  # UPDATELAG
            z1 = (g1_ave - g) / 3.0
            B2rows = z1[:, None].expand(E, 3, nn, 3).reshape(E, 3, m)
            Bbar = torch.cat([B[:, :3] + B2rows, B[:, 3:]], dim=1)
            Fb = eye[None].expand(E, 3, 3)
            coeff = torch.ones((E,), dtype=dt, device=dev)
            sig = stress_e[:, q]
            sff = sig[:, 0] + sig[:, 1] + sig[:, 2]
            gq1 = g
            wg = Jr[:, q] ** 3 * wgt[:, q]
        Dq = D_e if D_e.dim() == 3 else D_e[:, q]
        DB = torch.einsum("ekl,elj->ekj", Dq, Bbar)
        k = k + torch.einsum("eki,ekj,e->eij", Bbar, DB, wg)

        # initial stress (1): BN^T Smat BN with the F-bar-corrected BN,
        # BN[(d,i),(n,p)] = coeff delta_ip g[n,d] + Fbar[i,d] z1[n,p]
        Sm = _stress_tensor(stress_e[:, q])                # (E, 3, 3)
        z1q = (g1_ave - gq1) / 3.0                         # (E, nn, 3)
        BN = coeff[:, None, None, None, None] * \
            torch.einsum("ip,end->edinp", eye, g) + \
            torch.einsum("eid,enp->edinp", Fb, z1q)
        SBN = torch.einsum("edf,efinp->edinp", Sm, BN)
        kg = torch.einsum("edinp,edimq->enpmq", BN, SBN)
        k = k + (kg * wg[:, None, None, None, None]).reshape(E, m, m)

        # initial stress (2): d(dFbar) * Stress (static_LIB_Fbar.f90:305-331)
        FS = torch.einsum("eid,edj->eij", Fb, Sm)
        GFS = coeff[:, None, None] * torch.einsum("eij,enj->eni", FS, g)
        ddA = torch.einsum("enp,emq->enpmq", z1q, z1q)
        ddB = (g2 - torch.einsum("enp,emq->enpmq", g1_ave, g1_ave)) / 3.0
        ddC = torch.einsum("enq,emp->enpmq", gq1, gq1) / 3.0
        dd = sff[:, None, None, None, None] * (ddA + ddB + ddC) + \
            torch.einsum("enp,emq->enpmq", z1q, GFS) + \
            torch.einsum("emq,enp->enpmq", z1q, GFS)
        k = k + (dd * wg[:, None, None, None, None]).reshape(E, m, m)
    return k


def stiffness_nlgeom(table: ElementTable, coords_e: torch.Tensor,
                     u_e: torch.Tensor, D_e: torch.Tensor,
                     stress_e: torch.Tensor, flag: int, thick: float = 1.0,
                     bbar: bool = False) -> torch.Tensor:
    """Tangent stiffness with geometric terms (STF_C3 TOTALLAG /
    UPDATELAG arms, static_LIB_3d.f90:137-204; a 2-D block integrates
    over its ``thick``ness, STF_C2).  ``bbar`` adds the
    hex8 volumetric centroid correction of STF_C3D8Bbar; with the
    INFINITESIMAL flag (B-bar small strain) there is no geometric term.

    Args:
      u_e: (E, nn, dim) total displacement at the element nodes.
      D_e: (E, ns, ns), (1, ns, ns) for a block-constant material, or
        (E, nq, ns, ns) per quadrature point (the plastic tangent).
      stress_e: (E, nq, ns) 2nd PK (TL) / Cauchy (UL) stress.
      flag: ``material.TOTALLAG``, ``UPDATELAG`` or ``INFINITESIMAL``.
    """
    dt = coords_e.dtype
    elem = coords_e + u_e if flag == UPDATELAG else coords_e
    det, gderiv = jacobians(table_tensor(table, "dN", coords_e), elem)
    g0 = centroid_gderiv(table, elem) if bbar else None
    S = _selector(table.dim, coords_e)
    w = table_tensor(table, "weights", coords_e)
    E, nn, dim = coords_e.shape
    m = nn * dim
    scale = thick if dim == 2 else 1.0
    eye = torch.eye(dim, dtype=dt, device=coords_e.device)
    k = torch.zeros((E, m, m), dtype=dt, device=coords_e.device)
    for q in range(table.nq):
        g = gderiv[:, q]                                  # (E, nn, dim)
        wg = (w[q] * scale) * det[:, q]
        B = b_matrix(S, g)
        if bbar:
            B = torch.cat([B[:, :3] + _bbar_correction(g, g0), B[:, 3:]],
                          dim=1)
        if flag == TOTALLAG:
            # BL1: B1[k, (n, d)] = sum_ij S[k, i, j] dudx[d, i] g[n, j]
            dudx = torch.einsum("end,enj->edj", u_e, g)
            B1 = torch.einsum("kij,edi,enj->eknd", S, dudx, g)
            B = B + B1.reshape(E, B.shape[1], m)
        Dq = D_e if D_e.dim() == 3 else D_e[:, q]
        DB = torch.matmul(Dq, B) * wg[:, None, None]
        k += torch.matmul(B.transpose(1, 2), DB)
        if flag == INFINITESIMAL:
            continue
        # initial-stress stiffness: delta_ij g[a]^T sigma g[b]
        Sm = _stress_tensor(stress_e[:, q], dim)
        gsg = torch.matmul(torch.matmul(g, Sm), g.transpose(1, 2)) \
            * wg[:, None, None]                           # (E, nn, nn)
        k += (gsg[:, :, None, :, None] * eye[None, None, :, None, :]) \
            .reshape(E, m, m)
    return k


def internal_force(table: ElementTable, coords_e: torch.Tensor,
                   stress_e: torch.Tensor,
                   thick: float = 1.0) -> torch.Tensor:
    """Equivalent nodal force qf = sum_q w det B^T sigma (UPDATE_C3
    tail; a 2-D block over its ``thick``ness).  stress_e: (E, nq, ns).
    Returns (E, nn*dim)."""
    det, gderiv = jacobians(table_tensor(table, "dN", coords_e), coords_e)
    S = _selector(table.dim, coords_e)
    w = table_tensor(table, "weights", coords_e)
    E, nn, dim = coords_e.shape
    wdet = (w * (thick if dim == 2 else 1.0))[None, :] * det
    qf = torch.einsum("kdj,eqnj,eqk,eq->end", S, gderiv, stress_e, wdet)
    return qf.reshape(E, nn * dim)


def strains_at_gauss(table: ElementTable, coords_e: torch.Tensor,
                     u_e: torch.Tensor) -> torch.Tensor:
    """Small strain at every gauss point: eps = B u (UPDATE_C3 linear
    arm).  Returns (E, nq, ns)."""
    _, gderiv = jacobians(table_tensor(table, "dN", coords_e), coords_e)
    S = _selector(table.dim, coords_e)
    return torch.einsum("kdj,eqnj,end->eqk", S, gderiv, u_e)


def _hex8ic_gderivs(table: ElementTable, coords_e: torch.Tensor):
    """Global derivatives of the hex8 incompatible-mode (Wilson) element:
    8 real nodes + 3 enhanced bending modes, gderiv(nn+k, :) =
    -2 xi_k J0^{-1}(k, :) det0 / det_q with J0 the Jacobian at the
    centre (static_LIB_3dIC.f90:100-103).

    Returns det (E, nq) and g_full (E, nq, 11, 3)."""
    dN0 = table_tensor(table, "dN0", coords_e)                    # (8, 3)
    # XJ0[i, j] = sum_n x_i dN0[n, j] (the reference's getJacobian)
    det0, XJ0inv = det_inv_small(torch.einsum("eni,nj->eij", coords_e,
                                              dN0))
    det, gderiv = jacobians(table_tensor(table, "dN", coords_e), coords_e)
    pts = table_tensor(table, "points", coords_e)                   # (nq, 3)
    g_enh = (-2.0 * pts[None, :, :, None] * XJ0inv[:, None, :, :]
             * (det0[:, None] / det)[..., None, None])
    return det, torch.cat([gderiv, g_enh], dim=2)


def _hex8ic_k_full(table: ElementTable, coords_e: torch.Tensor,
                   D_e: torch.Tensor):
    """(E, 33, 33) stiffness over the 24 real and 9 enhanced dofs, and
    g_full."""
    det, g_full = _hex8ic_gderivs(table, coords_e)
    E = coords_e.shape[0]
    S = _selector(3, coords_e)
    nq, m = table.nq, 11 * 3
    B = torch.einsum("kdj,eqnj->eqknd", S, g_full).reshape(E, nq, 6, m)
    wdet = table_tensor(table, "weights", coords_e)[None, :] * det  # (E, nq)
    Dq = D_e if D_e.dim() == 4 else D_e[:, None]
    DB = torch.matmul(Dq, B) * wdet[:, :, None, None]
    k = torch.matmul(B.reshape(E, nq * 6, m).transpose(1, 2),
                     DB.reshape(E, nq * 6, m))
    return k, g_full


def stiffness_hex8ic(table: ElementTable, coords_e: torch.Tensor,
                     D_e: torch.Tensor) -> torch.Tensor:
    """Statically condensed incompatible-mode hex8 stiffness (STF_C3D8IC):
    K = Kdd - Kda Kaa^{-1} Kad, with Kaa (9 x 9) factorized by
    ``torch.linalg.solve_ex`` (no error check: on the card that check
    would wait for the device; Kaa of a valid element is positive
    definite).  D_e: (E, 6, 6), (1, 6, 6) or (E, nq, 6, 6)."""
    k, _ = _hex8ic_k_full(table, coords_e, D_e)
    nd = 24
    Kda = k[:, :nd, nd:]
    return k[:, :nd, :nd] - torch.matmul(
        Kda, torch.linalg.solve_ex(k[:, nd:, nd:], k[:, nd:, :nd])[0])


def strains_at_gauss_hex8ic(table: ElementTable, coords_e: torch.Tensor,
                            u_e: torch.Tensor,
                            D_e: torch.Tensor) -> torch.Tensor:
    """Strains of the IC element (UpdateST_C3D8IC): the enhanced dofs
    a = -Kaa^{-1} Kad u, then eps = B_full [u; a] at every gauss point.
    Returns (E, nq, 6)."""
    k, g_full = _hex8ic_k_full(table, coords_e, D_e)
    E, nn, dim = coords_e.shape
    nd = nn * dim
    u_flat = u_e.reshape(E, nd)
    a = -torch.linalg.solve_ex(
        k[:, nd:, nd:], torch.matmul(k[:, nd:, :nd], u_flat[:, :, None]))[0]
    ua = torch.cat([u_flat, a[:, :, 0]], dim=1).reshape(E, 11, dim)
    S = _selector(3, coords_e)
    return torch.einsum("kdj,eqnj,end->eqk", S, g_full, ua)
