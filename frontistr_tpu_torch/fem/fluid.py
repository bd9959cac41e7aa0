"""Incompressible-flow u-p tet element 3414, SUPG/PSPG stabilised (torch
port of ``frontistr_tpu/fem/fluid.py``: ``_tau``, ``stf_load_c3_vp``,
``update_c3_vp``, ``fluid_stress``; reference static_LIB_3d_vp.f90).

A P1P1 velocity-pressure tet with streamline-upwind (SUPG) and pressure
(PSPG) stabilisation, integrated with the Crank-Nicolson factor
gamma = 1/2 over one time increment on the 4-point tet rule.  The
dof layout of a node is (v_x, v_y, v_z, p): a 16 x 16 element matrix.
The matrix is not symmetric (advection, SUPG, and the -C / +C^T
velocity-pressure coupling).

The products are the JAX package's einsums, in float64.  Its
(E, q, a, b, i, j) intermediates hold 576 values an element (6.6 GB
each at 1.43 M elements), so ``element_system`` and ``element_strain``
run the elements in chunks of ``CHUNK`` and write each chunk's rows of
the result: the peak stays near the element matrices' own size.  An
element's answer agrees across chunk sizes to the rounding of the
batched products (the tests hold it within 1e-15 of the largest).
"""

from __future__ import annotations

import torch

from frontistr_tpu_torch.fem.isoparam import jacobians

GAMMA = 0.5
CHUNK = 1 << 17            # elements an intermediate holds at once


def _tables(table, like: torch.Tensor):
    """(N (q, nn), dN (q, nn, 3), weights (q,)) on ``like``'s device."""
    return tuple(torch.as_tensor(a, dtype=like.dtype, device=like.device)
                 for a in (table.N, table.dN, table.weights))


def _tau(table, x, v, mu, rho, dt):
    """Per-element stabilisation parameter (STF_C3_vp:74-208):
    t1 = 2/dt, t2 = sum_a |vbar . dndx_a| (volume-averaged derivatives),
    t3 = 4 mu/(rho V^(2/3)) at rest, else mu t2^2/(rho |vbar|^2);
    tau = (t1^2 + t2^2 + t3^2)^(-1/2), vbar the element-centre velocity.
    Returns (tau (E,), det (E, q), g (E, q, nn, 3), wg (E, q))."""
    _, dN, w = _tables(table, x)
    det, g = jacobians(dN, x)
    wg = w[None, :] * det
    vol = wg.sum(dim=1)
    dndx = torch.einsum("eq,eqnd->end", wg, g) / vol[:, None, None]
    vbar = v[:, :, :3].mean(dim=1)
    d = torch.einsum("ei,eni->en", vbar, dndx).abs().sum(dim=1)
    vv = torch.einsum("ei,ei->e", vbar, vbar)
    t1 = 2.0 / dt
    t3 = torch.where(vv < 1e-15,
                     4.0 * mu / (rho * vol ** (2.0 / 3.0)),
                     mu * d * d / (rho * torch.clamp(vv, min=1e-300)))
    tau = 1.0 / torch.sqrt(t1 * t1 + d * d + t3 * t3)
    return tau, det, g, wg


def stf_load_c3_vp(table, x, v, mu, rho, dt):
    """Element matrix K (E, 4nn, 4nn) and explicit right-hand side b
    (E, 4nn) of one element chunk.  x: (E, nn, 3) coordinates; v:
    (E, nn, 4) nodal (velocity, pressure) at the step start, Dirichlet
    values substituted.  The residual of the semi-implicit scheme is
    r = b - K (v + dv) (LOAD_C3_vp:1231-1242)."""
    E, nn = x.shape[0], x.shape[1]
    tau, det, g, wg = _tau(table, x, v, mu, rho, dt)
    N = _tables(table, x)[0]
    ti = 1.0 / dt
    vq = torch.einsum("qn,eni->eqi", N, v[:, :, :3])   # gauss velocity

    # (E, q, a, b) building blocks (STF_C3_vp:252-300)
    MM = N[None, :, :, None] * N[None, :, None, :]
    AA = torch.einsum("qa,eqi,eqbi->eqab", N, vq, g)
    DD = torch.einsum("eqai,eqbj->eqabij", g, g)
    trD = torch.einsum("eqabii->eqab", DD)
    BB = torch.einsum("eqi,eqj,eqabij->eqab", vq, vq, DD)
    CC = torch.einsum("eqai,qb->eqabi", g, N)          # dN_a/dx_i N_b
    MS = AA.transpose(2, 3)
    AS = BB
    CS = torch.einsum("eqk,eqabki->eqabi", vq, DD)
    MP = torch.einsum("qb,eqai->eqabi", N, g)
    AP = CS.transpose(2, 3)

    tq = tau[:, None, None, None]
    # velocity-velocity: delta_ij * core + gamma mu DD[j, i]
    core = (ti * rho * (MM + tq * MS) + GAMMA * rho * (AA + tq * AS)
            + GAMMA * mu * trD)
    Kvv = (GAMMA * mu) * DD.permute(0, 1, 2, 3, 5, 4)
    Kvv = Kvv + core[..., None, None] * torch.eye(3, dtype=x.dtype,
                                                  device=x.device)
    Kvp = -CC + tq[..., None] * CS
    Kpv = (CC.permute(0, 1, 3, 2, 4)
           + (ti * tau)[:, None, None, None, None] * MP
           + (GAMMA * tau)[:, None, None, None, None] * AP)
    Kpp = (tau / rho)[:, None, None, None] * trD

    # the (4nn, 4nn) element matrix, gauss-weighted
    K = x.new_zeros((E, nn, 4, nn, 4))
    K[:, :, :3, :, :3] = torch.einsum("eq,eqabij->eaibj", wg, Kvv)
    K[:, :, :3, :, 3] = torch.einsum("eq,eqabi->eaib", wg, Kvp)
    K[:, :, 3, :, :3] = torch.einsum("eq,eqabj->eabj", wg, Kpv)
    K[:, :, 3, :, 3] = torch.einsum("eq,eqab->eab", wg, Kpp)
    K = K.reshape(E, nn * 4, nn * 4)

    # explicit right-hand side (LOAD_C3_vp:1150-1230): velocity rows
    vel = v[:, :, :3]
    m_v = torch.einsum("qab,ebi->eqai", MM[0], vel)
    a_v = torch.einsum("eqab,ebi->eqai", AA, vel)
    ms_v = torch.einsum("eqab,ebi->eqai", MS, vel)
    as_v = torch.einsum("eqab,ebi->eqai", AS, vel)
    # diffusion: sum_j d_v(j,j,i) = trD v_i; sum_j d_v(j,i,j) = DD_ji v_j
    dv1 = torch.einsum("eqab,ebi->eqai", trD, vel)
    dv2 = torch.einsum("eqabji,ebj->eqai", DD, vel)
    mp_v = torch.einsum("eqabj,ebj->eqa", MP, vel)
    ap_v = torch.einsum("eqabj,ebj->eqa", AP, vel)
    bv = (ti * rho * (m_v + tq * ms_v)
          - (1.0 - GAMMA) * rho * (a_v + tq * as_v)
          - (1.0 - GAMMA) * mu * (dv1 + dv2))
    bp = (ti * tau)[:, None, None] * mp_v \
        - ((1.0 - GAMMA) * tau)[:, None, None] * ap_v
    b = torch.cat([torch.einsum("eq,eqai->eai", wg, bv),
                   torch.einsum("eq,eqa->ea", wg, bp)[..., None]], dim=2)
    return K, b.reshape(E, nn * 4)


def element_system(table, coords, conn, vn, mu, rho, dt,
                   chunk: int = CHUNK):
    """``stf_load_c3_vp`` of every element, ``chunk`` elements at a
    time: coords (n_node, 3), conn (E, nn) int64 and the nodal field vn
    (n_node, 4), all on one device.  Returns K (E, 4nn, 4nn) and b
    (E, 4nn)."""
    E, nn = conn.shape
    K = coords.new_empty((E, 4 * nn, 4 * nn))
    b = coords.new_empty((E, 4 * nn))
    for e0 in range(0, E, chunk):
        c = conn[e0:e0 + chunk]
        K[e0:e0 + chunk], b[e0:e0 + chunk] = stf_load_c3_vp(
            table, coords[c], vn[c], mu, rho, dt)
    return K, b


def update_c3_vp(table, x, v_new):
    """Gauss strain rate and pressure for output (UPDATE_C3_vp,
    static_LIB_3d_vp.f90:593-675): strain = sym grad v; returns
    (eps (E, q, 6), p (E, q))."""
    N, dN, _ = _tables(table, x)
    _, g = jacobians(dN, x)
    L = torch.einsum("ebi,eqbj->eqij", v_new[:, :, :3], g)
    eps = torch.stack([L[..., 0, 0], L[..., 1, 1], L[..., 2, 2],
                       0.5 * (L[..., 0, 1] + L[..., 1, 0]),
                       0.5 * (L[..., 1, 2] + L[..., 2, 1]),
                       0.5 * (L[..., 2, 0] + L[..., 0, 2])], dim=-1)
    p = torch.einsum("eb,qb->eq", v_new[:, :, 3], N)
    return eps, p


def fluid_stress(eps, p, mu):
    """Cauchy stress rows from strain rate and pressure: -p I + 2 mu eps."""
    sig = 2.0 * mu * eps
    sig[..., :3] -= p[..., None]
    return sig


def element_strain(table, coords, conn, vn, mu, chunk: int = CHUNK):
    """The element averages of the gauss strain rate and Cauchy stress,
    (E, 6) each, ``chunk`` elements at a time."""
    E = conn.shape[0]
    strain = coords.new_empty((E, 6))
    stress = coords.new_empty((E, 6))
    for e0 in range(0, E, chunk):
        c = conn[e0:e0 + chunk]
        eps, p = update_c3_vp(table, coords[c], vn[c])
        strain[e0:e0 + chunk] = eps.mean(dim=1)
        stress[e0:e0 + chunk] = fluid_stress(eps, p, mu).mean(dim=1)
    return strain, stress
