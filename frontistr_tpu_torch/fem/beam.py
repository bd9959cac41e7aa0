"""Beam elements 611 (2 nodes, 6 dofs a node) and 641 (the same beam
packed as four 3-dof nodes) (torch port of ``frontistr_tpu/fem/beam.py``;
reference fistr1/src/lib/static_LIB_beam.f90).

The 12 x 12 Euler-Bernoulli beam with torsion in a local frame built
from the section's reference vector (framtr:18-57), batched over
elements.  The section (!SECTION, TYPE=BEAM data line) is seven values,
(vx, vy, vz, area, Iyy, Izz, Jx): the reference vector, then the
section constants.  A 641 element's nodes 1 and 2 carry the
translations and nodes 3 and 4 the rotations of nodes 1 and 2
(STF_Beam_641:156-420), so a beam can live in a 3-dof solid system.
"""

from __future__ import annotations

import numpy as np
import torch

# 611 dof order [u1, th1, u2, th2] -> 641 order [u1, u2, th1, th2]
_P641 = np.array([0, 1, 2, 6, 7, 8, 3, 4, 5, 9, 10, 11])

# the section of a beam block without seven !SECTION values
DEFAULT_SECTION = (0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0)


def _frame(x, refv):
    """Length and local frame per element (framtr): rows (t1 axial, t2,
    t3); x (E, 2, 3)."""
    d = x[:, 1, :] - x[:, 0, :]
    le = torch.linalg.vector_norm(d, dim=-1)
    t1 = d / le[:, None]
    r = torch.as_tensor(np.asarray(refv, np.float64), dtype=x.dtype,
                        device=x.device).expand_as(t1)
    t2 = torch.linalg.cross(r, t1, dim=-1)
    t2 = t2 / torch.linalg.vector_norm(t2, dim=-1, keepdim=True)
    t3 = torch.linalg.cross(t1, t2, dim=-1)
    return le, torch.stack([t1, t2, t3], 1)


def _local_k(le, ee, pp, a, iy, iz, jx):
    """(E, 12, 12) local beam stiffness (STF_Beam:85-141)."""
    g = ee / (2.0 * (1.0 + pp))
    L2, L3 = le * le, le * le * le
    ea = ee * a / le
    twoe, foure = 2.0 * ee / le, 4.0 * ee / le
    twelvee, sixe = 12.0 * ee / L3, 6.0 * ee / L2
    gj = g * jx / le
    k = le.new_zeros((le.shape[0], 12, 12))

    def s(i, j, v):
        k[:, i - 1, j - 1] = v
        k[:, j - 1, i - 1] = v
    s(1, 1, ea); s(7, 1, -ea); s(7, 7, ea)
    s(2, 2, twelvee * iz); s(6, 2, sixe * iz)
    s(8, 2, -twelvee * iz); s(12, 2, sixe * iz)
    s(3, 3, twelvee * iy); s(5, 3, -sixe * iy)
    s(9, 3, -twelvee * iy); s(11, 3, -sixe * iy)
    s(4, 4, gj); s(10, 4, -gj); s(10, 10, gj)
    s(5, 5, foure * iy); s(9, 5, sixe * iy); s(11, 5, twoe * iy)
    s(6, 6, foure * iz); s(8, 6, -sixe * iz); s(12, 6, twoe * iz)
    s(8, 8, twelvee * iz); s(12, 8, -sixe * iz)
    s(9, 9, twelvee * iy); s(11, 9, sixe * iy)
    s(11, 11, foure * iy)
    s(12, 12, foure * iz)
    return k


def check_reference(coords, conn, section) -> None:
    """The "Bad reference vector" check of the JAX package's
    ``compute_element_stiffness``: the section's reference vector must not
    be parallel to any element's axis (host numpy)."""
    ax = coords[conn[:, 1]] - coords[conn[:, 0]]
    ax = ax / np.linalg.norm(ax, axis=1, keepdims=True)
    if (np.linalg.norm(np.cross(np.asarray(section[:3], float), ax),
                       axis=1) < 1e-8).any():
        raise ValueError(
            "Bad reference vector for beam element (parallel to "
            "the beam axis) -- check !SECTION TYPE=BEAM")


def stiffness_beam(coords, section, ee, pp, etype=611):
    """coords (E, nn, 3) (nn = 2 for 611, 4 for 641; the first two carry
    the geometry), section the seven values -> (E, 12, 12) global
    stiffness, in 641's dof order for 641."""
    le, t = _frame(coords[:, :2, :], section[0:3])
    k = _local_k(le, ee, pp, *(float(v) for v in section[3:7]))
    # T^T k T with T block-diagonal, four blocks of t
    kr = k.reshape(-1, 4, 3, 4, 3)
    kg = torch.einsum("eji,eajbk,ekl->eaibl", t, kr, t).reshape(-1, 12, 12)
    if etype == 641:
        P = torch.as_tensor(_P641, device=kg.device)
        kg = kg[:, P[:, None], P[None, :]]
    return kg


def nqm_beam_641(coords, section, ee, disp_e, radius=0.0, angles=None,
                 thermal=0.0):
    """Fiber strain and stress at six angular section positions of 641
    beams (NodalStress_Beam_641 / ElementalStress_Beam_641,
    static_LIB_beam.f90:646-980).

    disp_e (E, 4, 3): nodal values in the 641 packing; radius and angles
    (degrees) from the extended !MATERIAL ELASTIC row (radius 0: the
    axial fiber).  Returns numpy (nd_strain (E, 4, 6), nd_stress
    (E, 4, 6), el_strain (E, 6), el_stress (E, 6)): component k is fiber
    k, zero on the rotation rows."""
    ang = np.deg2rad(np.asarray(np.zeros(6) if angles is None else angles,
                                float))
    like = coords
    x2h = torch.as_tensor(radius * np.cos(ang), dtype=like.dtype,
                          device=like.device)
    x3h = torch.as_tensor(radius * np.sin(ang), dtype=like.dtype,
                          device=like.device)
    le, T = _frame(coords[:, :2, :], section[:3])
    l2 = le * le
    l3 = l2 * le
    dh = torch.einsum("eij,enj->eni", T, disp_e)    # local frame (E, 4, 3)
    du_ax = (dh[:, 1, 0] - dh[:, 0, 0]) / le         # axial strain

    def fiber_stress(x1h):
        # Hermite curvature terms (static_LIB_beam.f90:824-838)
        c1 = -6.0 / l2 + 12.0 * x1h / l3
        c2 = -4.0 / le + 6.0 * x1h / l2
        c3 = 6.0 / l2 - 12.0 * x1h / l3
        c4 = -2.0 / le + 6.0 * x1h / l2
        bend2 = (c1 * dh[:, 0, 1] + c2 * dh[:, 2, 2]
                 + c3 * dh[:, 1, 1] + c4 * dh[:, 3, 2])
        bend3 = (c1 * dh[:, 0, 2] - c2 * dh[:, 2, 1]
                 + c3 * dh[:, 1, 2] - c4 * dh[:, 3, 1])
        return ee * (du_ax[:, None] - x2h[None, :] * bend2[:, None]
                     - x3h[None, :] * bend3[:, None]) - ee * thermal

    E = coords.shape[0]
    eps = du_ax[:, None].expand(E, 6)
    nd_strain = le.new_zeros((E, 4, 6))
    nd_stress = le.new_zeros((E, 4, 6))
    nd_strain[:, 0] = nd_strain[:, 1] = eps
    nd_stress[:, 0] = fiber_stress(torch.zeros_like(le))
    nd_stress[:, 1] = fiber_stress(le)
    return (nd_strain.cpu().numpy(), nd_stress.cpu().numpy(),
            eps.cpu().numpy(), fiber_stress(0.5 * le).cpu().numpy())
