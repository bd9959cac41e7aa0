"""High-order quadrature rules for mass integration (copied from
``frontistr_tpu/elements/quadhi.py``; the shape functions and their
derivatives come from the port's ``elements/tables.py``).

The reference's lumped-mass kernels integrate rho N_i N_j with richer rules
than the stiffness rules (collapsed 3x3x3 Gauss for tets, 2x2x2 for hex8;
eigen_LIB_3d1mass.f90 / eigen_LIB_3d2mass.f90) and then apply HRZ diagonal
scaling.  Any rule exact to the integrand's degree gives identical numbers,
so we use classical fully-symmetric rules: deg-4 tri (6pt), deg-5 tet
(15pt), tensor Gauss 3^d for quads/hexes, tri x line for prisms.
"""

from functools import lru_cache

import numpy as np

_G3 = np.sqrt(3.0 / 5.0)
_W3 = np.array([5.0, 8.0, 5.0]) / 9.0


def _line3():
    return np.array([[-_G3], [0.0], [_G3]]), _W3.copy()


def _tri6():  # Dunavant degree-4, 6 points
    a1, a2 = 0.445948490915965, 0.091576213509771
    w1, w2 = 0.223381589678011, 0.109951743655322
    pts = [[a1, a1], [1 - 2 * a1, a1], [a1, 1 - 2 * a1],
           [a2, a2], [1 - 2 * a2, a2], [a2, 1 - 2 * a2]]
    w = np.array([w1, w1, w1, w2, w2, w2]) * 0.5
    return np.asarray(pts), w


def _tet15():  # classical degree-5, 15 points (same constants as gauss3d6)
    a = 0.25
    b1, c1 = 0.091971078052723, 0.724086765841831
    b2, c2 = 0.319793627829630, 0.040619116511110
    d, e = 0.056350832689629, 0.443649167310371
    pts = [[a, a, a],
           [b1, b1, b1], [c1, b1, b1], [b1, c1, b1], [b1, b1, c1],
           [b2, b2, b2], [c2, b2, b2], [b2, c2, b2], [b2, b2, c2],
           [d, d, e], [e, d, d], [e, e, d], [d, e, e], [d, e, d],
           [e, d, e]]
    w = np.array([0.019753086419753] + [0.011989513963170] * 4
                 + [0.011511367871045] * 4 + [0.008818342151675] * 6)
    return np.asarray(pts), w


def _quad9():
    g = np.array([-_G3, 0.0, _G3])
    pts, ws = [], []
    for j in range(3):
        for i in range(3):
            pts.append([g[i], g[j]])
            ws.append(_W3[i] * _W3[j])
    return np.asarray(pts), np.asarray(ws)


def _hex27():
    g = np.array([-_G3, 0.0, _G3])
    pts, ws = [], []
    for k in range(3):
        for j in range(3):
            for i in range(3):
                pts.append([g[i], g[j], g[k]])
                ws.append(_W3[i] * _W3[j] * _W3[k])
    return np.asarray(pts), np.asarray(ws)


def _prism18():
    tp, tw = _tri6()
    lp, lw = _line3()
    pts, ws = [], []
    for k in range(3):
        for t in range(6):
            pts.append([tp[t, 0], tp[t, 1], lp[k, 0]])
            ws.append(tw[t] * lw[k])
    return np.asarray(pts), np.asarray(ws)


def _tet_collapsed(ng: int):
    """The reference's degenerate-hex tet rule (MASS_C3D4 NG=2 /
    MASS_C3D10 NG=3, eigen_LIB_3d*mass.f90): X3=(x3+1)/2,
    X2=(1-X3)(x2+1)/2, X1=(1-X2-X3)(x1+1)/2, w *= (1-X3)(1-X2-X3)/8.
    NOT exact for the integrand — replicated verbatim because the HRZ
    masses (and thus dynamics goldens) inherit its quadrature error.
    Returned points are my natural coords (xi,eta,zeta) = (L2,L3,L4)."""
    if ng == 2:
        g = np.array([-1.0, 1.0]) / np.sqrt(3.0)
        w1 = np.array([1.0, 1.0])
    else:
        g = np.array([-_G3, 0.0, _G3])
        w1 = _W3
    pts, ws = [], []
    for k3 in range(ng):
        X3 = (g[k3] + 1.0) * 0.5
        for k2 in range(ng):
            X2 = (1.0 - X3) * (g[k2] + 1.0) * 0.5
            for k1 in range(ng):
                X1 = (1.0 - X2 - X3) * (g[k1] + 1.0) * 0.5
                L4 = 1.0 - X1 - X2 - X3
                # volume coords (L1..L4) = (X1..X4); node1<->L1.
                # my natural coords: (xi,eta,zeta) = (L2,L3,L4)
                pts.append([X2, X3, L4])
                ws.append(w1[k1] * w1[k2] * w1[k3] *
                          (1.0 - X3) * (1.0 - X2 - X3) * 0.125)
    return np.asarray(pts), np.asarray(ws)


_FAMILY = {
    231: _tri6, 232: _tri6, 241: _quad9, 242: _quad9,
    341: (lambda: _tet_collapsed(2)), 342: (lambda: _tet_collapsed(3)),
    351: _prism18, 352: _prism18,
    361: _hex27, 362: _hex27,
    111: _line3, 112: _line3,
}


@lru_cache(maxsize=None)
def mass_tables(etype: int):
    """Returns (N (nq, nn), dN (nq, nn, dim), w (nq,)) for mass integrals."""
    from frontistr_tpu_torch.elements.tables import shape_deriv, shape_func
    pts, w = _FAMILY[etype]()
    N = np.stack([shape_func(etype, p) for p in pts])
    dN = np.stack([shape_deriv(etype, p) for p in pts])
    return N, dN, np.asarray(w)
