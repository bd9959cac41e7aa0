"""Element shape-function / quadrature registry (torch port of
``frontistr_tpu/elements/tables.py``).

Every element type is described by static dense tables evaluated once,
on the host in float64:

    N      (nq, nn)      shape functions at every quadrature point
    dN     (nq, nn, dim) natural derivatives at every quadrature point
    w      (nq,)         quadrature weights

Shape functions, node orderings and quadrature rules are the reference's
(fistr1/src/lib/element/*.f90, quadrature.f90), exactly as in the JAX
package.  Natural derivatives come from autodiff of the shape functions
(``torch.autograd.functional.jacobian``), as the JAX package takes them
with ``jax.jacfwd``; ``tests/test_torch_elements.py`` holds every table
to the JAX one.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

# Gauss abscissae used by the reference (quadrature.f90:47-121)
_G2 = 0.577350269189626  # 1/sqrt(3)
_G3 = 0.774596669241483  # sqrt(3/5)
_W3 = (5.0 / 9.0, 8.0 / 9.0, 5.0 / 9.0)

# ---------------------------------------------------------------------------
# Shape functions (FSTR node ordering).  xi is a length-`dim` tensor.
# ---------------------------------------------------------------------------


def _sf_tri3(xi):
    # tri3n.f90: func(1:2)=areacoord, func(3)=1-xi-eta (the reference's
    # nodal-stress extrapolation inherits this ordering quirk)
    x, e = xi.unbind()
    return torch.stack([x, e, 1.0 - x - e])


def _sf_tri6(xi):
    x, e = xi.unbind()
    s = 1.0 - x - e
    return torch.stack([
        s * (2.0 * s - 1.0),
        x * (2.0 * x - 1.0),
        e * (2.0 * e - 1.0),
        4.0 * x * s,
        4.0 * x * e,
        4.0 * e * s,
    ])


def _sf_quad4(xi):
    r, s = xi.unbind()
    return 0.25 * torch.stack([
        (1 - r) * (1 - s), (1 + r) * (1 - s),
        (1 + r) * (1 + s), (1 - r) * (1 + s),
    ])


def _sf_quad8(xi):
    r, s = xi.unbind()
    rp, rm, sp, sm = 1 + r, 1 - r, 1 + s, 1 - s
    return torch.stack([
        0.25 * rm * sm * (-1.0 - r - s),
        0.25 * rp * sm * (-1.0 + r - s),
        0.25 * rp * sp * (-1.0 + r + s),
        0.25 * rm * sp * (-1.0 - r + s),
        0.5 * (1 - r * r) * sm,
        0.5 * (1 - s * s) * rp,
        0.5 * (1 - r * r) * sp,
        0.5 * (1 - s * s) * rm,
    ])


def _sf_tet4(xi):
    x, e, z = xi.unbind()
    return torch.stack([1.0 - x - e - z, x, e, z])


def _sf_tet10(xi):
    x, e, z = xi.unbind()
    a = 1.0 - x - e - z
    return torch.stack([
        (2 * a - 1) * a,
        x * (2 * x - 1),
        e * (2 * e - 1),
        z * (2 * z - 1),
        4 * x * a,
        4 * x * e,
        4 * e * a,
        4 * z * a,
        4 * x * z,
        4 * e * z,
    ])


def _sf_prism6(xi):
    x, e, z = xi.unbind()
    a = 1.0 - x - e
    return 0.5 * torch.stack([
        a * (1 - z), x * (1 - z), e * (1 - z),
        a * (1 + z), x * (1 + z), e * (1 + z),
    ])


def _sf_prism15(xi):
    x, e, z = xi.unbind()
    a = 1.0 - x - e
    return torch.stack([
        0.5 * a * (1 - z) * (2 * a - 2 - z),
        0.5 * x * (1 - z) * (2 * x - 2 - z),
        0.5 * e * (1 - z) * (2 * e - 2 - z),
        0.5 * a * (1 + z) * (2 * a - 2 + z),
        0.5 * x * (1 + z) * (2 * x - 2 + z),
        0.5 * e * (1 + z) * (2 * e - 2 + z),
        2 * x * a * (1 - z),
        2 * x * e * (1 - z),
        2 * e * a * (1 - z),
        2 * x * a * (1 + z),
        2 * x * e * (1 + z),
        2 * e * a * (1 + z),
        a * (1 - z * z),
        x * (1 - z * z),
        e * (1 - z * z),
    ])


def _sf_hex8(xi):
    r, s, t = xi.unbind()
    return 0.125 * torch.stack([
        (1 - r) * (1 - s) * (1 - t), (1 + r) * (1 - s) * (1 - t),
        (1 + r) * (1 + s) * (1 - t), (1 - r) * (1 + s) * (1 - t),
        (1 - r) * (1 - s) * (1 + t), (1 + r) * (1 - s) * (1 + t),
        (1 + r) * (1 + s) * (1 + t), (1 - r) * (1 + s) * (1 + t),
    ])


def _sf_hex20(xi):
    r, s, t = xi.unbind()
    rp, sp, tp = 1 + r, 1 + s, 1 + t
    rm, sm, tm = 1 - r, 1 - s, 1 - t
    return torch.stack([
        -0.125 * rm * sm * tm * (2 + r + s + t),
        -0.125 * rp * sm * tm * (2 - r + s + t),
        -0.125 * rp * sp * tm * (2 - r - s + t),
        -0.125 * rm * sp * tm * (2 + r - s + t),
        -0.125 * rm * sm * tp * (2 + r + s - t),
        -0.125 * rp * sm * tp * (2 - r + s - t),
        -0.125 * rp * sp * tp * (2 - r - s - t),
        -0.125 * rm * sp * tp * (2 + r - s - t),
        0.25 * (1 - r * r) * sm * tm,
        0.25 * rp * (1 - s * s) * tm,
        0.25 * (1 - r * r) * sp * tm,
        0.25 * rm * (1 - s * s) * tm,
        0.25 * (1 - r * r) * sm * tp,
        0.25 * rp * (1 - s * s) * tp,
        0.25 * (1 - r * r) * sp * tp,
        0.25 * rm * (1 - s * s) * tp,
        0.25 * rm * sm * (1 - t * t),
        0.25 * rp * sm * (1 - t * t),
        0.25 * rp * sp * (1 - t * t),
        0.25 * rm * sp * (1 - t * t),
    ])


def _sf_line2(xi):
    (r,) = xi.unbind()
    return torch.stack([0.5 * (1 - r), 0.5 * (1 + r)])


def _sf_line3(xi):
    (r,) = xi.unbind()
    return torch.stack([-0.5 * r * (1 - r), 0.5 * r * (1 + r), (1 - r * r)])


# ---------------------------------------------------------------------------
# Quadrature rules (reference quadrature.f90 data tables, exact ordering)
# ---------------------------------------------------------------------------


def _qp_tri1():
    return np.array([[1 / 3, 1 / 3]]), np.array([0.5])


def _qp_tri3():
    p = np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]])
    return p, np.full(3, 1 / 6)


def _qp_quad4():
    g = _G2
    p = np.array([[-g, -g], [g, -g], [-g, g], [g, g]])
    return p, np.ones(4)


def _qp_quad9():
    g = np.array([-_G3, 0.0, _G3])
    pts, ws = [], []
    for j in range(3):
        for i in range(3):
            pts.append([g[i], g[j]])
            ws.append(_W3[i] * _W3[j])
    return np.array(pts), np.array(ws)


def _qp_tet1():
    return np.array([[0.25, 0.25, 0.25]]), np.array([1 / 6])


def _qp_tet4():
    a, b = 0.138196601125011, 0.585410196624968
    p = np.array([[a, a, a], [b, a, a], [a, b, a], [a, a, b]])
    return p, np.full(4, 0.041666666666667)


def _qp_prism2():
    g = _G2
    p = np.array([[1 / 3, 1 / 3, -g], [1 / 3, 1 / 3, g]])
    return p, np.full(2, 0.5)


def _qp_prism9():
    tri = [[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]]
    zs = [-_G3, 0.0, _G3]
    pts, ws = [], []
    for k in range(3):
        for t in range(3):
            pts.append([tri[t][0], tri[t][1], zs[k]])
            ws.append((1 / 6) * _W3[k])
    return np.array(pts), np.array(ws)


def _qp_hex8():
    g = _G2
    pts = []
    for k in (-g, g):
        for j in (-g, g):
            for i in (-g, g):
                pts.append([i, j, k])
    return np.array(pts), np.ones(8)


def _qp_hex27():
    g = np.array([-_G3, 0.0, _G3])
    pts, ws = [], []
    for k in range(3):
        for j in range(3):
            for i in range(3):
                pts.append([g[i], g[j], g[k]])
                ws.append(_W3[i] * _W3[j] * _W3[k])
    return np.array(pts), np.array(ws)


def _qp_line1():
    return np.array([[0.0]]), np.array([2.0])


def _qp_line2():
    return np.array([[-_G2], [_G2]]), np.array([1.0, 1.0])


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

# etype -> (dim, nn, shape fn, quadrature fn)
ETYPE_INFO = {
    111: (1, 2, _sf_line2, _qp_line2),
    112: (1, 3, _sf_line3, _qp_line2),
    231: (2, 3, _sf_tri3, _qp_tri1),
    232: (2, 6, _sf_tri6, _qp_tri3),
    241: (2, 4, _sf_quad4, _qp_quad4),
    242: (2, 8, _sf_quad8, _qp_quad9),
    301: (1, 2, _sf_line2, _qp_line1),
    341: (3, 4, _sf_tet4, _qp_tet1),
    3414: (3, 4, _sf_tet4, _qp_tet4),
    342: (3, 10, _sf_tet10, _qp_tet4),
    351: (3, 6, _sf_prism6, _qp_prism2),
    352: (3, 15, _sf_prism15, _qp_prism9),
    361: (3, 8, _sf_hex8, _qp_hex8),
    362: (3, 20, _sf_hex20, _qp_hex27),
}

# HEC-MW -> FSTR node reordering (hecmw2fstr_connect_conv.c:18-20); identity
# for all other types.  fstr_conn[k] = hecmw_conn[TABLE[k]-1]
HECMW2FSTR_ORDER = {
    232: [1, 2, 3, 6, 4, 5],
    342: [1, 2, 3, 4, 7, 5, 6, 8, 9, 10],
    352: [1, 2, 3, 4, 5, 6, 9, 7, 8, 12, 10, 11, 13, 14, 15],
}


@dataclasses.dataclass(frozen=True)
class ElementTable:
    """Static per-etype integration tables (numpy float64)."""

    etype: int
    dim: int
    nn: int
    nq: int
    points: np.ndarray   # (nq, dim)
    weights: np.ndarray  # (nq,)
    N: np.ndarray        # (nq, nn)
    dN: np.ndarray       # (nq, nn, dim)


def shape_func(etype: int, xi) -> np.ndarray:
    """Shape function values (nn,) at one natural point, float64."""
    _, _, sf, _ = ETYPE_INFO[etype]
    return sf(torch.as_tensor(np.asarray(xi, np.float64))).numpy()


def shape_deriv(etype: int, xi) -> np.ndarray:
    """Natural derivatives (nn, dim) at one natural point, float64.
    (Not ``torch.func.jacfwd``: for some element types, hex8 among them,
    its first call imports ``torch._dynamo``, seconds of host time.)"""
    _, _, sf, _ = ETYPE_INFO[etype]
    x = torch.as_tensor(np.asarray(xi, np.float64))
    return torch.autograd.functional.jacobian(sf, x).numpy()


@lru_cache(maxsize=None)
def get_table(etype: int) -> ElementTable:
    if etype not in ETYPE_INFO:
        raise KeyError(f"unsupported element type {etype}")
    dim, nn, _, qp = ETYPE_INFO[etype]
    pts, wts = qp()
    N = np.stack([shape_func(etype, p) for p in pts])
    dN = np.stack([shape_deriv(etype, p) for p in pts])
    return ElementTable(etype, dim, nn, len(wts), pts, np.asarray(wts), N, dN)
