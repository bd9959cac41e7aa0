"""MITC shell elements 731 (MITC3), 741 (MITC4) and 743 (MITC9), and the
solid-shell packing 761/781 (torch port of ``frontistr_tpu/fem/shell.py``;
reference fistr1/src/lib/static_LIB_shell.f90 STF_Shell_MITC:49-1305,
ElementStress_Shell_MITC:1310-2328, DL_Shell:2333-3005).

Every element-level loop is a batched product over the element axis E;
the small loops over tying points, in-plane gauss points and the
two-point thickness rule stay Python loops.  The conventions of the
JAX package, which follow the reference:

  - per-element nodal directors: v3 = normalized g1 x g2 at each node's
    natural coordinates, v2 = v3 x e0 (e0 = g1 at the element centre),
    v1 = v2 x v3 (static_LIB_shell.f90:345-460), not averaged across
    elements;
  - the 5-row covariant strain vector (E_xx, E_ee, 2E_xe, 2E_ez, 2E_zx)
    with MITC tying of the transverse-shear rows at zeta = 0 (MITC3/4)
    or of all five rows at the current layer (MITC9, three tying
    families);
  - the plane-stress constitutive tensor in the local orthonormal frame
    (shear correction 5/6) pushed to covariant components;
  - drilling stabilisation K += alpha Cv Cv^T, alpha = 1e-3 mu;
  - two-point gauss through the thickness, 2x2 (741), 3x3 (743) or the
    3-point triangle rule (731) in-plane;
  - nodal stresses at zeta = +1 and -1, averaged, in global components
    (shear strains as tensor components).
"""

from __future__ import annotations

import numpy as np
import torch

SQ3I = 1.0 / np.sqrt(3.0)

# covariant Voigt row -> tensor index pairs, order (11, 22, 12, 23, 31)
# (mat_c2d_Shell, calMatMatrix.f90:296-320)
_VI = np.array([0, 1, 0, 1, 2])
_VJ = np.array([0, 1, 1, 2, 0])

# MITC9 node order: corners (-,-),(+,-),(+,+),(-,+), edges (0,-),(+,0),
# (0,+),(-,0), centre (fe_mitc9_shell)
_Q9 = [(0, 0), (1, 0), (1, 1), (0, 1), (2, 0), (1, 2), (2, 1), (0, 2),
       (2, 2)]


def _quad4_N(p):
    x, e = p
    return np.array([(1 - x) * (1 - e), (1 + x) * (1 - e),
                     (1 + x) * (1 + e), (1 - x) * (1 + e)]) * 0.25


def _quad4_dN(p):
    x, e = p
    return np.array([[-(1 - e), -(1 - x)], [1 - e, -(1 + x)],
                     [1 + e, 1 + x], [-(1 + e), 1 - x]]) * 0.25


def _lagrange3(x):
    return (np.array([0.5 * x * (x - 1), 0.5 * x * (x + 1), 1 - x * x]),
            np.array([x - 0.5, x + 0.5, -2 * x]))


def _quad9_N(p):
    (lx, _), (le, _) = _lagrange3(p[0]), _lagrange3(p[1])
    return np.array([lx[i] * le[j] for i, j in _Q9])


def _quad9_dN(p):
    (lx, dlx), (le, dle) = _lagrange3(p[0]), _lagrange3(p[1])
    return np.array([[dlx[i] * le[j], lx[i] * dle[j]] for i, j in _Q9])


def _tri3_N(p):
    x, e = p
    return np.array([x, e, 1.0 - x - e])


def _tri3_dN(p):
    return np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, -1.0]])


class ShellTable:
    """Nodal coordinates, in-plane gauss rule and tying points of one
    shell type (numpy)."""

    def __init__(self, etype):
        self.etype = etype
        if etype == 741:
            self.nn = 4
            self.nodal = np.array([[-1., -1.], [1., -1.], [1., 1.],
                                   [-1., 1.]])
            g = SQ3I
            self.gauss = np.array([[-g, -g], [g, -g], [-g, g], [g, g]])
            self.gw = np.ones(4)
            # tying points: the edge midpoints
            self.tying = np.array([[0., -1.], [1., 0.], [0., 1.],
                                   [-1., 0.]])
            self.N, self.dN = _quad4_N, _quad4_dN
        elif etype == 731:
            self.nn = 3
            self.nodal = np.array([[1., 0.], [0., 1.], [0., 0.]])
            a, b = 1.0 / 6.0, 2.0 / 3.0
            self.gauss = np.array([[a, a], [b, a], [a, b]])
            self.gw = np.full(3, 1.0 / 6.0)
            self.tying = np.array([[0.5, 0.], [0., 0.5], [0.5, 0.5]])
            self.N, self.dN = _tri3_N, _tri3_dN
        elif etype == 743:
            # 9-node Lagrange, 3x3 gauss, three tying families over all
            # five strain rows (static_LIB_shell.f90:145-262)
            self.nn = 9
            self.nodal = np.array(
                [[-1., -1.], [1., -1.], [1., 1.], [-1., 1.],
                 [0., -1.], [1., 0.], [0., 1.], [-1., 0.], [0., 0.]])
            g = np.sqrt(0.6)
            pts, wts = [-g, 0.0, g], [5. / 9., 8. / 9., 5. / 9.]
            self.gauss = np.array([[a, b] for b in pts for a in pts])
            self.gw = np.array([wa * wb for wb in wts for wa in wts])
            s3, s35 = SQ3I, np.sqrt(0.6)
            # family 1: rows (e11, e13); 2: (e22, e23); 3: (e12)
            self.ty1 = np.array([[-s3, -s35], [s3, -s35], [s3, s35],
                                 [-s3, s35], [s3, 0.], [-s3, 0.]])
            self.ty2 = np.array([[-s35, -s3], [0., -s3], [s35, -s3],
                                 [s35, s3], [0., s3], [-s35, s3]])
            self.ty3 = np.array([[-s3, -s3], [s3, -s3], [s3, s3],
                                 [-s3, s3]])
            self.tying = self.ty1
            self.N, self.dN = _quad9_N, _quad9_dN
        else:
            raise ValueError(f"unsupported shell etype {etype}")

    def mitc9_h(self, p):
        """(h1 (6,), h2 (6,), h3 (4,)): the tying interpolations at p
        (static_LIB_shell.f90:915-956)."""
        x, e = p
        s3, s35 = SQ3I, np.sqrt(0.6)
        xi1 = np.array([-1., 1., 1., -1., 1., -1.])
        et1 = np.array([-1., -1., 1., 1., 0., 0.])
        xh, eh = x / s3, e / s35
        h1 = (0.5 * (1 + xi1 * xh)
              * (0.5 * et1 * eh * (1 + et1 * eh)
                 + (1 - et1 * et1) * (1 - eh * eh)))
        xi2 = np.array([-1., 0., 1., 1., 0., -1.])
        et2 = np.array([-1., -1., -1., 1., 1., 1.])
        xh, eh = x / s35, e / s3
        h2 = ((0.5 * xi2 * xh * (1 + xi2 * xh)
               + (1 - xi2 * xi2) * (1 - xh * xh))
              * 0.5 * (1 + et2 * eh))
        xi3 = np.array([-1., 1., 1., -1.])
        et3 = np.array([-1., -1., 1., 1.])
        xh, eh = x / s3, e / s3
        h3 = 0.25 * (1 + xi3 * xh) * (1 + et3 * eh)
        return h1, h2, h3

    def tying_coeffs(self, p):
        """(c44, c45, c54, c55), each (ntying,): rows 4 and 5 of the
        assumed-strain B as combinations of rows 4 and 5 at the tying
        points (MITC3 coefficients for any type but 741, as in the JAX
        package)."""
        x, e = p
        if self.etype == 741:
            return (np.array([0., 0.5 * (1 + x), 0., 0.5 * (1 - x)]),
                    np.zeros(4), np.zeros(4),
                    np.array([0.5 * (1 - e), 0., 0.5 * (1 + e), 0.]))
        return (np.array([0., 1 - x, x]), np.array([x, 0., -x]),
                np.array([0., e, -e]), np.array([1 - e, 0., e]))


_TABLES: dict = {}


def shell_table(etype) -> ShellTable:
    if etype not in _TABLES:
        _TABLES[etype] = ShellTable(etype)
    return _TABLES[etype]


def _t(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64), dtype=like.dtype,
                           device=like.device)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _unit(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


# ------------------------------------------------------------- geometry

def directors(elem, table):
    """Per-node director triads (static_LIB_shell.f90:345-460): elem
    (E, nn, 3) -> v1, v2, v3, each (E, nn, 3)."""
    dN0 = _t(table.dN(np.zeros(2)), elem)
    e0 = torch.einsum("n,enj->ej", dN0[:, 0], elem)      # g1 at the centre
    v1l, v2l, v3l = [], [], []
    for nb in range(table.nn):
        dNn = _t(table.dN(table.nodal[nb]), elem)
        g1 = torch.einsum("n,enj->ej", dNn[:, 0], elem)
        g2 = torch.einsum("n,enj->ej", dNn[:, 1], elem)
        v3 = _unit(_cross(g1, g2))
        v2 = _unit(_cross(v3, e0))
        v1 = _unit(_cross(v2, v3))
        v3 = _unit(_cross(v1, v2))
        v1l.append(v1)
        v2l.append(v2)
        v3l.append(v3)
    return (torch.stack(v1l, 1), torch.stack(v2l, 1), torch.stack(v3l, 1))


def _basis(elem, s, N, dN, zeta):
    """Covariant basis g1, g2, g3 at (xi, eta, zeta); s = (t/2) v3 per
    node; N, dN tensors."""
    g1 = torch.einsum("n,enj->ej", dN[:, 0], elem + zeta * s)
    g2 = torch.einsum("n,enj->ej", dN[:, 1], elem + zeta * s)
    g3 = torch.einsum("n,enj->ej", N, s)
    return g1, g2, g3


def _bmat(elem, s, N, dN, zeta):
    """Covariant strain-displacement matrix (E, 5, nn*6) and g1, g2, g3.
    Rows (E_xx, E_ee, 2E_xe, 2E_ez, 2E_zx); columns per node
    (ux, uy, uz, tx, ty, tz) (static_LIB_shell.f90:548-634)."""
    E, nn, _ = elem.shape
    N, dN = _t(N, elem), _t(dN, elem)
    g1, g2, g3 = _basis(elem, s, N, dN, zeta)
    d1, d2 = dN[None, :, 0, None], dN[None, :, 1, None]
    r1 = d1 * (zeta * s)                   # du/dxi from theta
    r2 = d2 * (zeta * s)
    r3 = N[None, :, None] * s              # du/dzeta from theta
    G1, G2, G3 = g1[:, None, :], g2[:, None, :], g3[:, None, :]
    trans = torch.stack([d1 * G1, d2 * G2, d1 * G2 + d2 * G1, d2 * G3,
                         d1 * G3], 1)                      # (E, 5, nn, 3)
    aa1, aa2, aa3 = _cross(r1, G1), _cross(r1, G2), _cross(r1, G3)
    bb1, bb2, bb3 = _cross(r2, G1), _cross(r2, G2), _cross(r2, G3)
    cc1, cc2 = _cross(r3, G1), _cross(r3, G2)
    rot = torch.stack([aa1, bb2, aa2 + bb1, bb3 + cc2, aa3 + cc1], 1)
    B = torch.cat([trans, rot], dim=-1)                    # (E, 5, nn, 6)
    return B.reshape(E, 5, nn * 6), g1, g2, g3


def _chat(ee, pp):
    """Local plane-stress constitutive tensor with the 5/6 shear
    correction (ElasticLinear.f90:227-262), numpy (3, 3, 3, 3)."""
    l1 = ee / (1.0 - pp * pp)
    l2 = pp * l1
    mu = 0.5 * ee / (1.0 + pp)
    k = 5.0 / 6.0
    c = np.zeros((3, 3, 3, 3))
    c[0, 0, 0, 0] = c[1, 1, 1, 1] = l1
    c[0, 0, 1, 1] = c[1, 1, 0, 0] = l2
    for (i, j) in ((0, 1), (1, 0)):
        c[i, j, 0, 1] = c[i, j, 1, 0] = mu
    for (i, j) in ((0, 2), (2, 0)):
        c[i, j, 0, 2] = c[i, j, 2, 0] = k * mu
    for (i, j) in ((1, 2), (2, 1)):
        c[i, j, 1, 2] = c[i, j, 2, 1] = k * mu
    return c


def _contravariant(g1, g2, g3):
    """The contravariant basis in closed form and det [g1 g2 g3]."""
    c23, c31, c12 = _cross(g2, g3), _cross(g3, g1), _cross(g1, g2)
    det = (g1 * c23).sum(-1)
    return c23 / det[:, None], c31 / det[:, None], c12 / det[:, None], det


def _dmat(chat, g1, g2, g3, cg1, cg2, cg3):
    """5 x 5 covariant-frame D: the local tensor pushed through
    e_hat . cg."""
    e3 = _unit(g3)
    e1 = _unit(_cross(g2, e3))
    e2 = _unit(_cross(e3, e1))
    eh = torch.stack([e1, e2, e3], 1)                  # rows e_a
    cg = torch.stack([cg1, cg2, cg3], 1)               # rows cg_i
    R = torch.einsum("eak,eik->eai", eh, cg)           # e_a . cg_i
    c = torch.einsum("abcd,eai->eibcd", _t(chat, g1), R)
    c = torch.einsum("eibcd,ebj->eijcd", c, R)
    c = torch.einsum("eijcd,eck->eijkd", c, R)
    c = torch.einsum("eijkd,edl->eijkl", c, R)
    vi = torch.as_tensor(_VI, device=c.device)
    vj = torch.as_tensor(_VJ, device=c.device)
    return c[:, vi[:, None], vj[:, None], vi[None, :], vj[None, :]]


def _tied_rows(elem, s, table):
    """Rows 4 and 5 of B at the tying points at zeta = 0, each
    (E, ntying, nn*6)."""
    Bt = [_bmat(elem, s, table.N(p), table.dN(p), 0.0)[0]
          for p in table.tying]
    return (torch.stack([b[:, 3] for b in Bt], 1),
            torch.stack([b[:, 4] for b in Bt], 1))


def _mitc34_rows(B, Bt4, Bt5, table, p):
    """B with rows 4 and 5 replaced by the MITC3/4 assumed strains."""
    c44, c45, c54, c55 = (_t(c, B) for c in table.tying_coeffs(p))
    row4 = torch.einsum("t,etj->ej", c44, Bt4) + \
        torch.einsum("t,etj->ej", c45, Bt5)
    row5 = torch.einsum("t,etj->ej", c54, Bt4) + \
        torch.einsum("t,etj->ej", c55, Bt5)
    return torch.cat([B[:, :3], row4[:, None], row5[:, None]], 1)


# ------------------------------------------------------------ stiffness

def stiffness_shell(elem, thick, ee, pp, alpha_over_mu=1.0e-3, etype=741):
    """Batched MITC shell stiffness (E, nn*6, nn*6) in ``elem``'s dtype
    and device."""
    table = shell_table(etype)
    E, nn, _ = elem.shape
    v1, v2, v3 = directors(elem, table)
    s = 0.5 * thick * v3
    chat = _chat(ee, pp)
    alpha = alpha_over_mu * 0.5 * ee / (1.0 + pp)
    mitc9 = etype == 743
    if not mitc9:
        # assumed-strain rows sampled at zeta = 0
        Bt4, Bt5 = _tied_rows(elem, s, table)
    K = elem.new_zeros((E, nn * 6, nn * 6))
    for zeta in (-SQ3I, SQ3I):
        if mitc9:
            # MITC9 ties all five rows at the current layer zeta
            # (static_LIB_shell.f90:473-476)
            Bty = [torch.stack([_bmat(elem, s, table.N(p), table.dN(p),
                                      zeta)[0] for p in tp], 1)
                   for tp in (table.ty1, table.ty2, table.ty3)]
        for q in range(table.gauss.shape[0]):
            p = table.gauss[q]
            w = float(table.gw[q])
            Nq, dNq = table.N(p), table.dN(p)
            B, g1, g2, g3 = _bmat(elem, s, Nq, dNq, zeta)
            if mitc9:
                h1, h2, h3 = (_t(h, elem) for h in table.mitc9_h(p))

                def tie(h, fam, row):
                    return torch.einsum("t,etj->ej", h, Bty[fam][:, :, row])
                B = torch.stack([tie(h1, 0, 0), tie(h2, 1, 1),
                                 tie(h3, 2, 2), tie(h2, 1, 3),
                                 tie(h1, 0, 4)], 1)
            else:
                B = _mitc34_rows(B, Bt4, Bt5, table, p)
            cg1, cg2, cg3, det = _contravariant(g1, g2, g3)
            D = _dmat(chat, g1, g2, g3, cg1, cg2, cg3)
            DB = torch.einsum("ers,esj->erj", D, B)
            K = K + (w * det)[:, None, None] * \
                torch.einsum("eri,erj->eij", B, DB)
            # drilling stabilisation
            Cv = _drill_vector(elem, s, v1, v2, v3, Nq, dNq, zeta,
                               cg1, cg2, cg3)
            K = K + (w * alpha * det)[:, None, None] * \
                Cv[:, :, None] * Cv[:, None, :]
    return K


def _drill_vector(elem, s, v1, v2, v3, Nq, dNq, zeta, cg1, cg2, cg3):
    """Cv = N.theta.v3 - 1/2 v1.(grad u - grad u^T).v2 per dof
    (static_LIB_shell.f90:1040-1214)."""
    E, nn, _ = elem.shape
    Nqj, dNj = _t(Nq, elem), _t(dNq, elem)
    r1 = dNj[None, :, 0, None] * (zeta * s)
    r2 = dNj[None, :, 1, None] * (zeta * s)
    r3 = Nqj[None, :, None] * s
    eye = torch.eye(3, dtype=elem.dtype, device=elem.device)

    def dop(dshape, r):
        """du/d(xi_k) components (E, 3, nn*6): translations through the
        shape derivative, rotations du = theta x r (column theta_d is
        e_d x r)."""
        colr = _cross(eye[None, None, :, :], r[:, :, None, :])  # e,n,d,c
        rot = colr.permute(0, 3, 1, 2)                          # e,c,n,d
        if dshape is None:
            tr = torch.zeros_like(rot)
        else:
            tr = torch.einsum("n,cd->cnd", dshape, eye)[None].expand(
                E, -1, -1, -1)
        return torch.cat([tr, rot], -1).reshape(E, 3, nn * 6)
    Bs = torch.stack([dop(dNj[:, 0], r1), dop(dNj[:, 1], r2),
                      dop(None, r3)], 1)                # (E, k, 3, j)
    cg = torch.stack([cg1, cg2, cg3], 1)                # (E, k, 3)
    G = torch.einsum("eka,ekcj->ecaj", cg, Bs)          # du_c/dx_a
    v1i = torch.einsum("n,enk->ek", Nqj, v1)
    v2i = torch.einsum("n,enk->ek", Nqj, v2)
    v3i = torch.einsum("n,enk->ek", Nqj, v3)
    Cw = torch.einsum("ea,ebaj,eb->ej", v1i, G - G.transpose(1, 2), v2i)
    Ct = torch.cat([torch.zeros((E, nn, 3), dtype=elem.dtype,
                                device=elem.device),
                    Nqj[None, :, None] * v3i[:, None, :]], -1)
    return Ct.reshape(E, nn * 6) - 0.5 * Cw


# ----------------------------------------------------------------- loads

def shell_dload(elem, thick, rho, ltype, params, etype=741):
    """Distributed loads on shells -> (E, nn*6) consistent nodal vectors:
    'P0'/'P' surface pressure along +normal (DL_Shell:2640-2780), 'BX',
    'BY', 'BZ' body force per volume, 'GRAV', 'CENT'
    (DL_Shell:2784-3002)."""
    table = shell_table(etype)
    E, nn, _ = elem.shape
    _, _, v3 = directors(elem, table)
    s = 0.5 * thick * v3
    ft = elem.new_zeros((E, nn, 3))
    fr = elem.new_zeros((E, nn, 3))
    if ltype.startswith("P"):
        val = float(params[0])
        for q in range(table.gauss.shape[0]):
            p = table.gauss[q]
            w = float(table.gw[q])
            Nq, dNq = _t(table.N(p), elem), _t(table.dN(p), elem)
            g1 = torch.einsum("n,enj->ej", dNq[:, 0], elem)
            g2 = torch.einsum("n,enj->ej", dNq[:, 1], elem)
            ft = ft + w * val * Nq[None, :, None] * \
                _cross(g1, g2)[:, None, :]
        return torch.cat([ft, fr], -1).reshape(E, nn * 6)
    if ltype not in ("BX", "BY", "BZ", "GRAV", "CENT"):
        raise ValueError(f"shell dload type {ltype}")
    params = np.asarray(params, np.float64)
    # volume loads: integrated over zeta, with the rotation coupling
    for zeta in (-SQ3I, SQ3I):
        for q in range(table.gauss.shape[0]):
            p = table.gauss[q]
            w = float(table.gw[q])
            Nq, dNq = _t(table.N(p), elem), _t(table.dN(p), elem)
            g1, g2, g3 = _basis(elem, s, Nq, dNq, zeta)
            det = (g1 * _cross(g2, g3)).sum(-1)
            urot = Nq[None, :, None] * (zeta * s)       # (E, nn, 3)
            if ltype in ("BX", "BY", "BZ"):
                coef = elem.new_zeros((E, 3))
                coef[:, {"BX": 0, "BY": 1, "BZ": 2}[ltype]] = params[0]
            elif ltype == "GRAV":
                coef = (rho * params[0] * _t(params[1:4], elem)
                        ).expand(E, 3)
            else:
                a, r = _t(params[1:4], elem), _t(params[4:7], elem)
                x = torch.einsum("n,enj->ej", Nq, elem)
                tt = ((x - a) * r).sum(-1) / float(params[4:7] @
                                                   params[4:7])
                coef = (x - (a + tt[:, None] * r)) * \
                    (rho * params[0] * params[0])
            wdet = (w * det)[:, None, None]
            ft = ft + wdet * Nq[None, :, None] * coef[:, None, :]
            # moment on theta_d: (e_d x urot) . coef = (urot x coef)_d
            fr = fr + wdet * _cross(urot, coef[:, None, :])
    return torch.cat([ft, fr], -1).reshape(E, nn * 6)


def stiffness_solid_shell(elem_lower, thick, ee, pp, etype=781,
                          alpha_over_mu=1.0e-3):
    """761/781 'shell-solid mixed' stiffness: the MITC3/MITC4 shell on
    the lower-face nodes, its dofs re-ordered so the element exposes
    2*nn 3-dof nodes: every node's translations, then every node's
    rotations (the carriers; fstr_StiffMatrix.f90:168-183,
    STF_Shell_MITC:1240-1295)."""
    K = stiffness_shell(elem_lower, thick, ee, pp,
                        alpha_over_mu=alpha_over_mu,
                        etype=731 if etype == 761 else 741)
    nn = 3 if etype == 761 else 4
    node = 6 * torch.arange(nn, device=K.device)[:, None]
    perm = torch.cat([(node + torch.arange(3, device=K.device)).reshape(-1),
                      (node + torch.arange(3, 6, device=K.device))
                      .reshape(-1)])
    return K[:, perm[:, None], perm[None, :]]


# ---------------------------------------------------------------- stress

def _sym(c11, c22, c12, c23, c31):
    """Symmetric (E, 3, 3) tensors from five components, c33 = 0."""
    return torch.stack([torch.stack([c11, c12, c31], -1),
                        torch.stack([c12, c22, c23], -1),
                        torch.stack([c31, c23, torch.zeros_like(c11)], -1)],
                       1)


def shell_nodal_stress(elem, ue, thick, ee, pp, etype=741):
    """Mid-surface (PLUS/MINUS averaged) nodal strain and stress in
    global components (11, 22, 33, 12, 23, 31), shear as tensor
    components: elem (E, nn, 3), ue (E, nn, 6) -> strain, stress, each
    (E, nn, 6).  Rows 4 and 5 take the MITC3/4 tying of the table's
    tying points, as the JAX package's does."""
    table = shell_table(etype)
    E, nn, _ = elem.shape
    _, _, v3 = directors(elem, table)
    s = 0.5 * thick * v3
    chat = _chat(ee, pp)
    u = ue.reshape(E, nn * 6)
    Bt4, Bt5 = _tied_rows(elem, s, table)
    strain = elem.new_zeros((E, nn, 6))
    stress = elem.new_zeros((E, nn, 6))
    for zeta in (1.0, -1.0):
        for ln in range(nn):
            p = table.nodal[ln]
            B, g1, g2, g3 = _bmat(elem, s, table.N(p), table.dN(p), zeta)
            B = _mitc34_rows(B, Bt4, Bt5, table, p)
            Ev = torch.einsum("erj,ej->er", B, u)           # (E, 5)
            cg1, cg2, cg3, _ = _contravariant(g1, g2, g3)
            D = _dmat(chat, g1, g2, g3, cg1, cg2, cg3)
            Sv = torch.einsum("ers,es->er", D, Ev)
            # symmetric tensors, E33 = S33 = 0 by construction
            Et = _sym(Ev[:, 0], Ev[:, 1], 0.5 * Ev[:, 2], 0.5 * Ev[:, 3],
                      0.5 * Ev[:, 4])
            St = _sym(Sv[:, 0], Sv[:, 1], Sv[:, 2], Sv[:, 3], Sv[:, 4])
            cg = torch.stack([cg1, cg2, cg3], 1)
            gv = torch.stack([g1, g2, g3], 1)
            eps = torch.einsum("eij,eia,ejb->eab", Et, cg, cg)
            sig = torch.einsum("eij,eia,ejb->eab", St, gv, gv)

            def comp(T):
                return torch.stack([T[:, 0, 0], T[:, 1, 1], T[:, 2, 2],
                                    T[:, 0, 1], T[:, 1, 2], T[:, 2, 0]], -1)
            strain[:, ln] += 0.5 * comp(eps)
            stress[:, ln] += 0.5 * comp(sig)
    return strain, stress
