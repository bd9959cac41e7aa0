"""Hyperelastic constitutive models, total Lagrange (torch port of
``frontistr_tpu/fem/hyper.py``; reference
fistr1/src/lib/physics/Hyperelastic.f90 and ElasticNeoHooke.f90).

Each material is a scalar strain-energy density W(E) of the Voigt
Green-Lagrange strain (engineering shear); the 2nd Piola-Kirchhoff
stress and the material tangent are its derivatives

    S = dW/dE,        D = d2W/dE2

taken by ``torch.func`` (``grad``, ``jacfwd`` of it, ``vmap`` over the
gauss points) in float64, as the JAX package takes them.  Constants
from !HYPERELASTIC (fstr_ctrl_material.f90:166-240):
  Mooney-Rivlin (c10, c01, d): W = c10 (I1b - 3) + c01 (I2b - 3)
      + (J - 1)^2 / d
  Arruda-Boyce (c1, lambda_m, d): W = c1 (I1b/2 + I1b^2/(20 lm^2)
      + 11 I1b^3/(1050 lm^4) + 19 I1b^4/(7000 lm^6)
      + 519 I1b^5/(673750 lm^8)) + (J^2/2 - ln J) / d
  NEOHOOKE: the (E, nu) form W = mu/2 (I1 - 3) - mu ln J
      + lambda/2 (ln J)^2 of the material's elastic constants; the
      reference ignores the card's values.
The laws are 3-D (six strain components): a 2-D block of one raises.
"""

from __future__ import annotations

import torch
from torch.func import grad, jacfwd, vmap


def right_cauchy_green(E):
    """C = 2E + I from Voigt GL strain (eng. shear), Hyperelastic.f90:42-48."""
    e11, e22, e33, g12, g23, g31 = (E[..., i] for i in range(6))
    return torch.stack([
        torch.stack([2 * e11 + 1, g12, g31], -1),
        torch.stack([g12, 2 * e22 + 1, g23], -1),
        torch.stack([g31, g23, 2 * e33 + 1], -1)], -2)


def invariants(C):
    I1 = C[..., 0, 0] + C[..., 1, 1] + C[..., 2, 2]
    CC = C @ C
    I2 = 0.5 * (I1 ** 2 - (CC[..., 0, 0] + CC[..., 1, 1] + CC[..., 2, 2]))
    I3 = (C[..., 0, 0] * (C[..., 1, 1] * C[..., 2, 2]
                          - C[..., 1, 2] * C[..., 2, 1])
          + C[..., 0, 1] * (C[..., 1, 2] * C[..., 2, 0]
                            - C[..., 1, 0] * C[..., 2, 2])
          + C[..., 0, 2] * (C[..., 1, 0] * C[..., 2, 1]
                            - C[..., 1, 1] * C[..., 2, 0]))
    return I1, I2, I3


def w_mooney_rivlin(E, c10, c01, d):
    I1, I2, I3 = invariants(right_cauchy_green(E))
    J = torch.sqrt(I3)
    I1b = I1 * I3 ** (-1.0 / 3.0)
    I2b = I2 * I3 ** (-2.0 / 3.0)
    return c10 * (I1b - 3.0) + c01 * (I2b - 3.0) + (J - 1.0) ** 2 / d


def w_neohooke(E, ee, nu):
    """Compressible neo-Hooke in (E, nu) form (ElasticNeoHooke.f90:7-9)."""
    I1, _, I3 = invariants(right_cauchy_green(E))
    lam = nu * ee / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = ee / (2.0 * (1.0 + nu))
    lnJ = 0.5 * torch.log(I3)
    return 0.5 * mu * (I1 - 3.0) - mu * lnJ + 0.5 * lam * lnJ ** 2


def w_arruda_boyce(E, c1, lm, d):
    I1, _, I3 = invariants(right_cauchy_green(E))
    J = torch.sqrt(I3)
    I1b = I1 * I3 ** (-1.0 / 3.0)
    lm2 = lm * lm
    series = (I1b / 2.0 + I1b ** 2 / (20.0 * lm2)
              + 11.0 * I1b ** 3 / (1050.0 * lm2 ** 2)
              + 19.0 * I1b ** 4 / (7000.0 * lm2 ** 3)
              + 519.0 * I1b ** 5 / (673750.0 * lm2 ** 4))
    return c1 * series + (J * J / 2.0 - torch.log(J)) / d


_W_FUNCS = {
    "NEOHOOKE": w_neohooke,
    "MOONEY-RIVLIN": w_mooney_rivlin,
    "MOONEYRIVLIN": w_mooney_rivlin,
    "ARRUDA-BOYCE": w_arruda_boyce,
    "ARRUDABOYCE": w_arruda_boyce,
}

# gauss points a vmap call takes at once: bounds the forward-mode
# temporaries of the tangent on a card-sized block
CHUNK = 1 << 18


def make_hyper_fns(mtype: str, consts):
    """(pk2(E) -> S, tangent(E) -> D) for strains (..., 6): S (..., 6),
    D (..., 6, 6).  NEOHOOKE takes the material's (E, nu), the others the
    card's first three constants."""
    wf = _W_FUNCS[mtype.upper()]
    n = 2 if mtype.upper() == "NEOHOOKE" else 3
    c = [float(v) for v in list(consts)[:n]]

    def w(e):
        return wf(e, *c)

    g = vmap(grad(w))
    h = vmap(jacfwd(grad(w)))

    def chunked(fn, E, tail):
        flat = E.reshape(-1, 6)
        out = torch.cat([fn(flat[i:i + CHUNK])
                         for i in range(0, flat.shape[0], CHUNK)]) \
            if flat.shape[0] else flat.new_zeros((0,) + tail)
        return out.reshape(E.shape[:-1] + tail)

    def pk2(E):
        return chunked(g, E, (6,))

    def tangent(E):
        return chunked(h, E, (6, 6))

    return pk2, tangent
