"""Viscoelastic (Prony series) and Norton creep constitutive updates
(torch port of ``frontistr_tpu/fem/visco.py``; reference
fistr1/src/lib/physics/Viscoelastic.f90 and creep.f90), batched over the
gauss points, 3-D Voigt (six components).

Viscoelastic (UpdateViscoelastic / calViscoelasticMatrix):
    h(x) = (1 - e^-x)/x (its series for x < 1e-4)
    q_n' = e^{-dtau} q_n + mu_n h(dtau) (e - e_n), e the deviatoric strain
    (tensor shear), sigma = 2G (mu_0 e + sum q_n') + K tr(eps) I;
    tangent: G_g = G (mu_0 + sum mu_n h), the isotropic D(G_g, K).
    The TRS shift a(T) scales dt to the reduced time (WLF or Arrhenius).

Norton creep (update_iso_creep / iso_creep):
    the trial deviator s; a scalar Newton on dg: A' (|s| - 3G dg)^n = dg,
    A' = A ((t+dt)^{m+1} - t^{m+1})/(m+1); s' = s (1 - 3G dg/|s|);
    the consistent tangent De + c3 n n^T - c4 (deviatoric projection).
"""

from __future__ import annotations

import math

import torch


def hvisc(x):
    series = 1.0 - 0.5 * x * (1.0 - x / 3.0 * (1.0 - 0.25 * x *
                                               (1.0 - 0.2 * x)))
    small = x < 1e-4
    safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, series, (1.0 - torch.exp(-safe)) / safe)


def dev_strain(eps):
    """(volumetric third, deviatoric TENSOR strain) of a Voigt
    engineering strain."""
    th = (eps[..., 0] + eps[..., 1] + eps[..., 2]) / 3.0
    return th, torch.cat([eps[..., :3] - th[..., None], 0.5 * eps[..., 3:]],
                         -1)


def trs_shift(T, trs_consts, definition="WLF"):
    """Reduced-time factor a(T) (Viscoelastic.f90 trs:70-84): dt' = a dt.
    WLF: a = exp(C1 (T-T0)/(C2+T-T0) ln 10); Arrhenius: a = exp(C1
    (1/(T-C2) - 1/(T0-C2)))."""
    T0, C1, C2 = (float(v) for v in
                  torch.as_tensor(trs_consts).reshape(-1)[:3])
    if definition.startswith("ARR"):
        h = C1 * (1.0 / (T - C2) - 1.0 / (T0 - C2))
    else:
        h = C1 * (T - T0) / (C2 + T - T0) * math.log(10.0)
    return torch.exp(h)


def visco_update(eps, vq, ven, dt, G, K, mus, taus):
    """(sigma, vq_new): vq (..., nterms, 6) the committed q, ven (..., 6)
    the committed deviatoric strain; ``dt`` a number or a tensor that
    broadcasts to eps[..., 0] (the TRS-scaled reduced time)."""
    th, dev = dev_strain(eps)
    dt = torch.as_tensor(dt, dtype=eps.dtype, device=eps.device)
    dtau = dt[..., None] / taus                       # (..., nterms)
    dq = mus * hvisc(dtau)
    de = dev[..., None, :] - ven[..., None, :]
    vq_new = torch.exp(-dtau)[..., None] * vq + dq[..., None] * de
    mu0 = 1.0 - mus.sum()
    sig_dev = 2.0 * G * (mu0 * dev + vq_new.sum(dim=-2))
    sig = torch.cat([sig_dev[..., :3] + (3.0 * K * th)[..., None],
                     sig_dev[..., 3:]], -1)
    return sig, vq_new


def visco_D(dt, G, K, mus, taus):
    """Isotropic viscoelastic tangent (calViscoelasticMatrix): ``dt`` a
    tensor of any shape -> D (..., 6, 6)."""
    dtau = dt[..., None] / taus
    gfac_t = (mus * hvisc(dtau)).sum(-1) + (1.0 - mus.sum())
    gfac = torch.where(dt == 0.0, torch.ones_like(gfac_t), gfac_t)
    Gg = G * gfac
    Kg = K - 2.0 / 3.0 * Gg
    base = torch.zeros(dt.shape + (6, 6), dtype=dt.dtype, device=dt.device)
    base[..., :3, :3] = Kg[..., None, None]
    idx = torch.arange(6, device=dt.device)
    base[..., idx, idx] += torch.stack([2.0 * Gg] * 3 + [Gg] * 3, -1)
    return base


def _eq_dev(sig):
    th = (sig[..., 0] + sig[..., 1] + sig[..., 2]) / 3.0
    dev = torch.cat([sig[..., :3] - th[..., None], sig[..., 3:]], -1)
    mag = torch.sqrt(1.5 * ((dev[..., :3] ** 2).sum(-1)
                            + 2.0 * (dev[..., 3:] ** 2).sum(-1)))
    return th, dev, mag


def _norton_factor(A, n, m, ttime, dt):
    return A * ((ttime + dt) ** (m + 1.0) - ttime ** (m + 1.0)) / (m + 1.0)


def creep_return(sig_trial, G, A, n, m, ttime, dt, iters: int = 30):
    """Norton radial return: (sigma, dg, eqvs)."""
    aa = _norton_factor(A, n, m, ttime, dt)
    th, dev, dstri = _eq_dev(sig_trial)
    safe = torch.clamp(dstri, min=1e-10)
    dg = torch.zeros_like(dstri)
    for _ in range(iters):
        eqvs = torch.clamp(dstri - 3.0 * G * dg, min=1e-10)
        f = aa * eqvs ** n
        df = n * f / eqvs
        dg = dg + (f - dg) / (3.0 * G * df + 1.0)
    eqvs = torch.clamp(dstri - 3.0 * G * dg, min=1e-10)
    dev_new = (1.0 - 3.0 * G * dg / safe)[..., None] * dev
    sig = torch.cat([dev_new[..., :3] + th[..., None], dev_new[..., 3:]],
                    -1)
    active = dstri > 1e-10
    sig = torch.where(active[..., None], sig, sig_trial)
    dg = torch.where(active, dg, torch.zeros_like(dg))
    return sig, dg, eqvs


def creep_tangent(De, sig, dg, G, A, n, m, ttime, dt):
    """iso_creep consistent tangent (creep.f90:88-113)."""
    aa = _norton_factor(A, n, m, ttime, dt)
    th, dev, dstri = _eq_dev(sig)
    eqvs = torch.clamp(dstri, min=1e-10)
    nvec = dev / eqvs[..., None]
    f = aa * eqvs ** n
    df = n * f / eqvs
    c3 = 6.0 * G * G
    c4 = c3 * dg / (dstri + 3.0 * G * dg)
    c3t = c4 - c3 * df / (3.0 * G * df + 1.0)
    c5 = c4 / 3.0
    D = De + c3t[..., None, None] * nvec[..., :, None] * nvec[..., None, :]
    eye3 = De.new_zeros((6, 6))
    eye3[:3, :3] = 1.0
    diag = torch.diag(De.new_tensor([1.0, 1.0, 1.0, 0.5, 0.5, 0.5]))
    D = D - c4[..., None, None] * diag + c5[..., None, None] * eye3
    active = (dstri > 1e-10) & (dt > 0)
    return torch.where(active[..., None, None], D, De)
