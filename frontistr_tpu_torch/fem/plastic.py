"""Elastoplastic constitutive update (torch port of
``frontistr_tpu/fem/plastic.py``; reference Elastoplastic.f90,
fistr1/src/lib/physics/Elastoplastic.f90).

Batched and branch-free over the gauss points, ``(E, nq, 6)`` Voigt:

- the trial stress comes from the total mechanical strain, the return
  from the committed equivalent plastic strain (BackwardEuler,
  Elastoplastic.f90:351-561);
- yield functions MISES, DRUCKER-PRAGER and MOHR-COULOMB; hardening
  LINEAR, MULTILINEAR, SWIFT, RAMBERG-OSGOOD, KINEMATIC (Prager) and
  COMBINED (Elastoplastic.f90:176-294);
- a fixed 5-iteration Newton on the consistency equation;
- the tangent D = De - (De a)(De a)^T / (H + Kh + a^T De a) at yielded
  points (calElastoPlasticMatrix, Elastoplastic.f90:16-119).

Both sides of every ``torch.where`` are evaluated; each keeps the JAX
package's guards (``safe_*`` denominators, clipped arcsin arguments), so
no NaN of an unselected side reaches a later product.  The MULTILINEAR
table lookup is ``torch.searchsorted`` on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PlasticParams:
    youngs: float
    poisson: float
    hardening: str                   # LINEAR/MULTILINEAR/SWIFT/RAMBERG-OSGOOD/KINEMATIC/COMBINED
    consts: np.ndarray               # !PLASTIC data rows flattened
    table: Optional[np.ndarray] = None   # multilinear (yield, pstrain) rows
    yield_func: str = "MISES"        # MISES / MOHR-COULOMB / DRUCKER-PRAGER
    # the MULTILINEAR table's device tensors, built at first use per device
    _tables: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    @property
    def G(self):
        return self.youngs / (2.0 * (1.0 + self.poisson))

    @property
    def K(self):
        return self.youngs / (3.0 * (1.0 - 2.0 * self.poisson))

    @property
    def kinematic(self):
        return self.hardening in ("KINEMATIC", "COMBINED")

    @property
    def phi(self):
        """Friction angle in radians (!PLASTIC MC/DP row: c, phi_deg, H)."""
        return float(self.consts.reshape(-1)[1]) * 3.141592653589793 / 180.0

    @property
    def dp_eta(self):
        # fstr_ctrl_material.f90:461-464 outer-cone DP constants
        sf = np.sin(self.phi)
        return 2.0 * sf / (np.sqrt(3.0) * (3.0 + sf))

    @property
    def dp_xi(self):
        sf, cf = np.sin(self.phi), np.cos(self.phi)
        return 6.0 * cf / (np.sqrt(3.0) * (3.0 + sf))


def _interp(x, xp, fp):
    """``numpy.interp`` on tensors (constant beyond the table), in the
    JAX package's arithmetic (``jnp.interp``)."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = np.spacing(np.finfo(np.float64).eps)
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(
                        dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def make_hardening(params: PlasticParams, device=None):
    """Returns (yield_stress(p), harden_coeff(p), kin_coeff, kin_state(p));
    ``device`` holds the MULTILINEAR table (uploaded once per device and
    kept in ``params``)."""
    h = params.hardening.upper()
    c = params.consts.reshape(-1)

    if params.yield_func.upper() != "MISES":
        # MC/DP data row is (c, phi_deg, H): cohesion-style linear hardening
        s0 = c[0]
        hh = c[2] if len(c) > 2 else 0.0
        return (lambda p: s0 + hh * p, lambda p: hh + 0.0 * p, 0.0,
                (lambda p: 0.0 * p))

    if h == "MULTILINEAR":
        key = str(torch.device(device or "cpu"))
        if key not in params._tables:
            tab = params.table if params.table is not None else \
                params.consts.reshape(-1, 2)
            ys = torch.as_tensor(np.ascontiguousarray(tab[:, 0],
                                                      np.float64),
                                 device=device)
            ps = torch.as_tensor(np.ascontiguousarray(tab[:, 1],
                                                      np.float64),
                                 device=device)
            params._tables[key] = (ys, ps, torch.diff(ys) / torch.clamp(
                torch.diff(ps), min=1e-30))
        ys, ps, slopes = params._tables[key]

        def yield_stress(p):
            return _interp(p, ps, ys)

        def harden(p):
            idx = torch.clamp(torch.searchsorted(ps, p.contiguous(),
                                                 right=True) - 1,
                              0, len(slopes) - 1)
            return slopes[idx]

        return yield_stress, harden, 0.0, (lambda p: 0.0 * p)

    if h == "SWIFT":
        e0, k, n = c[0], c[1], c[2]
        return (lambda p: k * (e0 + p) ** n,
                lambda p: k * n * (e0 + p) ** (n - 1.0),
                0.0, (lambda p: 0.0 * p))

    if h in ("RAMBERG-OSGOOD", "RAMBERGOSGOOD"):
        e0, D, n = c[0], c[1], c[2]

        def yield_stress(p):
            return torch.where(p <= e0, D * torch.ones_like(p),
                               D * (p / e0) ** (1.0 / n))

        def harden(p):
            ef = yield_stress(p)
            return D * (ef / D) ** (1.0 - n) / (e0 * n)

        return yield_stress, harden, 0.0, (lambda p: 0.0 * p)

    if h == "KINEMATIC":
        s0, hk = c[0], c[1]
        return (lambda p: s0 + 0.0 * p, lambda p: 0.0 * p, hk,
                (lambda p: hk * p))

    if h == "COMBINED":
        s0, hiso, hk = c[0], c[1], c[2]
        return (lambda p: s0 + hiso * p, lambda p: hiso + 0.0 * p, hk,
                (lambda p: hk * p))

    # LINEAR (default): sigma_y = c0 + c1 * p
    s0 = c[0]
    hh = c[1] if len(c) > 1 else 0.0
    return (lambda p: s0 + hh * p, lambda p: hh + 0.0 * p, 0.0,
            (lambda p: 0.0 * p))


def _deviator(sig):
    j1 = (sig[..., 0] + sig[..., 1] + sig[..., 2]) / 3.0
    dev = torch.cat([sig[..., :3] - j1[..., None], sig[..., 3:]], -1)
    return j1, dev


def _eq_stress(dev):
    j2 = 0.5 * torch.sum(dev[..., :3] ** 2, -1) + \
        torch.sum(dev[..., 3:] ** 2, -1)
    return torch.sqrt(3.0 * j2)


def _where0(cond, x):
    """``jnp.where(cond, x, 0.0)``."""
    return torch.where(cond, x, torch.zeros_like(x))


def _safe(x, bad):
    """``jnp.where(bad, 1.0, x)``: a denominator guard."""
    return torch.where(bad, torch.ones_like(x), x)


def return_mapping_mises(params: PlasticParams, sig_trial, p_committed,
                         back, maxiter: int = 5, tol: float = 1e-3):
    """Radial return (BackwardEuler yType==0 arm), batched over (..., 6).

    Args:
      sig_trial: elastic trial stress D_e : eps_total.
      p_committed: committed equivalent plastic strain (scalar field).
      back: back-stress (kinematic), same shape as sig_trial.

    Returns (sigma, p_new, yielded (bool), back_new).
    """
    ys_f, h_f, kin_h, kin_f = make_hardening(params, sig_trial.device)
    G = params.G
    j1, dev = _deviator(sig_trial)
    dev_eff = dev - back if params.kinematic else dev
    yd = _eq_stress(dev_eff)
    betan = kin_f(p_committed)
    f0 = yd - ys_f(p_committed)

    yielded = f0 > tol

    dlam = torch.zeros_like(yd)
    f = f0
    for _ in range(maxiter):
        H = h_f(p_committed + dlam)
        dd = 3.0 * G + H + kin_h
        dlam_new = torch.clamp(dlam + f / dd, min=0.0)
        KK = kin_f(p_committed + dlam_new)
        f = yd - 3.0 * G * dlam_new - ys_f(p_committed + dlam_new) \
            - (KK - betan)
        dlam = dlam_new
    dlam = _where0(yielded, dlam)
    p_new = p_committed + dlam

    safe_yd = _safe(yd, yd == 0)
    scale = 1.0 - 3.0 * dlam * G / safe_yd
    dev_new = scale[..., None] * dev_eff
    sig_new = torch.cat([dev_new[..., :3] + j1[..., None], dev_new[..., 3:]],
                        -1)
    back_new = back
    if params.kinematic:
        KK = kin_f(p_new)
        back_new = back + ((KK - betan) / safe_yd)[..., None] * dev_eff
        sig_new = sig_new + back_new
    sig_out = torch.where(yielded[..., None], sig_new, sig_trial)
    return sig_out, p_new, yielded, back_new


def _lode(dev):
    """(J2, J3, sin3theta clipped) from deviatoric Voigt."""
    j2 = 0.5 * torch.sum(dev[..., :3] ** 2, -1) + \
        torch.sum(dev[..., 3:] ** 2, -1)
    d1, d2, d3, d4, d5, d6 = [dev[..., i] for i in range(6)]
    j3 = (d1 * d2 * d3 + 2.0 * d4 * d5 * d6 - d2 * d6 * d6
          - d3 * d4 * d4 - d1 * d5 * d5)
    safe = _safe(j2, j2 <= 0.0)
    s3t = torch.clamp(-3.0 * np.sqrt(3.0) * j3 / (2.0 * safe ** 1.5),
                      -1.0, 1.0)
    return j2, j3, s3t


def return_mapping_dp(params: PlasticParams, sig_trial, p_committed,
                      back, maxiter: int = 5, tol: float = 1e-3):
    """Drucker-Prager return (BackwardEuler yType==2), batched.

    Onset uses the full-trace yield f = sqrt(J2) + eta*tr(sigma) - xi*
    sigma_y (calYieldFunc:342-344); the Newton loop then iterates the
    reference's mean-stress form (BackwardEuler:533-556), as the JAX
    package does."""
    ys_f, h_f, _, _ = make_hardening(params, sig_trial.device)
    G, K = params.G, params.K
    eta, xi = params.dp_eta, params.dp_xi
    j1m, dev = _deviator(sig_trial)           # j1m = mean stress
    j2 = 0.5 * torch.sum(dev[..., :3] ** 2, -1) + \
        torch.sum(dev[..., 3:] ** 2, -1)
    yd = torch.sqrt(torch.clamp(j2, min=0.0))
    f0 = yd + eta * (3.0 * j1m) - xi * ys_f(p_committed)
    yielded = f0 > tol
    dlam = torch.zeros_like(yd)
    f = f0
    for _ in range(maxiter):
        H = h_f(p_committed + xi * dlam)
        dd = G + K * eta * eta + H * xi * xi
        dlam = torch.clamp(dlam + f / dd, min=0.0)
        f = yd - G * dlam + eta * (j1m - K * eta * dlam) \
            - xi * ys_f(p_committed + xi * dlam)
    dlam = _where0(yielded, dlam)
    p_new = p_committed + xi * dlam
    safe_yd = _safe(yd, yd == 0)
    dev_new = (1.0 - G * dlam / safe_yd)[..., None] * dev
    j1_new = j1m - K * eta * dlam
    sig_new = torch.cat([dev_new[..., :3] + j1_new[..., None],
                         dev_new[..., 3:]], -1)
    sig_out = torch.where(yielded[..., None], sig_new, sig_trial)
    return sig_out, p_new, yielded, back


def _orthonormal_to(v):
    """A unit vector orthogonal to v (branch-free)."""
    ex = torch.zeros_like(v)
    ex[..., 0] = 1.0
    ey = torch.zeros_like(v)
    ey[..., 1] = 1.0
    use_y = torch.abs(v[..., 0]) > 0.9
    a = torch.where(use_y[..., None], ey, ex)
    w = a - torch.sum(a * v, -1, keepdim=True) * v
    return w / torch.sqrt(torch.sum(w * w, -1))[..., None]


def eigh3_voigt(v6):
    """Closed-form symmetric 3x3 eigendecomposition of Voigt vectors
    (s11, s22, s33, s12, s23, s31) -> (evals (..., 3) ascending, evecs
    (..., 3, 3) columns): the trigonometric eigenvalue formula and
    spectral-projector eigenvectors of the JAX package's
    ``utils/linalg.py``, branch-free over the batch; repeated
    eigenvalues get orthonormalized fallback vectors."""
    s11, s22, s33 = v6[..., 0], v6[..., 1], v6[..., 2]
    s12, s23, s31 = v6[..., 3], v6[..., 4], v6[..., 5]
    A = torch.stack([
        torch.stack([s11, s12, s31], -1),
        torch.stack([s12, s22, s23], -1),
        torch.stack([s31, s23, s33], -1)], -2)
    q = (s11 + s22 + s33) / 3.0
    eye = torch.eye(3, dtype=v6.dtype, device=v6.device)
    B = A - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-1, -2)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=0.0))
    safe_p = _safe(p, p < 1e-30)
    detB = (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2]
                            - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2]
                              - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1]
                              - B[..., 1, 1] * B[..., 2, 0]))
    r = torch.clamp(detB / (2.0 * safe_p ** 3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam1 = q + 2.0 * p * torch.cos(phi)                      # largest
    lam3 = q + 2.0 * p * torch.cos(phi + 2.0 * 3.141592653589793 / 3.0)
    lam2 = 3.0 * q - lam1 - lam3
    evals = torch.stack([lam3, lam2, lam1], -1)              # ascending

    def projector_vec(li, lj, lk):
        # P = (A-lj)(A-lk) / ((li-lj)(li-lk)); eigenvector = best column
        P = torch.matmul(A - lj[..., None, None] * eye,
                         A - lk[..., None, None] * eye)
        norms = torch.sum(P * P, dim=-2)
        best = torch.argmax(norms, dim=-1)
        v = torch.take_along_dim(
            P, best[..., None, None].expand(P.shape[:-1] + (1,)),
            dim=-1)[..., 0]
        n = torch.sqrt(torch.sum(v * v, -1))
        degen = n < 1e-30 * (1.0 + torch.abs(li))
        e0 = torch.zeros_like(v)
        e0[..., 0] = 1.0
        v = torch.where(degen[..., None], e0, v)
        n = torch.sqrt(torch.sum(v * v, -1))
        return v / n[..., None]

    v3 = projector_vec(lam3, lam2, lam1)
    v1 = projector_vec(lam1, lam3, lam2)
    # middle vector: orthogonal completion (robust when lam2 degenerate)
    v2 = torch.linalg.cross(v3, v1)
    n2 = torch.sqrt(torch.sum(v2 * v2, -1))
    degen = n2 < 1e-12
    v1r = torch.where(degen[..., None], _orthonormal_to(v3), v1)
    v2 = torch.linalg.cross(v3, v1r)
    v2 = v2 / torch.sqrt(torch.sum(v2 * v2, -1))[..., None]
    v1r2 = torch.linalg.cross(v2, v3)
    evecs = torch.stack([v3, v2, v1r2], -1)   # columns: ascending order
    return evals, evecs


def return_mapping_mc(params: PlasticParams, sig_trial, p_committed,
                      back, maxiter: int = 5, tol: float = 1e-3):
    """Mohr-Coulomb principal-stress return (BackwardEuler yType==1):
    smooth-cone onset check (calYieldFunc:329-341), then a one-vector
    return on the max/min principal pair with the trial Lode angle frozen,
    reassembled through the trial eigenprojection."""
    ys_f, h_f, _, _ = make_hardening(params, sig_trial.device)
    G, K = params.G, params.K
    phi = params.phi
    sf, cf = np.sin(phi), np.cos(phi)
    j1m, dev = _deviator(sig_trial)
    j2, j3, s3t = _lode(dev)
    sita = torch.arcsin(s3t) / 3.0
    sq_j2 = torch.sqrt(torch.clamp(j2, min=0.0))
    f0 = (torch.cos(sita) - torch.sin(sita) * sf / np.sqrt(3.0)) * sq_j2 \
        + (3.0 * j1m) * sf / 3.0 - ys_f(p_committed) * cf
    yielded = f0 > tol

    evals, evecs = eigh3_voigt(sig_trial)     # ascending: (min, mid, max)
    smin, smid, smax = evals[..., 0], evals[..., 1], evals[..., 2]
    dlam = torch.zeros_like(smax)
    f = f0
    for _ in range(maxiter):
        pcur = p_committed + 2.0 * dlam * cf
        H = h_f(pcur)
        dd = 4.0 * G * (1.0 + sf * torch.sin(sita) / 3.0) \
            + 4.0 * K * sf * torch.sin(sita) + 4.0 * H * cf * cf
        dlam = torch.clamp(dlam + f / dd, min=0.0)
        yd = ys_f(p_committed + 2.0 * dlam * cf)
        f = smax - smin + (smax + smin) * sf \
            - (4.0 * G * (1.0 + sf * torch.sin(sita) / 3.0)
               + 4.0 * K * sf * torch.sin(sita)) * dlam \
            - 2.0 * yd * cf
    dlam = _where0(yielded, dlam)
    p_new = p_committed + 2.0 * dlam * cf
    smax_n = smax - (2.0 * G * (1.0 + sf / 3.0) + 2.0 * K * sf) * dlam
    smin_n = smin + (2.0 * G * (1.0 - sf / 3.0) - 2.0 * K * sf) * dlam
    smid_n = smid + (4.0 * G / 3.0 - 2.0 * K) * sf * dlam
    pr = torch.stack([smin_n, smid_n, smax_n], -1)
    m = torch.einsum("...ik,...k,...jk->...ij", evecs, pr, evecs)
    sig_new = torch.stack([m[..., 0, 0], m[..., 1, 1], m[..., 2, 2],
                           m[..., 0, 1], m[..., 1, 2], m[..., 2, 0]], -1)
    sig_out = torch.where(yielded[..., None], sig_new, sig_trial)
    return sig_out, p_new, yielded, back


def return_mapping(params: PlasticParams, sig_trial, p_committed, back,
                   **kw):
    yf = params.yield_func.upper()
    if yf.startswith("MOHR"):
        return return_mapping_mc(params, sig_trial, p_committed, back,
                                 **kw)
    if yf.startswith("DRUCKER"):
        return return_mapping_dp(params, sig_trial, p_committed, back,
                                 **kw)
    return return_mapping_mises(params, sig_trial, p_committed, back,
                                **kw)


def plastic_tangent(params: PlasticParams, De, sig, p, back, yielded):
    """D = De - (De a)(De a)^T / (H + Kh + a:De:a) on yielded points
    (calElastoPlasticMatrix), De: (..., 6, 6)."""
    _, h_f, kin_h, _ = make_hardening(params, sig.device)
    j1, dev = _deviator(sig)
    if params.kinematic:
        dev = dev - back
    j2 = 0.5 * torch.sum(dev[..., :3] ** 2, -1) + \
        torch.sum(dev[..., 3:] ** 2, -1)
    safe = _safe(j2, j2 == 0)
    dj2 = torch.cat([dev[..., :3], 2.0 * dev[..., 3:]], -1) / \
        (2.0 * torch.sqrt(safe))[..., None]
    yf = params.yield_func.upper()
    dj1 = torch.cat([torch.ones_like(dev[..., :3]),
                     torch.zeros_like(dev[..., 3:])], -1)
    if yf.startswith("DRUCKER"):
        a = params.dp_eta * dj1 + dj2
    elif yf.startswith("MOHR"):
        # calElastoPlasticMatrix yType==1 flow vector
        sfai = np.sin(params.phi)
        j2f, j3, s3t = _lode(dev)
        degen = torch.abs(torch.abs(s3t) - 1.0) < 1e-8
        sita = torch.arcsin(torch.clamp(s3t, -1.0, 1.0)) / 3.0
        t3 = torch.tan(3.0 * sita)
        C2s = torch.cos(sita) * (torch.tan(sita) * t3 + sfai *
                                 (t3 - torch.tan(sita) / np.sqrt(3.0)))
        safe_j2 = _safe(j2f, j2f == 0)
        C3s = np.sqrt(3.0) * torch.sin(sita) + torch.cos(sita) * sfai / \
            (2.0 * safe_j2 * torch.cos(3.0 * sita))
        C1 = torch.where(degen, torch.zeros_like(j2f),
                         torch.full_like(j2f, sfai / 3.0))
        C2 = torch.where(degen, torch.full_like(j2f, np.sqrt(3.0)), C2s)
        C3 = _where0(~degen, C3s)
        d1, d2, d3, d4, d5, d6 = [dev[..., i] for i in range(6)]
        dj3 = torch.stack([
            d2 * d3 - d5 * d5 + j2f / 3.0,
            d1 * d3 - d6 * d6 + j2f / 3.0,
            d1 * d2 - d4 * d4 + j2f / 3.0,
            2.0 * (d5 * d6 - d3 * d4),
            2.0 * (d4 * d6 - d1 * d5),
            2.0 * (d4 * d5 - d2 * d6)], -1)
        a = C1[..., None] * dj1 + C2[..., None] * dj2 \
            + C3[..., None] * dj3
    else:
        a = np.sqrt(3.0) * dj2
    H = h_f(p)
    da = torch.einsum("...kl,...l->...k", De, a)
    denom = H + kin_h + torch.einsum("...k,...k->...", da, a)
    Dp = De - da[..., :, None] * da[..., None, :] / denom[..., None, None]
    return torch.where(yielded[..., None, None], Dp, De)
