"""Frequency response by modal superposition, STATICEIGEN and the
!EIGENREAD import (torch port of ``frontistr_tpu/analysis/freq.py``;
reference fstr_solve_frequency_analysis,
fistr1/src/analysis/dynamic/freq/fstr_frequency_analysis.f90).

The harmonic response over [f_start, f_end] uses mass-normalised modes
and Rayleigh damping with the reference's coefficients (calcFreqCoeff:
b_j = phi_j^T F * conj(w_j^2 - W^2 + i(alpha + beta w_j^2) W) / |.|^2);
the modal products and the amplitude maxima run on the model's device
and come back as numpy.  The modes come from an in-process Lanczos run
(``analysis/eigen.py``) or from a previous eigen run's ``0.log`` and
``.res`` files (``load_eigenread``).
"""

from __future__ import annotations

import dataclasses
import os
import types
from typing import Optional

import numpy as np
import torch

from frontistr_tpu_torch.analysis import nonlinear as nl
from frontistr_tpu_torch.analysis.dynamic import lumped_mass_vector
from frontistr_tpu_torch.analysis.eigen import run_eigen
from frontistr_tpu_torch.assembly.model import StructModel, collect_cload
from frontistr_tpu_torch.io.resfile import read_result_any

F64 = torch.float64


@dataclasses.dataclass
class FreqResult:
    freqs: np.ndarray            # (nf,)
    disp_re: np.ndarray          # (nf, n_dof)
    disp_im: np.ndarray
    vel_amp_max: np.ndarray      # (nf,)
    disp_amp_max: np.ndarray
    acc_amp_max: np.ndarray
    eigen: object = None


def run_frequency(model: StructModel, f_start: float, f_end: float,
                  n_freq: int = 10, ray_alpha: float = 0.0,
                  ray_beta: float = 0.0, eigen_result=None,
                  fload: Optional[np.ndarray] = None) -> FreqResult:
    if eigen_result is None:
        eigen_result = run_eigen(model)
    dev = model.device

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)

    if fload is None:
        # !FLOAD cards: rows (grp, dof, value) like CLOAD;
        # LOAD CASE=1 -> real part, =2 -> imaginary part
        # (fstr_frequency_analysis FLOAD assembly)
        re_cards = [c for c in model.cfg.floads
                    if c.iparam("LOAD CASE", c.iparam("LOADCASE", 1)) != 2]
        im_cards = [c for c in model.cfg.floads
                    if c.iparam("LOAD CASE", c.iparam("LOADCASE", 1)) == 2]
        fre = collect_cload(model.mesh, re_cards, model.ndof, model.n_node)
        fim = collect_cload(model.mesh, im_cards, model.ndof, model.n_node)
        if not np.any(fre) and not np.any(fim):
            fre = np.asarray(model.f_ext)
    else:
        fre = fload
        fim = np.zeros_like(fload)

    phi = tensor(eigen_result.eigenvectors)        # (n, nmode) M-normalized
    w2 = tensor(eigen_result.ang_freq) ** 2        # (nmode,)
    ujfr = phi.T @ tensor(fre)
    ujfi = phi.T @ tensor(fim)
    freqs = np.linspace(f_start, f_end, n_freq)
    W = 2.0 * np.pi * tensor(freqs)[:, None]       # (nf, 1)
    damp = (ray_alpha + ray_beta * w2) * W          # (nf, nmode)
    dw = w2 - W ** 2
    den = dw ** 2 + damp ** 2
    bj_re = (ujfr * dw + ujfi * damp) / den
    bj_im = (ujfi * dw - ujfr * damp) / den
    d_re = bj_re @ phi.T                            # (nf, n)
    d_im = bj_im @ phi.T
    amp_max = torch.sqrt(d_re ** 2 + d_im ** 2).amax(dim=1)
    W = W[:, 0]
    return FreqResult(freqs, d_re.cpu().numpy(), d_im.cpu().numpy(),
                      (W * amp_max).cpu().numpy(), amp_max.cpu().numpy(),
                      (W * W * amp_max).cpu().numpy(), eigen_result)


def run_static_eigen(model: StructModel, log_path=None, timings=None):
    """!SOLUTION TYPE=STATICEIGEN (fstr_static_eigen_analysis): the
    Newton driver, then Lanczos on the TANGENT stiffness about the
    converged deformed state (fstr_solve_eigen after NLGEOM re-runs
    fstr_StiffMatrix at the converged displacement).

    The gauss state is re-integrated from zero in one pass at the
    converged u — exact for elastic (path-independent) tangents;
    path-dependent (plastic) states use the single-pass
    approximation."""
    static_res = nl.run_nonlinear_static(model, log_path=log_path,
                                         timings=timings)
    u = torch.as_tensor(np.asarray(static_res.u, np.float64).reshape(-1),
                        device=model.device)
    kes = []
    for b in model.blocks:
        p = nl.BlockPrograms(model, b)
        s = nl.init_block_state(b, p.table, model.device)
        u_e = nl._element_values(u, p, model.n_node, model.ndof)
        s2, _ = p.update(u_e * 0.0, u_e, s)
        kes.append(p.tangent(u_e, u_e * 0.0, s2))
    eig = run_eigen(model, log_path=log_path, kes=kes, log_append=True)
    return static_res, eig


def load_eigenread(card, workdir, ctrl, model):
    """'!EIGENREAD' import: eigen frequencies from a previous eigen
    run's 0.log EIGENVALUE table and mode shapes from its result
    snapshots '<base>.0.<mode>' — the reference's decoupled workflow
    (fstr_frequency_analysis.f90:264-372 read_eigen_values /
    read_eigen_vector_res).  Vectors are re-normalized against the
    lumped mass (scaleEigenVector).  Returns an eigen-result-shaped
    namespace, or None (with a message) when the files are absent, and
    the caller then runs Lanczos in-process, as the JAX package does."""
    rows = card.data
    if not rows:
        return None
    logname = str(rows[0][0]).strip()
    start, end = 1, 0
    if len(rows) > 1 and len(rows[1]) >= 2:
        start = int(float(rows[1][0]))
        end = int(float(rows[1][1]))
    logp = logname if os.path.isabs(logname) else \
        os.path.join(workdir, logname)
    if not os.path.exists(logp):
        print(f"### EIGENREAD: eigen log '{logname}' not found; "
              "recomputing modes in-process")
        return None
    # frequencies: the reference scans for the EGLIST table header
    ang, table = [], False
    for ln in open(logp):
        if ln.strip().startswith("NO.  EIGENVALUE"):
            table = True
            continue
        t = ln.split()
        if table and t and t[0].rstrip("-").isdigit():
            ang.append(float(t[2]))            # ANGLE FREQUENCY column
        elif table and t and set(t[0]) == {"-"}:
            continue
        elif table and not t:
            break
    if not ang:
        print(f"### EIGENREAD: no EIGENVALUE table in '{logname}'; "
              "recomputing modes in-process")
        return None
    if end <= 0:
        end = len(ang)
    end = min(end, len(ang))
    # mode shapes: result snapshots of the eigen run — the
    # '!RESULT,NAME=result-in,IO=IN' binding of the reference's
    # tutorial-17 workflow, with fstrEIG/fstrRES fallbacks
    rb = (ctrl.result("result-in") or ctrl.result("fstrEIG")
          or ctrl.result())
    base = ctrl.path(rb) if rb is not None else None
    mesh = model.mesh
    ndof = model.ndof
    phis, angs = [], []
    for k in range(start, end + 1):
        p = f"{base}.0.{k}" if base else None
        if p is None or not os.path.exists(p):
            print(f"### EIGENREAD: mode shape file "
                  f"'{p or '<no result binding>'}' not found; "
                  "recomputing modes in-process")
            return None
        comps = read_result_any(p)
        names = [n for n, _ in comps["node_comps"]]
        U = np.asarray(comps["node_comps"][
            names.index("DISPLACEMENT")][1])
        phi = np.zeros((mesh.n_node, ndof))
        for nid, row in zip(comps["node_ids"], U):
            idx = mesh.id2idx.get(int(nid))
            if idx is not None:
                phi[idx, :min(3, ndof)] = row[:min(3, ndof)]
        phis.append(phi.reshape(-1))
        angs.append(ang[k - 1])
    phi = np.stack(phis, axis=1)
    # mass re-normalization (scaleEigenVector): phi^T M phi = I
    m = lumped_mass_vector(model).cpu().numpy()
    scale = np.sqrt(np.einsum("nk,n,nk->k", phi, m, phi))
    phi = phi / np.where(scale == 0, 1.0, scale)[None, :]
    print(f"### EIGENREAD: imported modes {start}..{end} from "
          f"'{logname}' + '{os.path.basename(base)}.0.<k>'")
    return types.SimpleNamespace(
        eigenvectors=phi, ang_freq=np.asarray(angs),
        freq=np.asarray(angs) / (2 * np.pi))
