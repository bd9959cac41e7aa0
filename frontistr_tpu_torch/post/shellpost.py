"""Nodal and element strain and stress of MITC shells (torch port of
``frontistr_tpu/post/shellpost.py``; reference fstr_NodalStress6D,
fistr1/src/analysis/static/fstr_NodalStress.f90:772-890), with the two
quirks of the reference that a golden log depends on:

1. Prefix-sum nodal averaging.  The reference's fstr_getavg_shell reads
   the running nodal sums inside the element loop, so for a node touched
   by elements e_1 < e_2 < ... < e_n the nodal value is
   sum_l (n - l + 1)/n * c_l, not the mean of the c_l
   (fstr_NodalStress.f90:835-846, fstr_getavg_shell:302-334).
2. Element components beyond nn are zero: estrain(j)/estress(j) are
   filled for j = 1..nn only, so a quad reports components 1-4 and a
   triangle 1-3.

The nodal sums run through K1's planes entry over a stable sort of the
element-node incidences (``nodal.node_plan``), so each node adds its
weighted entries in processing order and, on the card, a rerun repeats
bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from frontistr_tpu_torch.assembly.segsum import segsum_planes
from frontistr_tpu_torch.fem.shell import shell_nodal_stress
from frontistr_tpu_torch.post.nodal import mises_3d, node_plan


def check_recoverable(model) -> None:
    """Refuse a model whose stresses the JAX package cannot recover
    (ROADMAP, queue 3): its ``shell_nodal_stress`` ties MITC9 (743) rows
    4 and 5 with MITC3's three coefficients at MITC9's six tying points
    and fails, and its ``shell_recover`` takes a 611 block beside shells
    for a shell and fails."""
    kinds = {b.kind for b in model.blocks}
    if any(b.kind == "shell" and b.etype == 743 for b in model.blocks):
        raise NotImplementedError(
            "stress recovery of MITC9 (743) shells: the JAX package's "
            "shell_nodal_stress fails on them")
    if "shell" in kinds and "beam" in kinds:
        raise NotImplementedError(
            "stress recovery of 611 beams beside shells: the JAX "
            "package's shell_recover fails on them")


def shell_recover(model, u: np.ndarray) -> dict:
    """u (n_node, 6) host array -> the ``smooth`` result dict (numpy),
    computed on ``model.device``."""
    check_recoverable(model)
    dev = model.device
    n = model.n_node
    est, ess, ems = [], [], []
    conns, eps_l, sig_l = [], [], []
    for b in model.blocks:
        coords_e = torch.as_tensor(model.coords[b.conn], device=dev)
        ue = torch.as_tensor(u[b.conn], device=dev)
        eps, sig = shell_nodal_stress(coords_e, ue, b.thick,
                                      b.material.youngs,
                                      b.material.poisson, etype=b.etype)
        E, nn = b.conn.shape
        conns.append(np.asarray(b.conn, np.int64).reshape(-1))
        # element-major: the reference's element loop
        eps_l.append(eps.reshape(E * nn, 6))
        sig_l.append(sig.reshape(E * nn, 6))
        # element means with the j <= nn component quirk
        e_eps, e_sig = eps.new_zeros((E, 6)), sig.new_zeros((E, 6))
        e_eps[:, :nn] = eps.mean(dim=1)[:, :nn]
        e_sig[:, :nn] = sig.mean(dim=1)[:, :nn]
        est.append(e_eps.cpu().numpy())
        ess.append(e_sig.cpu().numpy())
        ems.append(mises_3d(e_sig).cpu().numpy())
    nodes = np.concatenate(conns)
    count = np.bincount(nodes, minlength=n).astype(np.float64)
    # prefix-sum weights: a node's l-th (0-based) contribution in
    # processing order weighs (n_i - l) / n_i
    order = np.argsort(nodes, kind="stable")
    ns = nodes[order]
    starts = np.r_[0, np.flatnonzero(ns[1:] != ns[:-1]) + 1]
    pos = np.empty(len(nodes))
    pos[order] = np.arange(len(ns)) - np.repeat(
        starts, np.diff(np.r_[starts, len(ns)]))
    w = torch.as_tensor((count[nodes] - pos) / count[nodes], device=dev)
    vals = torch.cat([torch.cat(eps_l), torch.cat(sig_l)], 1) * w[:, None]
    acc = segsum_planes(vals.T.contiguous(), node_plan(nodes, n, dev))
    nd_eps, nd_sig = acc[:6].T, acc[6:].T
    return dict(strain=nd_eps.cpu().numpy(), stress=nd_sig.cpu().numpy(),
                mises=mises_3d(nd_sig).cpu().numpy(), count=count,
                estrain=est, estress=ess, emises=ems)
