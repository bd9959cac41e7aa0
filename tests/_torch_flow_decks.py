"""Deck helpers of the u-p flow (3414) parity tests: a ``box_tet4`` unit
cube with its block made 3414, the lid-driven cavity deck (no-slip
walls, the lid Z1 sliding in +x) and ``run_both``, the deck through the
port and the JAX package on the CPU, the mesh's nodes shuffled."""

import dataclasses
import shutil

import numpy as np

from frontistr_tpu_torch import ordering
from frontistr_tpu_torch.io.neu import write_static_workdir
from frontistr_tpu_torch.meshgen import box_tet4

WALLS = ("X0", "X1", "Y0", "Y1", "Z0", "Z1")

CAVITY = ("!VERSION\n 3\n!SOLUTION, TYPE=DYNAMIC\n!DYNAMIC, TYPE=NONLINEAR\n"
          " 1, 1\n 0.0, {t_end!r}, {n_step}, {dt!r}\n 0.5, 0.25\n"
          " 1, 1, 0.0, 0.0\n {nout}, 0, 1\n"
          "!BOUNDARY\n X0, 1, 3, 0.0\n X1, 1, 3, 0.0\n Y0, 1, 3, 0.0\n"
          " Y1, 1, 3, 0.0\n Z0, 1, 3, 0.0\n Z1, 1, 1, {lid!r}\n"
          " Z1, 2, 3, 0.0\n{pressure}{step}"
          "!MATERIAL, NAME=M1\n!FLUID, TYPE=INCOMP_NEWTONIAN\n {mu!r}\n"
          "!DENSITY\n {rho!r}\n"
          "!SOLVER, METHOD=BICGSTAB, PRECOND=1, ITERLOG=NO, TIMELOG=NO\n"
          " 10000, 1\n {resid}, 1.0, 0.0\n{write}!END\n")


def flow_mesh(n):
    """``box_tet4(n, n, n)`` on the unit cube, its block made 3414."""
    m = box_tet4(n, n, n)
    b = m.blocks[0]
    m.blocks = [dataclasses.replace(b, etype=3414)]
    return m


def cavity_cnt(mu=1.0, rho=1.0, dt=0.25, n_step=2, nout=1, lid=1.0,
               resid="1.0e-10", step="", pressure="", write=True):
    """The lid-driven cavity: every wall no-slip, the lid's v_x = ``lid``
    (its rows last, so the lid's edges slide); ``step`` a !STEP card
    (CONVERG, MAXITER), ``pressure`` more !BOUNDARY rows."""
    return CAVITY.format(t_end=n_step * dt, n_step=n_step, dt=dt, nout=nout,
                         lid=lid, pressure=pressure, step=step, mu=mu,
                         rho=rho, resid=resid,
                         write="!WRITE, RESULT\n" if write else "")


def run_both(path, mesh, cnt, seed=3, ngroups=WALLS):
    """The deck through the port and the JAX package's ``run_directory``
    on the CPU, the mesh's nodes shuffled by ``seed``; returns (port
    output, JAX output, port dir, JAX dir)."""
    import frontistr_tpu.run as jrun
    from frontistr_tpu_torch.run import run_directory
    order = np.random.default_rng(seed).permutation(mesh.n_node)
    wd, wj = str(path / "port"), str(path / "jax")
    write_static_workdir(wd, ordering.permute_mesh(mesh, order), cnt,
                         ngroups=ngroups)
    shutil.copytree(wd, wj)
    oj = jrun.run_directory(wj)
    return run_directory(wd, device="cpu"), oj, wd, wj


def rel(a, b):
    """max |a - b| / max |b|."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
