"""Deck helpers of the port's shell, solid-shell and beam parity tests:
plates from ``meshgen.plate_shell`` (distorted and warped on request),
the shell cantilever strip of ``tests/test_shell_dynamics.py``, the beam
and solid-shell meshes of ``tests/test_beam.py`` and
``tests/test_solid_shell.py`` (``meshgen.beam_line``,
``meshgen.solid_shell_strip``), the decks, and
``run_both``, which runs a deck through the port and the JAX package on
the CPU from one work directory written with its nodes shuffled."""

import shutil

import numpy as np

from frontistr_tpu_torch import ordering
from frontistr_tpu_torch.io.neu import write_static_workdir
from frontistr_tpu_torch.meshgen import (beam_line, plate_shell,
                                         solid_shell_strip)

SOLVER = ("!SOLVER, METHOD=CG, PRECOND=1, ITERLOG=NO, TIMELOG=NO\n"
          " 20000, 1\n {resid}, 1.0, 0.0\n")


def warped_plate(n, etype, a=1000.0, thick=50.0, amp=0.15, seed=4,
                 **kw):
    """``plate_shell`` with every node moved in-plane and out of plane by
    up to ``amp`` of an element's width (seeded), the edges kept on their
    lines: distorted, warped elements."""
    return plate_shell(n, etype=etype, a=a, thick=thick, warp=amp,
                       seed=seed, **kw)


def strip(nx=8, etype=741):
    """The shell cantilever strip of ``tests/test_shell_dynamics.py``:
    2 x 0.25 in x-y, thickness 0.1, E 1e6, nu 0, rho 1; X0 the clamped
    end, X1 the free end."""
    return plate_shell(nx, 1, etype=etype, a=2.0, b=0.25, thick=0.1,
                       youngs=1.0e6, poisson=0.0, density=1.0)


def fiber_beam(ne=4, L=1.0, r=0.05):
    """The 641 cantilever of ``test_beam_641_fiber_stress_cantilever``:
    a round section of radius r, fiber radius and angles in the
    extended ELASTIC row."""
    area, iy = np.pi * r * r, np.pi * r ** 4 / 4.0
    return beam_line(641, ne, L, (0.0, 0.0, 1.0, area, iy, iy, 2 * iy),
                     (210e9, 0.3, r, 0.0, 90.0, 180.0, 270.0, 45.0, 135.0),
                     density=7.8e3)


def solid_shell(etype=781, nx=4):
    """The solid-shell cantilever of ``tests/test_solid_shell.py``."""
    return solid_shell_strip(etype, nx)


def deck(sol="STATIC", bc=" EDGE, 1, 6, 0.0\n", loads="", extra="",
         resid="1.0e-8", write="!WRITE, RESULT\n"):
    """A deck: the !BOUNDARY rows ``bc``, the load cards ``loads``, more
    cards ``extra`` and the CG solver at ``resid``."""
    return ("!VERSION\n 3\n!SOLUTION, TYPE=" + sol + "\n!BOUNDARY\n" + bc
            + loads + extra + SOLVER.format(resid=resid) + write + "!END\n")


def run_both(path, mesh, cnt, ngroups=("EDGE",), seed=3):
    """The deck through the port and the JAX package on the CPU, the
    mesh's nodes shuffled; returns (port output, JAX output, port dir,
    JAX dir) of ``run_directory``."""
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
