"""Top-level analysis runner (torch port of the STATIC / NLSTATIC
dispatch of ``frontistr_tpu/run.py``; reference fstr_main,
fistr1/src/main/fistr_main.f90:38-114): read the control files, reorder,
run the analysis on the chosen device, write ``0.log`` and ``FSTR.msg``
(and ``FSTR.sta`` for the Newton driver).

A linear-elastic STATIC deck runs the linear static analysis; NLSTATIC,
or any deck with geometric nonlinearity or a !PLASTIC material, runs the
Newton driver of ``analysis/nonlinear.py``.  ``!WRITE, RESULT`` writes
the final result as ``<!RESULT name>.0.1``, text or (``TYPE=BINARY``)
binary, as the JAX runner does.  Everything else the JAX runner
dispatches (heat, eigen, dynamic, visualization output, restart,
sharding, profiling, user modules) raises ``NotImplementedError`` naming
what was asked for.
"""

from __future__ import annotations

import os
import time

import numpy as np

from frontistr_tpu_torch import device as devmod
from frontistr_tpu_torch import ordering
from frontistr_tpu_torch.fem import material as mat
from frontistr_tpu_torch.io import logio
from frontistr_tpu_torch.io.ctrlio import read_cnt
from frontistr_tpu_torch.io.hecmw_ctrl import read_hecmw_ctrl
from frontistr_tpu_torch.io.meshio import read_mesh
from frontistr_tpu_torch.io.resfile import write_static_result

# JAX-package switches whose feature this slice does not carry
_UNPORTED_ENV = ("FRONTISTR_TPU_SHARDS", "FRONTISTR_TPU_PROFILE",
                 "FRONTISTR_TPU_USER_MODULE", "FRONTISTR_TPU_COORDINATOR")


def _check_request(ctrl, cfg) -> None:
    for name in _UNPORTED_ENV:
        if os.environ.get(name, "") not in ("", "0"):
            raise NotImplementedError(f"{name} (not in the torch port yet)")
    sol = cfg.solution_type.upper()
    if sol not in ("STATIC", "NLSTATIC"):
        raise NotImplementedError(f"solution type {sol}")
    for flag, card in ((cfg.write_visual, "!WRITE, VISUAL"),
                       (cfg.restart is not None, "!RESTART"),
                       (cfg.echo, "!ECHO")):
        if flag:
            raise NotImplementedError(f"{card} card")


def run_directory(workdir: str, log_name: str = "0.log",
                  device="cuda") -> dict:
    """Run the analysis configured by ``workdir/hecmw_ctrl.dat`` on
    ``device``.  Returns a dict with the mesh, deck, model, the
    ``StaticResult`` under "static" (its ``timings`` hold every phase's
    seconds, its ``newton`` the Newton driver's stats) and
    "total_time"."""
    from frontistr_tpu_torch.analysis.nonlinear import run_nonlinear_static
    from frontistr_tpu_torch.analysis.static import run_linear_static
    from frontistr_tpu_torch.assembly.model import build_struct_model
    dev = devmod.resolve(device)
    t_start = time.time()
    timings: dict = {}
    ctrl = read_hecmw_ctrl(os.path.join(workdir, "hecmw_ctrl.dat"))
    mb = ctrl.mesh()
    mtype = mb.params.get("TYPE", "HECMW-ENTIRE").upper()
    if mtype not in ("HECMW-ENTIRE", ""):
        raise NotImplementedError(f"!MESH TYPE={mtype}")
    if int(mb.params.get("REFINE", "0") or 0) > 0:
        raise NotImplementedError("!MESH REFINE")
    cfg = read_cnt(ctrl.path(ctrl.control()))
    _check_request(ctrl, cfg)
    with devmod.Phase(timings, "read", dev):
        mesh = read_mesh(ctrl.path(mb))
    with devmod.Phase(timings, "reorder", dev):
        mesh = ordering.maybe_reorder(mesh)
    with devmod.Phase(timings, "model", dev):
        model = build_struct_model(mesh, cfg, device=dev)
    t_pre = time.time()
    log_path = os.path.join(workdir, log_name)
    if cfg.solution_type.upper() == "NLSTATIC" or cfg.nlgeom or \
            _needs_newton(model):
        res = run_nonlinear_static(model, log_path=log_path,
                                   timings=timings)
    else:
        res = run_linear_static(model, timings)
        logio.write_static_log(
            log_path, 1, model.dim, np.asarray(res.u), res.nodal_strain,
            res.nodal_stress, res.nodal_mises, res.elem_strain,
            res.elem_stress, res.elem_mises, mesh.node_ids, res.elem_ids,
            node_count=res.node_count)
    if cfg.write_result and ctrl.result() is not None:
        rb = ctrl.result()
        # '!RESULT, ..., TYPE=BINARY' selects the binary format
        # (hecmw_control.c:1235-1275; text is the default)
        with devmod.Phase(timings, "result", dev):
            write_static_result(
                ctrl.path(rb) + ".0.1", mesh, model, res, step=1,
                binary=rb.params.get("TYPE", "TEXT").upper() == "BINARY")
    total = time.time() - t_start
    _write_msg(workdir, t_pre - t_start, total)
    return {"mesh": mesh, "cfg": cfg, "ctrl": ctrl, "model": model,
            "static": res, "total_time": total}


def _needs_newton(model) -> bool:
    """A block whose material is not linear elastic takes the Newton
    driver, a STATIC deck included."""
    return any(b.material.mtype != mat.ELASTIC or
               b.material.nlgeom != mat.INFINITESIMAL for b in model.blocks)


def _write_msg(workdir: str, t_pre: float, t_total: float) -> None:
    """FSTR.msg banner + timing block (fistr_main.f90:219-231, 100-104)."""
    with open(os.path.join(workdir, "FSTR.msg"), "w") as fh:
        fh.write(" :========================================:\n")
        fh.write(" :**   BEGIN FSTR Structural Analysis   **:\n")
        fh.write(" :========================================:\n")
        fh.write(" ====================================\n")
        fh.write(f"     TOTAL TIME (sec) :{t_total:10.2f}\n")
        fh.write(f"            pre (sec) :{t_pre:10.2f}\n")
        fh.write(f"          solve (sec) :{t_total - t_pre:10.2f}\n")
        fh.write(" ====================================\n")
