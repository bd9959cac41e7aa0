"""Top-level analysis runner (torch port of the STATIC / NLSTATIC /
DYNAMIC dispatch of ``frontistr_tpu/run.py``; reference fstr_main,
fistr1/src/main/fistr_main.f90:38-114): read the control files, reorder,
run the analysis on the chosen device, write ``0.log`` and ``FSTR.msg``
(and ``FSTR.sta`` for the Newton driver).

A linear-elastic STATIC deck runs the linear static analysis; NLSTATIC,
or any deck with geometric nonlinearity or a !PLASTIC material, runs the
Newton driver of ``analysis/nonlinear.py``; DYNAMIC (time history) runs
``analysis/dynamic.py``, implicit Newmark or explicit central
difference, with ``dyna_*.out`` monitor files beside the log.
``!WRITE, RESULT`` writes ``<!RESULT name>.0.<step>``, text or
(``TYPE=BINARY``) binary, as the JAX runner does: the final static
result as step 1, a dynamic run's DISPLACEMENT, VELOCITY and
ACCELERATION every FREQUENCY steps (and at the last step).  Everything
else the JAX runner dispatches (heat, eigen, frequency response, u-p
flow, visualization output, restart, sharding, profiling, user modules)
raises ``NotImplementedError`` naming what was asked for.
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
from frontistr_tpu_torch.io.resfile import (write_result, write_result_bin,
                                            write_static_result)

# JAX-package switches whose feature this slice does not carry
_UNPORTED_ENV = ("FRONTISTR_TPU_SHARDS", "FRONTISTR_TPU_PROFILE",
                 "FRONTISTR_TPU_USER_MODULE", "FRONTISTR_TPU_COORDINATOR")


def _check_request(ctrl, cfg) -> None:
    for name in _UNPORTED_ENV:
        if os.environ.get(name, "") not in ("", "0"):
            raise NotImplementedError(f"{name} (not in the torch port yet)")
    sol = cfg.solution_type.upper()
    if sol not in ("STATIC", "NLSTATIC", "DYNAMIC"):
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
    seconds, its ``newton`` the Newton driver's stats) or the
    ``DynamicResult`` under "dynamic" (with "_snapshots", the steps whose
    result file was written during the run), and "total_time"."""
    from frontistr_tpu_torch.analysis.dynamic import run_dynamic
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
    if cfg.solution_type.upper() == "DYNAMIC" and \
            any(b.etype == 3414 for b in mesh.blocks):
        raise NotImplementedError("u-p flow meshes (3414) in DYNAMIC")
    with devmod.Phase(timings, "reorder", dev):
        mesh = ordering.maybe_reorder(mesh)
    with devmod.Phase(timings, "model", dev):
        model = build_struct_model(mesh, cfg, device=dev)
    t_pre = time.time()
    log_path = os.path.join(workdir, log_name)
    out = {"mesh": mesh, "cfg": cfg, "ctrl": ctrl, "model": model}
    if cfg.solution_type.upper() == "DYNAMIC":
        cb, written = _snapshot_cb(ctrl, cfg, mesh)
        dr = run_dynamic(model, log_path=log_path, on_interval=cb)
        dr.timings.update(timings)
        if cfg.write_result and ctrl.result() is not None and \
                dr.steps not in written:
            with devmod.Phase(dr.timings, "result", dev):
                _dynamic_result_writer(ctrl, mesh)(dr.steps, None, dr.u,
                                                   dr.vel, dr.acc)
        total = time.time() - t_start
        _write_msg(workdir, t_pre - t_start, total)
        out.update(dynamic=dr, _snapshots=written, total_time=total)
        return out
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
    out.update(static=res, total_time=total)
    return out


def _snapshot_cb(ctrl, cfg, mesh):
    """The result half of the JAX runner's per-interval output
    (``_snapshot_cb``; fstr_solve_dynamic's result cadence):
    ``cb(step, t, u, vel, acc)`` writes the step's result file every
    !WRITE, RESULT FREQUENCY steps.  Returns (cb, written steps); cb is
    None without !WRITE, RESULT."""
    rfreq = cfg.result_frequency if (cfg.write_result and
                                     ctrl.result() is not None) else 0
    written: set = set()
    if not rfreq:
        return None, written
    write = _dynamic_result_writer(ctrl, mesh)

    def cb(step, t, *fields):
        if step % rfreq == 0:
            write(step, t, *fields)
            written.add(step)
    return cb, written


def _dynamic_result_writer(ctrl, mesh):
    """``write(step, t, u, vel, acc)``: ``<!RESULT name>.0.<step>`` with
    DISPLACEMENT, VELOCITY and ACCELERATION, text or (``TYPE=BINARY``)
    binary; ``t`` None leaves the time out of the header."""
    rb = ctrl.result()
    base = ctrl.path(rb)
    wr = write_result_bin if rb.params.get("TYPE", "TEXT").upper() == \
        "BINARY" else write_result
    eids = np.concatenate([b.elem_ids for b in mesh.blocks])

    def write(step, t, *fields):
        u, v, a = (np.asarray(x).reshape(mesh.n_node, -1) for x in fields)
        head = f"*fstrresult dynamic step={step}" + \
            (f" time={t:.6e}" if t is not None else "")
        wr(base + f".0.{step}", head, mesh.node_ids, eids,
           [("DISPLACEMENT", u[:, :3]), ("VELOCITY", v[:, :3]),
            ("ACCELERATION", a[:, :3])], [])
    return write


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
