"""Top-level analysis runner (torch port of the STATIC / NLSTATIC /
DYNAMIC / HEAT / EIGEN / STATICEIGEN dispatch of ``frontistr_tpu/run.py``;
reference fstr_main, fistr1/src/main/fistr_main.f90:38-114): read the
control files, reorder, run the analysis on the chosen device, write
``0.log`` and ``FSTR.msg`` (and ``FSTR.sta`` for the Newton driver).

A linear-elastic STATIC deck runs the linear static analysis; NLSTATIC,
or any deck with geometric nonlinearity, a !PLASTIC material or a
!CONTACT card on a mesh !CONTACT PAIR, runs the Newton driver of
``analysis/nonlinear.py``; DYNAMIC (time history) runs
``analysis/dynamic.py``, implicit Newmark or explicit central
difference, with ``dyna_*.out`` monitor files beside the log; a DYNAMIC
deck with ``idx_resp = 2`` is a frequency response by modal
superposition (``analysis/freq.py``), its modes from ``!EIGENREAD`` files
or an in-process Lanczos run; HEAT runs ``analysis/heat.py``, steady or
transient; EIGEN the shift-invert Lanczos of ``analysis/eigen.py``;
STATICEIGEN the Newton driver and then Lanczos about its converged
tangent.  ``!TEMPERATURE, READRESULT=n`` imports the nodal temperatures
of a heat run's result files (the fstrTEMP binding) as the thermal load.
``!WRITE, RESULT`` writes ``<!RESULT name>.0.<step>``, text or
(``TYPE=BINARY``) binary, as the JAX runner does: the final static
result as step 1; a dynamic run's DISPLACEMENT, VELOCITY and
ACCELERATION and a heat run's TEMPERATURE every FREQUENCY steps (and at
the last step); one file a mode for EIGEN.  FRONTISTR_TPU_USER_MODULE
names a Python file that registers umat/uload hooks in
``frontistr_tpu_torch.user``; it is imported before the analysis.
``!RESTART, FREQUENCY=n`` checkpoints the Newton driver (NLSTATIC and the
STATIC decks it takes), implicit dynamics and transient heat every n
substeps or steps into the ``hecmw_ctrl.dat`` !RESTART file (else
``restart``) with ``.npz`` appended; n > 0 deletes an old checkpoint
first, n < 0 resumes from it; the other analyses ignore the card, as the
JAX runner does.  ``!ECHO`` prepends the mesh and deck dump to 0.log
(``io/echo.py``).  DYNAMIC on a mesh with a u-p flow block (3414) runs
the SUPG/PSPG stepper of ``analysis/flow.py`` (no StructModel), its
``.res`` always text with VELOCITY, PRESSURE, STRAIN_RATE and STRESS.
ELEMCHECK and PRECHECK write the element quality summary to 0.log
(``precheck.py``); NZPROF also writes ``nonzero.dat.000`` and its
gnuplot script ``nonzero.plt.000`` in the work directory.

The mesh front end reads ``!MESH, TYPE=`` HECMW-ENTIRE (the default),
ABAQUS (``io/abaqusio.py``), NASTRAN (``io/nastranio.py``), GEOFEM
(``io/geofemio.py``) or HECMW-DIST (``io/distio.py``: the file ``<p>``,
or every rank file ``<p>.0``, ``<p>.1``, ... reassembled into one
model), refines it ``REFINE=n`` times (``io/refine.py``) and reorders
it, in the JAX runner's order; an unknown type raises
``NotImplementedError``.  A static run on a partitioned work directory
writes ``<!RESULT name>.<rank>.1`` for every rank, its owned nodes and
elements.  ``!WRITE, VISUAL`` renders after a static run (STATIC,
NLSTATIC, STATICEIGEN) and every ``!WRITE, VISUAL, FREQUENCY`` steps of
heat and dynamics (``result.<step>.bmp``): the ``!VISUAL`` PSR surface
on the host (``vis/psf.py``), the PVR volume on the run's device
(``vis/pvr.py``), or an AVS UCD ``.inp`` (``io/ucd.py``).  A deck the
host code cannot draw prints ``### visualizer skipped: ...``, as the JAX
runner does; an error of the device render propagates.  ``FSTR.dbg.0``
in the work directory keeps the JAX runner's breadcrumbs
(``io/dbgfile.py``).  ``FRONTISTR_TPU_PROFILE=<dir>`` runs the analysis
under ``torch.profiler`` (CUDA activity on the card) and writes its
Chrome trace ``<dir>/trace.json``.

Several devices (``parallel/dist.py``): ``FRONTISTR_TPU_SHARDS=n``
spawns n ranks (``auto``: one a card), each running the deck in a
``torch.distributed`` group, and returns rank 0's output;
``FRONTISTR_TPU_SHARDS=1`` runs the sharded code with a group of one;
under ``torchrun`` or ``FRONTISTR_TPU_COORDINATOR`` /
``_NUM_PROCESSES`` / ``_PROCESS_ID`` the process joins its group before
any device use (the JAX runner's ``multihost.maybe_init_distributed``).
The sharded families are linear STATIC, NLSTATIC (contact included),
implicit DYNAMIC, EIGEN and HEAT (``parallel/shard.py``); the others
(!RESTART, explicit dynamics, frequency response, STATICEIGEN, the u-p
flow) raise ``NotImplementedError`` naming themselves.  Rank 0 alone writes
the run's files (0.log, FSTR.sta, FSTR.msg, results, pictures); every
rank writes its ``FSTR.dbg.<rank>``.  A partitioned work directory is
ordered by (rank, RCM) under sharding (``ordering.partition_reorder``),
so the ranks' contiguous rows fall on the partition.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time
import types

import numpy as np
import torch

from frontistr_tpu_torch import device as devmod
from frontistr_tpu_torch import ordering, user
from frontistr_tpu_torch.analysis.dynamic import run_dynamic
from frontistr_tpu_torch.analysis.eigen import run_eigen
from frontistr_tpu_torch.analysis.flow import run_flow, write_flow_result
from frontistr_tpu_torch.analysis.freq import (load_eigenread,
                                               run_frequency,
                                               run_static_eigen)
from frontistr_tpu_torch.analysis.heat import run_heat
from frontistr_tpu_torch.analysis.nonlinear import run_nonlinear_static
from frontistr_tpu_torch.analysis.static import run_linear_static
from frontistr_tpu_torch.assembly.model import build_struct_model
from frontistr_tpu_torch.fem import material as mat
from frontistr_tpu_torch.io import logio
from frontistr_tpu_torch.io.abaqusio import read_abaqus
from frontistr_tpu_torch.io.ctrlio import read_cnt
from frontistr_tpu_torch.io.dbgfile import dbg, dbg_close, dbg_open
from frontistr_tpu_torch.io.distio import mesh_from_dist_ranks, read_dist
from frontistr_tpu_torch.io.echo import prepend_echo
from frontistr_tpu_torch.io.geofemio import read_geofem
from frontistr_tpu_torch.io.hecmw_ctrl import read_hecmw_ctrl
from frontistr_tpu_torch.io.meshio import read_mesh
from frontistr_tpu_torch.io.nastranio import read_nastran
from frontistr_tpu_torch.io.refine import refine_mesh
from frontistr_tpu_torch.io.resfile import (read_result_any, write_result,
                                            write_result_bin,
                                            write_static_result)
from frontistr_tpu_torch.parallel import dist
from frontistr_tpu_torch.precheck import nzprof, precheck
from frontistr_tpu_torch.vis import psf

# the mesh checks of fstr_main kstPRECHECK / kstNZPROF
PRECHECK_TYPES = ("ELEMCHECK", "PRECHECK", "NZPROF")
# the mesh readers of '!MESH, TYPE=' (hecmw_ctrl.dat)
_READERS = {"HECMW-ENTIRE": read_mesh, "": read_mesh, "ABAQUS": read_abaqus,
            "NASTRAN": read_nastran, "GEOFEM": read_geofem}
# the host errors of a deck the visualizer cannot draw (a !VISUAL
# parameter it cannot read, a component the result lacks); they are
# printed and skipped, as the JAX runner skips every error of its
# visualizer.
# A device error of the PVR render (pvr.DeviceRenderError, a torch
# RuntimeError) is none of these and propagates.
_VISUAL_SKIPPED = (AttributeError, KeyError, IndexError, TypeError,
                   ValueError, ArithmeticError)


def _check_request(ctrl, cfg) -> None:
    sol = cfg.solution_type.upper()
    if sol not in ("STATIC", "NLSTATIC", "DYNAMIC", "HEAT", "EIGEN",
                   "STATICEIGEN") + PRECHECK_TYPES:
        raise NotImplementedError(f"solution type {sol}")
    if dist.current() is not None:
        _check_sharded(cfg)


def _check_sharded(cfg) -> None:
    """What a sharded run does not run raises, naming itself (before
    any rank is started where the deck alone tells)."""
    sol = cfg.solution_type.upper()
    what = None
    if cfg.restart is not None:
        what = "!RESTART"
    elif sol == "STATICEIGEN":
        what = "STATICEIGEN"
    elif sol == "DYNAMIC" and cfg.dynamic is not None and \
            cfg.dynamic.idx_resp == 2:
        what = "frequency response"
    elif sol == "DYNAMIC" and cfg.dynamic is not None and \
            cfg.dynamic.idx_eqa == 11:
        what = "explicit dynamics"
    if what:
        raise NotImplementedError(f"{what} under FRONTISTR_TPU_SHARDS")


def read_run_mesh(ctrl, timings: dict, dev):
    """The mesh front end (``frontistr_tpu/run.py:65-115``): read the
    !MESH entry by its TYPE, refine it REFINE times, reorder it.
    Returns (mesh, partinfo); partinfo is None unless a HECMW-DIST work
    directory holds several ranks (then the ranks' ownership, as
    ``distio.mesh_from_dist_ranks`` returns it).  ``timings`` gains
    ``read``, ``refine`` and ``reorder``."""
    mb = ctrl.mesh()
    mtype = mb.params.get("TYPE", "HECMW-ENTIRE").upper()
    if mtype not in _READERS and mtype != "HECMW-DIST":
        raise NotImplementedError(f"!MESH TYPE={mtype}")
    partinfo = None
    with devmod.Phase(timings, "read", dev):
        if mtype == "HECMW-DIST":
            mesh, partinfo, n_files = _read_dist_ranks(ctrl.path(mb))
        else:
            mesh = _READERS[mtype](ctrl.path(mb))
    if partinfo:
        print(f"### HECMW-DIST: reassembled {n_files} ranks -> "
              f"{mesh.n_node} nodes, {mesh.n_elem} elements")
    refine = int(mb.params.get("REFINE", "0") or 0)
    if refine > 0:
        with devmod.Phase(timings, "refine", dev):
            mesh = refine_mesh(mesh, refine)
        print(f"### mesh refined x{refine}: {mesh.n_node} nodes, "
              f"{mesh.n_elem} elements")
    with devmod.Phase(timings, "reorder", dev):
        if partinfo and dist.current() is not None:
            # the JAX runner's order under sharding (run.py:113-116):
            # by (rank, RCM), the ranks' rows on the partition
            mesh = ordering.partition_reorder(mesh, partinfo)
        else:
            mesh = ordering.maybe_reorder(mesh)
    dbg(f"mesh read: {mesh.n_node} nodes, {mesh.n_elem} elements, "
        f"type={mtype or 'HECMW-ENTIRE'}")
    return mesh, partinfo


def _read_dist_ranks(path: str):
    """A partitioned work directory: the file ``path``, else every rank
    file ``path.0``, ``path.1``, ... (the reference runs one process a
    file; here the ranks are reassembled into one model and the
    partition drives the per-rank result files).  Returns (mesh,
    partinfo, number of files)."""
    if os.path.exists(path):
        paths = [path]
    else:
        paths = []
        while os.path.exists(f"{path}.{len(paths)}"):
            paths.append(f"{path}.{len(paths)}")
        if not paths:
            raise FileNotFoundError(path)
    mesh, partinfo = mesh_from_dist_ranks([read_dist(q) for q in paths])
    return mesh, partinfo, len(paths)


@contextlib.contextmanager
def _profiled(dev):
    """``FRONTISTR_TPU_PROFILE=<dir>``: the counterpart of the JAX
    runner's ``jax.profiler.trace(dir)`` (``frontistr_tpu/run.py:201-206,
    410-411``), ``torch.profiler`` over the analysis, with CUDA activity
    when the run's device is the card; writes the Chrome trace
    ``<dir>/trace.json``."""
    prof_dir = os.environ.get("FRONTISTR_TPU_PROFILE")
    if not prof_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(prof_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(prof_dir, "trace.json"))
    print(f"### torch profiler trace written to {prof_dir}")


def _visual(label: str, fn, *args, **kw):
    """One !WRITE, VISUAL output; a deck the host code cannot draw prints
    ``### visualizer skipped<label>: ...`` and returns None."""
    try:
        return fn(*args, **kw)
    except _VISUAL_SKIPPED as e:
        print(f"### visualizer skipped{label}: {e}")
        return None


def _restart_kw(ctrl, cfg, workdir) -> dict:
    """'!RESTART, FREQUENCY=n' (``frontistr_tpu/run.py:184-196``): the
    checkpoint path, the ``hecmw_ctrl.dat`` !RESTART entry or
    ``workdir/restart``, with ``.npz`` appended; n > 0 writes every n
    (sub)steps from a fresh start (an old checkpoint is deleted), n < 0
    resumes from the checkpoint and then writes every |n|."""
    if cfg.restart is None:
        return {}
    freq = cfg.restart.iparam("FREQUENCY", 1)
    rb = ctrl.restart()
    path = (ctrl.path(rb) if rb is not None
            else os.path.join(workdir, "restart")) + ".npz"
    if freq > 0 and os.path.exists(path):
        os.remove(path)
    return dict(restart_path=path, restart_freq=abs(freq))


def run_directory(workdir: str, log_name: str = "0.log",
                  device="cuda") -> dict:
    """Run the analysis configured by ``workdir/hecmw_ctrl.dat`` on
    ``device``.  Returns a dict with the mesh, deck and model (the
    ``HeatModel`` of a heat run: ``out["heat"].solver.model``), the
    result under its analysis's key: "static" (a ``StaticResult``; its
    ``timings`` hold every phase's seconds, its ``newton`` the Newton
    driver's stats), "dynamic" (a ``DynamicResult``), "heat" (a
    ``HeatResult``), "eigen" (an ``EigenResult``; STATICEIGEN has both
    "static" and "eigen"), "freq" (a ``FreqResult``), "flow" (a
    ``FlowResult``; no "model"), "precheck" (a ``PrecheckReport``) and
    "nzprof" (the NZPROF dump's counts and paths); "partition" (the
    ranks' ownership of a partitioned HECMW-DIST work directory, else
    None); "visual" (the path a static run's !WRITE, VISUAL wrote);
    "_snapshots", the steps whose result file was written during a
    transient run; "timings" (seconds by phase), "log_path" and
    "total_time".

    FRONTISTR_TPU_SHARDS=n (n > 1) spawns n ranks that run the deck
    (``run_rank``) and returns rank 0's output, its tensors on the host;
    under torchrun or FRONTISTR_TPU_COORDINATOR the process joins its
    group first and runs as its rank."""
    dev_type = torch.device(device).type
    comm = dist.maybe_init_distributed(dev_type)
    if comm is not None:
        return _run(workdir, log_name, comm.device)
    n = dist.requested_shards(dev_type)
    if n == 0:
        return _run(workdir, log_name, device)
    devmod.resolve(device)
    ctrl = read_hecmw_ctrl(os.path.join(workdir, "hecmw_ctrl.dat"))
    _check_sharded(read_cnt(ctrl.path(ctrl.control())))
    if n > 1:
        print(f"### FRONTISTR_TPU_SHARDS={n}: starting {n} ranks on "
              f"{dev_type}", flush=True)
        return dist.spawn(run_rank, (workdir, log_name), n, dev_type,
                          workdir)
    dist.set_current(dist.single(devmod.resolve(device)))
    try:
        return _run(workdir, log_name, dist.current().device)
    finally:
        dist.set_current(None)


def run_rank(workdir: str, log_name: str = "0.log") -> dict:
    """A rank's run of the deck in its group (the entry point of the
    spawned ranks): ``run_directory``'s output on the rank's device."""
    return _run(workdir, log_name, dist.current().device)


def _run(workdir: str, log_name: str, device) -> dict:
    dev = devmod.resolve(device)
    t_start = time.time()
    timings: dict = {}
    comm = dist.current()
    rank = 0 if comm is None else comm.rank
    # FSTR.dbg.<rank> (fistr_main.f90:193); the other files are rank
    # 0's: a rank above 0 logs into a private directory it removes
    dbg_open(workdir, rank)
    private = None if dist.is_writer() else \
        tempfile.mkdtemp(prefix=f"fstr_rank{rank}_")
    try:
        ctrl = read_hecmw_ctrl(os.path.join(workdir, "hecmw_ctrl.dat"))
        cfg = read_cnt(ctrl.path(ctrl.control()))
        _check_request(ctrl, cfg)
        # the user plug-in module (umat / uload), FRONTISTR_TPU_USER_MODULE
        user.load_user_module()
        mesh, partinfo = read_run_mesh(ctrl, timings, dev)
        _read_temperature_result(ctrl, cfg, mesh)
        log_path = os.path.join(private or workdir, log_name)
        out = {"mesh": mesh, "cfg": cfg, "ctrl": ctrl, "timings": timings,
               "log_path": log_path, "partition": partinfo}
        dbg(f"setup done ({time.time() - t_start:.2f} s); solution type "
            f"{cfg.solution_type.upper()}")
        with _profiled(dev):
            t_pre, results = _analyse(workdir, out, dev)
            if cfg.echo:
                # !ECHO: the mesh and deck dump at the top of the log
                # (static_echo.f90 / heat_echo.f90 write through ILOG)
                prepend_echo(log_path, mesh, cfg)
        total = time.time() - t_start
        _write_msg(private or workdir, t_pre - t_start, total)
        out.update(results, total_time=total)
        dbg(f"analysis completed ({total:.2f} s)")
        return out
    finally:
        dbg_close()
        if private:
            shutil.rmtree(private, ignore_errors=True)


def _analyse(workdir, out, dev):
    """The analysis of the deck ``out["cfg"]`` on ``out["mesh"]``, its
    result files and pictures.  Returns (the clock at the end of the
    set-up, the results to add to ``out``)."""
    ctrl, cfg, mesh = out["ctrl"], out["cfg"], out["mesh"]
    timings, log_path = out["timings"], out["log_path"]
    sol = cfg.solution_type.upper()
    d = cfg.dynamic
    if sol in PRECHECK_TYPES:
        return time.time(), _run_precheck(
            sol, mesh, os.path.dirname(log_path), log_path)
    if sol == "DYNAMIC" and not (d is not None and d.idx_resp == 2) and \
            any(b.etype == 3414 for b in mesh.blocks):
        # u-p flow meshes take the SUPG/PSPG stepper (fstr_dynamic_
        # nlimplicit + the 3414 arm of dynamic_mat_ass_load)
        if dist.current() is not None:
            raise NotImplementedError("the u-p flow stepper under "
                                      "FRONTISTR_TPU_SHARDS")
        t_pre = time.time()
        fr = run_flow(mesh, cfg, log_path=log_path, device=dev,
                      timings=timings)
        if cfg.write_result and ctrl.result() is not None:
            with devmod.Phase(timings, "result", dev):
                write_flow_result(ctrl.path(ctrl.result()) +
                                  f".0.{fr.steps}", mesh, fr, step=fr.steps)
        return t_pre, dict(flow=fr)
    rkw = _restart_kw(ctrl, cfg, workdir)
    if sol == "HEAT":
        return time.time(), _run_heat(ctrl, cfg, mesh, workdir, log_path,
                                      dev, timings, rkw)
    with devmod.Phase(timings, "model", dev):
        model = build_struct_model(mesh, cfg, device=dev)
    t_pre = time.time()
    out["model"] = model
    if sol == "DYNAMIC" and d is not None and d.idx_resp == 2:
        return t_pre, dict(freq=_run_frequency(ctrl, cfg, model, workdir,
                                               log_path))
    if sol == "DYNAMIC":
        cb, written = _snapshot_cb(ctrl, cfg, _dynamic_result_writer, mesh,
                                   _dynamic_picture(mesh, workdir, cfg, dev,
                                                    timings))
        dr = run_dynamic(model, log_path=log_path, on_interval=cb, **rkw)
        dr.timings.update(timings)
        if cfg.write_result and ctrl.result() is not None and \
                dr.steps not in written and dist.is_writer():
            with devmod.Phase(timings, "result", dev):
                _dynamic_result_writer(ctrl, mesh)(dr.steps, None, dr.u,
                                                   dr.vel, dr.acc)
        return t_pre, dict(dynamic=dr, _snapshots=written)
    if sol == "EIGEN":
        er = run_eigen(model, log_path=log_path)
        if cfg.write_result and ctrl.result() is not None and \
                dist.is_writer():
            with devmod.Phase(timings, "result", dev):
                _write_modes(ctrl, mesh, model, er)
        return t_pre, dict(eigen=er)
    got = {}
    if sol == "STATICEIGEN":
        # fstr_main kstSTATICEIGEN (fistr_main.f90:84-85): the EGLIST
        # block is appended to the Newton driver's 0.log
        res, got["eigen"] = run_static_eigen(model, log_path=log_path,
                                             timings=timings)
    elif sol == "NLSTATIC" or cfg.nlgeom or _needs_newton(model) or \
            (cfg.contacts and mesh.contact_pairs):
        # a contact deck takes the Newton driver's contact loop, its
        # material linear or not (the reference's fstr_Newton_contact*)
        res = run_nonlinear_static(model, log_path=log_path,
                                   timings=timings, **rkw)
    else:
        res = run_linear_static(model, timings)
        logio.write_static_log(
            log_path, 1, model.dim, np.asarray(res.u), res.nodal_strain,
            res.nodal_stress, res.nodal_mises, res.elem_strain,
            res.elem_stress, res.elem_mises, mesh.node_ids, res.elem_ids,
            node_count=res.node_count)
    if cfg.write_visual and dist.is_writer():
        # in-situ picture (!WRITE, VISUAL + !VISUAL; static_output.f90)
        got["visual"] = _visual("", psf.visualize, mesh, model, res,
                                workdir, cfg, device=dev, timings=timings)
    if cfg.write_result and ctrl.result() is not None and dist.is_writer():
        with devmod.Phase(timings, "result", dev):
            _write_static_results(ctrl, mesh, model, res, out["partition"])
    got["static"] = res
    return t_pre, got


def _write_static_results(ctrl, mesh, model, res, partinfo) -> None:
    """``<!RESULT name>.0.1``, text or (``TYPE=BINARY``) binary
    (hecmw_control.c:1235-1275); a partitioned work directory instead
    writes ``<name>.<rank>.1`` for every rank with that rank's owned
    nodes and elements (the reference's per-process output, which
    fstr_rmerge reassembles; ``frontistr_tpu/run.py:350-363``)."""
    rb = ctrl.result()
    base = ctrl.path(rb)
    binary = rb.params.get("TYPE", "TEXT").upper() == "BINARY"
    if not partinfo:
        write_static_result(base + ".0.1", mesh, model, res, step=1,
                            binary=binary)
        return
    nrank = np.asarray([partinfo["node_rank"][int(g)]
                        for g in mesh.node_ids])
    erank = np.asarray([partinfo["elem_rank"].get(int(e), 0)
                        for e in np.asarray(res.elem_ids)])
    for r in range(partinfo["n_ranks"]):
        write_static_result(base + f".{r}.1", mesh, model, res, step=1,
                            binary=binary, node_sel=nrank == r,
                            elem_sel=erank == r)


def _read_temperature_result(ctrl, cfg, mesh) -> None:
    """'!TEMPERATURE, READRESULT=n[,SSTEP=s][,INTERVAL=i]': the nodal
    temperatures of the fstrTEMP result binding's last snapshot
    ``<base>.0.<k>`` (k = s, s+i, ... <= n; readtemp.f90
    read_temperature_result) become ``cfg.temp_read_field``, in mesh
    order; nodes the file does not name stay at REFTEMP.  Without the
    binding or a file, nothing is imported, as in the JAX runner."""
    tr = [c for c in cfg.temperatures if c.iparam("READRESULT", 0) > 0]
    rb = ctrl.result("fstrTEMP") if tr else None
    if rb is None:
        return
    base = ctrl.path(rb)
    c0 = tr[0]
    last = None
    for k in range(c0.iparam("SSTEP", 1), c0.iparam("READRESULT", 1) + 1,
                   c0.iparam("INTERVAL", 1)):
        if os.path.exists(f"{base}.0.{k}"):
            last = f"{base}.0.{k}"
    if last is None:
        return
    comps = read_result_any(last)
    vals = np.asarray(comps["node_comps"][0][1]).reshape(-1)
    T = np.full(mesh.n_node, cfg.reftemp, float)
    for nid, v in zip(comps["node_ids"], vals):
        idx = mesh.id2idx.get(int(nid))
        if idx is not None:
            T[idx] = v
    cfg.temp_read_field = T


def _run_heat(ctrl, cfg, mesh, workdir, log_path, dev, timings,
              rkw) -> dict:
    cb, written = _snapshot_cb(ctrl, cfg, _heat_result_writer, mesh,
                               _heat_picture(mesh, workdir, cfg, dev,
                                             timings))
    hr = run_heat(mesh, cfg, log_path=log_path, on_interval=cb, device=dev,
                  timings=timings, **rkw)
    if cfg.write_result and ctrl.result() is not None and \
            hr.steps not in written and dist.is_writer():
        # the final state, when the cadence did not write it
        with devmod.Phase(timings, "result", dev):
            _heat_result_writer(ctrl, mesh)(hr.steps, None, hr.T)
    return dict(heat=hr, _snapshots=written)


def _run_precheck(sol, mesh, workdir, log_path) -> dict:
    """fstr_main kstPRECHECK / kstNZPROF (fistr_main.f90:86,
    fstr_precheck.f90): the element quality summary, printed and written
    to 0.log; NZPROF also dumps the node graph's nonzero profile and its
    gnuplot script into the work directory."""
    rep = precheck(mesh)
    print(" ****   STAGE PreCheck  **")
    print(rep.summary())
    with open(log_path, "w") as fh:
        fh.write(" ****   STAGE PreCheck  **\n")
        fh.write(rep.summary() + "\n")
    got = {"precheck": rep}
    if sol == "NZPROF":
        prof = nzprof(mesh, workdir)
        got["nzprof"] = prof
        print(f" ### nonzero profile: N={prof['n']} "
              f"NNZ={prof['nnz']} density={prof['density_pct']:.3e}%")
        print(" ### Command recommendation")
        print(f' gnuplot -persist "{os.path.basename(prof["plt"])}"')
    return got


def _run_frequency(ctrl, cfg, model, workdir, log_path):
    """Frequency response (fstr_frequency_analysis): the !DYNAMIC row-2
    fields are the frequency window (f_start, f_end, n_points), Rayleigh
    from row 4; the modes from the !EIGENREAD files, else an in-process
    Lanczos run; the 0.log table of the amplitude maxima."""
    d = cfg.dynamic
    eig_in = None
    if cfg.eigenread is not None:
        eig_in = load_eigenread(cfg.eigenread, workdir, ctrl, model)
    fr = run_frequency(model, d.t_start, d.t_end, n_freq=max(d.n_step, 1),
                       ray_alpha=d.ray_m, ray_beta=d.ray_k,
                       eigen_result=eig_in)
    with open(log_path, "w") as fh:
        fh.write(" FREQUENCY RESPONSE (modal superposition)\n")
        if cfg.eigenread is not None:
            fh.write("  modes imported via !EIGENREAD\n" if eig_in
                     is not None else
                     "  EIGENREAD files missing; modes recomputed "
                     "in-process\n")
        fh.write("  freq        disp_amp_max  vel_amp_max   "
                 "acc_amp_max\n")
        for k in range(len(fr.freqs)):
            fh.write(f"  {fr.freqs[k]:12.4E}{fr.disp_amp_max[k]:14.6E}"
                     f"{fr.vel_amp_max[k]:14.6E}"
                     f"{fr.acc_amp_max[k]:14.6E}\n")
    return fr


def _write_modes(ctrl, mesh, model, er) -> None:
    """One result file a mode, ``<base>.0.<k>`` with the mode's
    DISPLACEMENT and its frequency in the header."""
    base, wr = _result_sink(ctrl)
    eids = np.concatenate([b.elem_ids for b in mesh.blocks])
    for k in range(er.eigenvectors.shape[1]):
        phi = er.eigenvectors[:, k].reshape(mesh.n_node, model.ndof)
        wr(base + f".0.{k+1}",
           f"*fstrresult eigen mode={k+1} freq={er.freq[k]:.6e}",
           mesh.node_ids, eids, [("DISPLACEMENT", phi[:, :3])], [])


def _result_sink(ctrl):
    """(path base, writer) of the !RESULT binding: text, or binary with
    ``TYPE=BINARY`` (hecmw_control.c:1235-1275)."""
    rb = ctrl.result()
    return ctrl.path(rb), (write_result_bin if rb.params.get(
        "TYPE", "TEXT").upper() == "BINARY" else write_result)


def _snapshot_cb(ctrl, cfg, writer, mesh, picture):
    """The JAX runner's per-interval output (``_snapshot_cb``,
    ``frontistr_tpu/run.py:418-469``; heat_solve_TRAN.f90:268-270 and
    fstr_solve_dynamic's cadence): ``cb(step, t, *fields)`` writes the
    step's result file through ``writer(ctrl, mesh)`` every !WRITE,
    RESULT FREQUENCY steps and draws ``picture(step, *fields)`` every
    !WRITE, VISUAL FREQUENCY steps.  Returns (cb, the steps whose result
    file was written); cb is None without either card."""
    rfreq = cfg.result_frequency if (cfg.write_result and
                                     ctrl.result() is not None) else 0
    vfreq = cfg.visual_frequency if cfg.write_visual else 0
    if not dist.is_writer():
        rfreq = vfreq = 0
    written: set = set()
    if not rfreq and not vfreq:
        return None, written
    write = writer(ctrl, mesh) if rfreq else None

    def cb(step, t, *fields):
        if rfreq and step % rfreq == 0:
            write(step, t, *fields)
            written.add(step)
        if vfreq and step % vfreq == 0:
            _visual(f" at step {step}", picture, step, *fields)
    return cb, written


def _heat_picture(mesh, workdir, cfg, dev, timings):
    """``picture(step, T)``: the temperature on the undeformed surface
    (or the PVR volume), ``result.<step>.bmp``."""
    def picture(step, T):
        if isinstance(T, torch.Tensor):
            T = T.cpu().numpy()
        return psf.visualize_scalar(mesh, T, workdir, cfg,
                                    basename=f"result.{step}", device=dev,
                                    timings=timings)
    return picture


def _dynamic_picture(mesh, workdir, cfg, dev, timings):
    """``picture(step, u, vel, acc)``: the deformed surface (or the PVR
    volume) of the step's displacement, ``result.<step>.bmp``; the
    result holds only ``u``, as the JAX runner's shim does, so a
    !VISUAL component other than the displacement is skipped."""
    def picture(step, u, *_):
        shim = types.SimpleNamespace(
            u=np.asarray(u).reshape(mesh.n_node, -1))
        return psf.visualize(mesh, None, shim, workdir, cfg,
                             basename=f"result.{step}", device=dev,
                             timings=timings)
    return picture


def _dynamic_result_writer(ctrl, mesh):
    """``write(step, t, u, vel, acc)``: ``<!RESULT name>.0.<step>`` with
    DISPLACEMENT, VELOCITY and ACCELERATION; ``t`` None leaves the time
    out of the header."""
    base, wr = _result_sink(ctrl)
    eids = np.concatenate([b.elem_ids for b in mesh.blocks])

    def write(step, t, *fields):
        u, v, a = (np.asarray(x).reshape(mesh.n_node, -1) for x in fields)
        head = f"*fstrresult dynamic step={step}" + \
            (f" time={t:.6e}" if t is not None else "")
        wr(base + f".0.{step}", head, mesh.node_ids, eids,
           [("DISPLACEMENT", u[:, :3]), ("VELOCITY", v[:, :3]),
            ("ACCELERATION", a[:, :3])], [])
    return write


def _heat_result_writer(ctrl, mesh):
    """``write(step, t, T)``: ``<!RESULT name>.0.<step>`` with the nodal
    TEMPERATURE (T a host array or a device tensor); ``t`` None leaves
    the time out of the header."""
    base, wr = _result_sink(ctrl)
    eids = np.concatenate([b.elem_ids for b in mesh.blocks])

    def write(step, t, T):
        if isinstance(T, torch.Tensor):
            T = T.cpu().numpy()
        head = f"*fstrresult heat step={step}" + \
            (f" time={t:.6e}" if t is not None else "")
        wr(base + f".0.{step}", head, mesh.node_ids, eids,
           [("TEMPERATURE", np.asarray(T).reshape(-1, 1))], [])
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
