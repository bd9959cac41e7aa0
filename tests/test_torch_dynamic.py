"""The DYNAMIC slice of the port (``analysis/dynamic.py``) against the JAX
package's, on the CPU: the HRZ lumped mass, the nodal diagonal blocks
and block-Jacobi preconditioner of ``femop``, the amplitude factor, the
rate-BC split (a deck with a dof listed twice), explicit central
difference decks, ``run_directory`` end to end for one explicit and one
implicit deck (0.log, dyna_*.out, ``.res`` snapshots), the physics
checks of ``tests/test_rate_bc.py`` on the port, ``!WRITE, VISUAL``
every FREQUENCY steps, and the refusal of everything the slice leaves
out.  The implicit Newmark decks are in
``test_torch_dynamic_implicit.py``.

Meshes: ``box_tet4(3, 2, 2)``, its tet10 raise and ``box_hex8(3, 2,
2)`` (unit boxes), steel in N, mm, s; explicit dt 4e-9 s, about a
sixth of the critical step.  Bars: mass 1e-14 relative per dof; femop
1e-13; explicit u, v, a 1e-10 of each field's largest magnitude.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import frontistr_tpu.run as jrun
from frontistr_tpu.analysis import dynamic as jdyn
from frontistr_tpu.assembly import femop as jfemop
from frontistr_tpu.assembly.model import build_struct_model as jbuild
from frontistr_tpu.io.ctrlio import read_cnt as jread_cnt
from frontistr_tpu.io.resfile import read_result_any as jread_result
from frontistr_tpu_torch.__main__ import main
from frontistr_tpu_torch.analysis import dynamic as dyn
from frontistr_tpu_torch.assembly import femop
from frontistr_tpu_torch.assembly.model import build_struct_model
from frontistr_tpu_torch.elements.tables import get_table
from frontistr_tpu_torch.io import logio
from frontistr_tpu_torch.io.ctrlio import read_cnt
from frontistr_tpu_torch.io.meshio import Amplitude, Equation
from frontistr_tpu_torch.io.neu import write_static_workdir
from frontistr_tpu_torch.io.resfile import read_result_any
from frontistr_tpu_torch.meshgen import box_hex8, box_tet4
from frontistr_tpu_torch.run import run_directory

from _torch_decks import dyn_deck, tet10_box, top_faces, write_deck
from _torch_vis_decks import VISUAL, assert_pictures_close, run_pair

RAMP = [(0.0, 0.0), (4.0e-8, 1.0), (1.0e-7, 1.0)]


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("FRONTISTR_TPU_COMPILE_CACHE", "0")
    monkeypatch.setenv("FRONTISTR_TPU_REORDER", "1")
    return monkeypatch


def _mesh(etype, perturb=True):
    """Box mesh of ``etype`` with TOP/STOP groups, the RAMP amplitude
    and (``perturb``) every node moved by up to 5% of the spacing."""
    m = {341: lambda: box_tet4(3, 2, 2), 342: lambda: tet10_box(2, 2, 1),
         361: lambda: box_hex8(3, 2, 2)}[etype]()
    rows = top_faces(m)
    if perturb:
        rng = np.random.default_rng(etype)
        m.coords = m.coords + 0.05 * 0.33 * rng.uniform(-1, 1,
                                                         m.coords.shape)
    m.elem_groups["TOP"] = np.unique(rows[:, 0])
    m.surf_groups["STOP"] = rows
    t, v = np.asarray(RAMP).T
    m.amplitudes["RAMP"] = Amplitude("RAMP", "TABULAR", t, v)
    return m


def _models(tmp_path, mesh, cnt):
    p = tmp_path / "case.cnt"
    p.write_text(cnt)
    return (jbuild(mesh, jread_cnt(str(p))),
            build_struct_model(mesh, read_cnt(str(p)), device="cpu"))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.isfinite(a).all()
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# ---------------- host parts and femop ----------------------------------

@pytest.mark.parametrize("etype", [341, 342, 361])
def test_lumped_mass_matches_jax(tmp_path, etype):
    """HRZ lumped mass per dof within 1e-14 of the JAX package's, and
    its total is density x volume (the volume from the element's own
    quadrature, exact for these straight-sided elements: the tet10's
    mid-edge nodes stay at the middle)."""
    mesh = _mesh(etype, perturb=etype != 342)
    jm, pm = _models(tmp_path, mesh, dyn_deck())
    want = np.asarray(jdyn.lumped_mass_vector(jm))
    got = dyn.lumped_mass_vector(pm).numpy()
    assert got.shape == want.shape == (3 * mesh.n_node,)
    assert want.min() > 0.0
    assert np.abs(got / want - 1.0).max() <= 1e-14
    b = pm.blocks[0]
    table = get_table(etype)
    x = pm.coords[b.conn]
    J = np.einsum("qni,enj->eqij", table.dN, x)
    vol = (np.abs(np.linalg.det(J)) * table.weights).sum()
    assert abs(got.sum() / 3 / (7.85e-9 * vol) - 1.0) <= 1e-13


@pytest.mark.parametrize("etype", [341, 361])
def test_diag_blocks_and_block_jacobi_match_jax(tmp_path, etype):
    """``FEOperator.diag_blocks`` and ``block_jacobi(c1, c2 m)`` on random
    symmetric element matrices, against the JAX package's, within 1e-13
    of the largest magnitude; fixed dofs pass through unchanged."""
    mesh = _mesh(etype)
    jm, pm = _models(tmp_path, mesh, dyn_deck())
    b = pm.blocks[0]
    m = b.dofs.shape[1]
    rng = np.random.default_rng(7)
    a = rng.standard_normal((len(b.elem_ids), m, m))
    kes = np.einsum("eij,ekj->eik", a, a) + m * np.eye(m)
    mass = rng.uniform(1.0, 2.0, pm.n_dof_total)
    r = rng.standard_normal(pm.n_dof_total)
    jop = jfemop.from_model(jm, [jnp.asarray(kes)])
    op = femop.from_model(pm, [torch.as_tensor(kes)])
    assert _rel(op.diag_blocks().numpy(), np.asarray(jop.diag_blocks())) \
        <= 1e-13
    c1, c2 = 1.5, 3.0e3
    want = np.asarray(jop.block_jacobi(c1, c2 * jnp.asarray(mass))(
        jnp.asarray(r)))
    got = op.block_jacobi(c1, c2 * torch.as_tensor(mass))(
        torch.as_tensor(r)).numpy()
    assert _rel(got, want) <= 1e-13
    fixed = np.asarray(pm.fixed_dofs)
    assert len(fixed) and np.array_equal(got[fixed], r[fixed])


def test_amplitude_factor_matches_jax(tmp_path):
    """The amplitude factor at every breakpoint, between them and past
    both ends (clamped), and 1 for an unnamed or unknown amplitude."""
    mesh = _mesh(341)
    jm, pm = _models(tmp_path, mesh, dyn_deck())
    ts = [-1.0, 0.0, 1.0e-8, 4.0e-8, 7.0e-8, 1.0e-7, 2.0e-7]
    for name in ("RAMP", "", "NONE"):
        got = [dyn._amp_factory(pm.mesh, pm.cfg)(name)(t) for t in ts]
        want = [jdyn._amp_factory(jm.mesh, jm.cfg)(name)(t) for t in ts]
        assert got == want
    assert got == [1.0] * len(ts)
    ramp = [dyn._amp_factory(pm.mesh, pm.cfg)("RAMP")(t) for t in ts]
    assert ramp == [0.0, 0.0, 0.25, 1.0, 1.0, 1.0, 1.0]


def test_rate_bc_split_matches_jax(tmp_path):
    """``_rate_bc_split`` of !VELOCITY cards, initial and prescribed,
    with dofs listed twice (a group, then a node of it with another
    value): the same (dofs, values, amplitude) as the JAX package, and
    the device set keeps the last value as ``.at[].set`` does."""
    mesh = _mesh(361)
    node = int(mesh.node_ids[mesh.node_groups["X1"][0]])
    loads = (f"!VELOCITY, TYPE=INITIAL\n ALL, 3, 3, -2.0\n {node}, 3, 3, "
             f"5.0\n!VELOCITY, AMP=RAMP\n X1, 1, 3, -0.5\n {node}, 2, 2, "
             "0.25\n")
    jm, pm = _models(tmp_path, mesh, dyn_deck(loads=loads))
    make_p = dyn._amp_factory(pm.mesh, pm.cfg)
    make_j = jdyn._amp_factory(jm.mesh, jm.cfg)
    got = dyn._rate_bc_split(pm, pm.cfg.velocities, make_p)
    want = jdyn._rate_bc_split(jm, jm.cfg.velocities, make_j)
    for g, w in zip(got, want):
        assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
        assert len(np.unique(g[0])) < len(g[0])          # duplicates
    assert got[1][3] == want[1][3] == "RAMP"
    assert got[1][2](2.0e-8) == want[1][2](2.0e-8) == 0.5
    n = pm.n_dof_total
    for entry in got:
        rs = dyn._RateSet(entry, torch.device("cpu"))
        assert len(rs.idx) == len(np.unique(entry[0]))
        want_set = np.asarray(jnp.zeros(n).at[jnp.asarray(entry[0])].set(
            jnp.asarray(entry[1])))
        assert np.array_equal(
            rs.set(torch.zeros(n, dtype=torch.float64), rs.vals).numpy(),
            want_set)


# ---------------- explicit central difference ---------------------------

EXPLICIT = {
    "cload_amplitude": (341, "!CLOAD, AMP=RAMP\n X1, 3, -1.0\n", 0.0),
    "dload_pressure": (361, "!DLOAD\n TOP, P2, 5.0\n", 0.0),
    "initial_velocity": (342, "!VELOCITY, TYPE=INITIAL\n ALL, 3, 3, -2.0"
                         "\n X1, 1, 1, 0.5\n!CLOAD\n X1, 3, -1.0\n", 0.0),
    "prescribed_velocity": (361, "!VELOCITY, AMP=RAMP\n X1, 3, 3, -0.5\n",
                            0.0),
    "prescribed_acceleration": (341, "!ACCELERATION\n X1, 3, 3, -3.0e7\n"
                                "!ACCELERATION, TYPE=INITIAL\n ALL, 1, 1,"
                                " 1.0e6\n", 0.0),
    "rayleigh_mass": (361, "!CLOAD, AMP=RAMP\n X1, 3, -1.0\n", 2.0e7),
}


@pytest.mark.parametrize("case", list(EXPLICIT))
def test_explicit_matches_jax(tmp_path, env, case):
    """30 explicit steps: u, v, a within 1e-10 of each field's largest
    magnitude, and the monitor rows (every 5 steps) likewise."""
    etype, loads, ray_m = EXPLICIT[case]
    mesh = _mesh(etype)
    monit = int(mesh.node_ids[mesh.node_groups["X1"][-1]])
    jm, pm = _models(tmp_path, mesh, dyn_deck(
        11, n_step=30, loads=loads, ray_m=ray_m, monit=monit, every=5))
    want = jdyn.run_dynamic(jm)
    got = dyn.run_dynamic(pm)
    assert got.arm == "explicit" and got.steps == want.steps == 30
    for f in ("u", "vel", "acc"):
        assert np.abs(getattr(want, f)).max() > 0.0
        assert _rel(getattr(got, f), getattr(want, f)) <= 1e-10, f
    assert np.array_equal(got.monitors["step"], want.monitors["step"])
    assert np.array_equal(got.monitors["time"], want.monitors["time"])
    for k in ("disp", "velo", "acce"):
        assert _rel(got.monitors[k], want.monitors[k]) <= 1e-10, k


# ---------------- run_directory end to end ------------------------------

def _read_table(path):
    return np.asarray([[float(v) for v in ln.split()]
                       for ln in open(path) if ln.strip()])


def _summary_values(path):
    """0.log Global Summary as {name: (max, min)} (node ids left out:
    a symmetric box ties, and argmax breaks ties by node order)."""
    return logio.parse_log_summaries(path)["Node"]


E2E = {
    "explicit": (341, dict(eqa=11, n_step=20, loads="!CLOAD, AMP=RAMP\n"
                           " X1, 3, -1.0\n!VELOCITY\n Z1, 1, 1, 0.25\n",
                           every=4, write="!WRITE, RESULT, FREQUENCY=10\n"),
                 "1e-10", True),
    "implicit": (361, dict(eqa=1, n_step=4, dt=1.0e-7, ray_m=1.0e4,
                           ray_k=1.0e-8, every=1, loads="!CLOAD, AMP=RAMP"
                           "\n X1, 3, -1.0\n", resid="1.0e-10",
                           write="!WRITE, RESULT, FREQUENCY=2\n"),
                 "1e-8", False),
}


@pytest.mark.parametrize("case", list(E2E))
def test_run_directory_matches_jax(tmp_path, env, case):
    """The deck through both runners (the port's explicit deck through
    the CLI, its .res binary): the 0.log summary values at print
    precision, the dyna_*.out
    rows (step, time and node id equal, values at print precision) and
    the ``.res`` snapshot of every FREQUENCY step (and only those), each
    component within the bar of its largest value."""
    etype, kw, bar, cli = E2E[case]
    mesh = _mesh(etype, perturb=False)
    monit = int(mesh.node_ids[mesh.node_groups["X1"][-1]])
    wd = write_deck(tmp_path / "port", mesh, dyn_deck(monit=monit, **kw),
                    amplitudes={"RAMP": RAMP})
    if cli:     # the explicit deck writes the binary format
        ctl = os.path.join(wd, "hecmw_ctrl.dat")
        with open(ctl) as fh:
            text = fh.read().replace("IO=OUT", "IO=OUT, TYPE=BINARY")
        with open(ctl, "w") as fh:
            fh.write(text)
    wj = str(tmp_path / "jax")
    shutil.copytree(wd, wj)
    want = jrun.run_directory(wj)
    if cli:
        assert main(["--device", "cpu", wd]) == 0
    got = run_directory(wd, device="cpu")
    assert got["_snapshots"] == want["_snapshots"] and got["_snapshots"]
    sg, sw = _summary_values(os.path.join(wd, "0.log")), \
        _summary_values(os.path.join(wj, "0.log"))
    assert list(sg) == list(sw) and "A3" in sg and "SMS" in sg
    for k in sw:
        assert np.allclose(sg[k], sw[k], rtol=2e-4, atol=0.0), k
    for name in ("disp", "velo", "acce"):
        tg = _read_table(os.path.join(wd, f"dyna_{name}.out"))
        tw = _read_table(os.path.join(wj, f"dyna_{name}.out"))
        assert tg.shape == tw.shape and len(tg) == kw["n_step"] // \
            kw["every"]
        assert np.array_equal(tg[:, [0, 2]], tw[:, [0, 2]])
        assert np.allclose(tg[:, 1:], tw[:, 1:], rtol=2e-4,
                           atol=2e-4 * np.abs(tw[:, 3:]).max())
    files = sorted(f for f in os.listdir(wj) if f.startswith("mesh.res"))
    assert files == sorted(f for f in os.listdir(wd)
                           if f.startswith("mesh.res"))
    steps = sorted(int(f.rsplit(".", 1)[1]) for f in files)
    assert steps == list(range(2 if case == "implicit" else 10,
                               kw["n_step"] + 1,
                               2 if case == "implicit" else 10))
    for f in files:
        rg = read_result_any(os.path.join(wd, f))
        rw = jread_result(os.path.join(wj, f))
        assert np.array_equal(rg["node_ids"], rw["node_ids"])
        names = [c[0] for c in rw["node_comps"]]
        assert names == [c[0] for c in rg["node_comps"]] == \
            ["DISPLACEMENT", "VELOCITY", "ACCELERATION"]
        for (_, a), (_, b) in zip(rg["node_comps"], rw["node_comps"]):
            assert _rel(a, b) <= float(bar)


def test_implicit_restart_matches_jax(tmp_path, env):
    """Implicit Newmark with !RESTART, FREQUENCY=2 (formerly refused):
    both packages leave their step train for the Newton loop and write
    a checkpoint every second step; the fields and the checkpoints
    agree."""
    from frontistr_tpu.io.restart import load_restart as jload
    mesh = _mesh(361, perturb=False)
    cnt = dyn_deck(eqa=1, n_step=4, dt=2e-6, loads="!CLOAD\n X1, 3, -1.0\n",
                   resid="1.0e-10").replace(
        "!END\n", "!RESTART, FREQUENCY=2\n!END\n")
    wd = write_deck(tmp_path / "port", mesh, cnt)
    wj = str(tmp_path / "jax")
    shutil.copytree(wd, wj)
    want = jrun.run_directory(wj)["dynamic"]
    got = run_directory(wd, device="cpu")["dynamic"]
    assert got.arm == "newton"
    for a, b in ((got.u, want.u), (got.vel, want.vel),
                 (got.acc, want.acc)):
        assert _rel(a, np.asarray(b).reshape(a.shape)) <= 1e-8
    ck = jload(os.path.join(wd, "restart.npz"))
    assert int(ck["i"]) == 4
    assert _rel(ck["u"], np.asarray(want.u).reshape(-1)) <= 1e-8


# ---------------- physics (tests/test_rate_bc.py on the port) -----------

def _run_port(tmp_path, cnt, mesh=None):
    p = tmp_path / "case.cnt"
    p.write_text(cnt)
    model = build_struct_model(mesh or box_hex8(1, 1, 1),
                               read_cnt(str(p)), device="cpu")
    return model, dyn.run_dynamic(model)


def _rate_deck(eqa, n_step, dt, rate, boundary=True, nu="0.0",
               step_extra=""):
    bnd = "!BOUNDARY, GRPID=1\n Z0, 1, 3, 0.0\n" if boundary else ""
    step = "!STEP, SUBSTEPS=1, CONVERG=1.0e-10\n" + \
        (" BOUNDARY, 1\n" if boundary else "") + step_extra
    return (f"!VERSION\n 3\n!SOLUTION, TYPE=DYNAMIC\n!DYNAMIC\n {eqa}, 1\n"
            f" 0.0, {n_step * dt}, {n_step}, {dt}\n 0.5, 0.25\n"
            f" 1, 1, 0.0, 0.0\n 10\n{bnd}{rate}{step}!MATERIAL, NAME=M1\n"
            f"!ELASTIC\n 1000.0, {nu}\n!DENSITY\n 1.0\n"
            "!SOLVER,METHOD=CG,PRECOND=1\n 10000, 1\n 1.0e-12, 1.0, 0.0\n"
            "!END\n")


@pytest.mark.parametrize("eqa,n_step,dt,v", [(1, 5, 0.01, -1.0),
                                             (11, 5, 1.0e-4, -2.0)])
def test_initial_velocity_rigid_drift(tmp_path, eqa, n_step, dt, v):
    """Free cube with v0 in z and no load: the rigid drift u_z = v0 t
    (Newmark and central difference are exact for it)."""
    _, out = _run_port(tmp_path, _rate_deck(
        eqa, n_step, dt, f"!VELOCITY, TYPE=INITIAL\n ALL, 3, 3, {v}\n",
        boundary=False, nu="0.3"))
    np.testing.assert_allclose(out.u[:, 2], v * n_step * dt, rtol=1e-8)
    if eqa == 1:
        np.testing.assert_allclose(out.vel[:, 2], v, rtol=1e-8)
        assert np.abs(out.u[:, :2]).max() < 1e-12


@pytest.mark.parametrize("eqa,n_step,dt", [(1, 8, 0.01), (11, 40, 1.0e-4)])
def test_prescribed_velocity_tracks_rate(tmp_path, eqa, n_step, dt):
    """!VELOCITY on the top face with the base fixed: implicit, the
    Newmark relation gives u_n = v (t - dt/2) (the rate ramps on over
    the first step); explicit, u_{n+1} = u_{n-1} + 2 dt v telescopes to
    u_n = v t; the velocity reaches v exactly in both."""
    v = -0.5
    model, out = _run_port(tmp_path, _rate_deck(
        eqa, n_step, dt, f"!VELOCITY, GRPID=1\n Z1, 3, 3, {v}\n"),
        mesh=box_hex8(1, 1, 2))
    top = model.mesh.node_groups["Z1"]
    t = n_step * dt - (0.5 * dt if eqa == 1 else 0.0)
    np.testing.assert_allclose(out.u[top, 2], v * t, rtol=1e-9)
    np.testing.assert_allclose(out.vel[top, 2], v, rtol=1e-9)


def test_prescribed_acceleration_explicit(tmp_path):
    """Explicit !ACCELERATION: u_{n+1} = 2 u_n - u_{n-1} + dt^2 a sums to
    u_n = a dt^2 n (n + 1) / 2 exactly."""
    n_step, a, dt = 40, -30.0, 1.0e-4
    model, out = _run_port(tmp_path, _rate_deck(
        11, n_step, dt, f"!ACCELERATION, GRPID=1\n Z1, 3, 3, {a}\n"),
        mesh=box_hex8(1, 1, 2))
    top = model.mesh.node_groups["Z1"]
    np.testing.assert_allclose(out.u[top, 2],
                               a * dt * dt * n_step * (n_step + 1) / 2.0,
                               rtol=1e-9)


# ---------------- what the slice leaves out ------------------------------

def _equation(mesh):
    n = mesh.node_groups["X1"][:2]
    mesh.equations = [Equation(np.asarray(n), np.asarray([3, 3]),
                               np.asarray([1.0, -1.0]), 0.0)]
    return mesh


def _etype(etype):
    def make(mesh):
        mesh.blocks[0].etype = etype
        mesh.blocks[0].conn_hecmw = None
        return mesh
    return make


def test_write_visual_matches_jax(tmp_path, env, capsys):
    """``!WRITE, VISUAL, FREQUENCY=2`` on an explicit deck (formerly
    refused): the JAX runner's file set, ``result.<step>.bmp`` every
    second step, each PSR picture within ``_torch_vis_decks``' bar (one
    level a byte, 0.1% of the pixels further apart)."""
    mesh = _mesh(341, perturb=False)
    cnt = dyn_deck(11, n_step=4, loads="!CLOAD, AMP=RAMP\n X1, 3, -1.0\n"
                   "!VELOCITY\n Z1, 1, 1, 0.25\n",
                   write=VISUAL.format(freq=", FREQUENCY=2", method="PSR",
                                       more=""))
    wd = write_deck(tmp_path / "port", mesh, cnt, amplitudes={"RAMP": RAMP})
    got, want, wj = run_pair(wd)
    assert "visualizer skipped" not in capsys.readouterr().out
    assert got["dynamic"].steps == want["dynamic"].steps == 4
    files = sorted(f for f in os.listdir(wj) if f.endswith(".bmp"))
    assert files == ["result.2.bmp", "result.4.bmp"]
    assert files == sorted(f for f in os.listdir(wd) if f.endswith(".bmp"))
    for f in files:
        assert_pictures_close(os.path.join(wd, f), os.path.join(wj, f))


UNPORTED = {
    # name: (deck keyword arguments, extra cards, env ({tmp}: the test's
    # directory), mesh edit, message[, exception: NotImplementedError])
    "contact": ({}, "!CONTACT, GRPID=1\n CP1, 1, 0.0\n", {}, None,
                "CONTACT"),
    # the JAX package drops both without effect (ROADMAP fault 2)
    "equation": ({}, "", {}, _equation, "EQUATION in explicit dynamics"),
    "spring": ({"eqa": 1}, "!SPRING\n 1, 3, 10.0\n", {}, None, "SPRING"),
    # sharded implicit dynamics runs (tests/test_torch_shard_families.py);
    # the explicit run (this deck) under sharding is refused by name
    "shards": ({}, "", {"FRONTISTR_TPU_SHARDS": "2"}, None,
               "explicit dynamics under FRONTISTR_TPU_SHARDS"),
    # coupling is ported: without a peer the run waits out the timeout
    "coupler": ({}, "!COUPLE, TYPE=1\n WET\n",
                {"FRONTISTR_TPU_COUPLE_DIR": "{tmp}/cpl",
                 "FRONTISTR_TPU_COUPLE_TIMEOUT": "0.1"}, None,
                "coupling peer file not found", TimeoutError),
    "eigenread": ({}, "!EIGENREAD\n eigen.log\n 1, 2\n", {}, None,
                  "EIGENREAD"),
    # the id predates the shell port: the case is the truss 301
    "shell_731": ({}, "", {}, _etype(301), "301"),
}


@pytest.mark.parametrize("case", list(UNPORTED))
def test_unported_dynamic_requests_raise(tmp_path, env, case):
    """Each feature of the JAX package's dynamics outside the slice
    raises NotImplementedError naming itself through ``run_directory``;
    a coupled deck whose peer never answers raises TimeoutError."""
    kw, extra, envs, edit, msg, *exc = UNPORTED[case]
    for k, v in envs.items():
        env.setenv(k, v.format(tmp=tmp_path))
    cnt = dyn_deck(kw.get("eqa", 11), n_step=2, loads=extra)
    mesh = box_tet4(2, 2, 1)
    if edit is not None:
        mesh = edit(mesh)
    wd = str(tmp_path / "wd")
    write_static_workdir(wd, mesh, cnt, ngroups=("X0", "X1", "Z1"))
    with pytest.raises(exc[0] if exc else NotImplementedError, match=msg):
        run_directory(wd, device="cpu")
