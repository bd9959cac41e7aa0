"""The NLSTATIC (Newton) slice: the port's element programs and Newton
driver against the JAX package's on small tet4 decks (a few hundred
dofs), on the CPU.

- ``BlockPrograms.tangent`` / ``update`` for TOTALLAG, UPDATELAG and
  INFINITESIMAL at random displacements and states, and ``_qforce``:
  within 1e-12 relative, float64 (the same arithmetic in another
  summation order).
- Whole decks through ``run_directory`` / the port's CLI and the JAX
  package's ``run_directory``: Newton iterations per substep equal (the
  FSTR.sta files equal), displacements within 1e-8 of max|u|, the 0.log
  Global Summary equal at print precision.  The float64 policy, then the
  mixed policy through the AMG, where the CG counts are held within
  2 + 10% (the float32 inner CG sums in another order; the bar of
  tests/test_torch_hex8.py).
- Two substeps, and a MAXITER that forces cutbacks.
- A substep started from a state the JAX package committed, carried over
  by ``convert.states_from_numpy``.
- The requests the driver used to refuse, held to the JAX package
  (METHOD=GMRES, SSOR, !RESTART among them), and the refusal of what
  it does not carry (sharding).

The node numbering is shuffled and FRONTISTR_TPU_REORDER=1 forces the
RCM reorder, as on the bench deck.
"""

import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import frontistr_tpu.run as jrun
from frontistr_tpu.analysis import nonlinear as jnl
from frontistr_tpu.assembly import femop as jfemop
from frontistr_tpu.assembly import operators as jops
from frontistr_tpu.assembly.model import build_struct_model as jbuild
from frontistr_tpu.io import logio as jlogio
from frontistr_tpu.io.ctrlio import read_cnt as jread_cnt
from frontistr_tpu_torch import convert, ordering
from frontistr_tpu_torch.__main__ import main
from frontistr_tpu_torch.analysis import nonlinear as nl
from frontistr_tpu_torch.assembly import femop
from frontistr_tpu_torch.fem import material as mat
from frontistr_tpu_torch.io.neu import write_static_workdir
from frontistr_tpu_torch.io.meshio import read_mesh
from frontistr_tpu_torch.meshgen import box_hex8, box_tet4
from frontistr_tpu_torch.run import run_directory
from frontistr_tpu_torch.solver import amg

CNT = ("!VERSION\n 3\n!SOLUTION, TYPE=NLSTATIC\n!BOUNDARY\n X0, 1, 3, 0.0\n"
       "!CLOAD\n X1, 3, {load}\n!MATERIAL, NAME=M1\n!ELASTIC{el}\n"
       " 210000.0, 0.3\n!STEP, SUBSTEPS={sub}{step}\n BOUNDARY, 1\n"
       " LOAD, 1\n!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
       " 1.0e-8, 1.0, 0.0\n!END\n")


def _cnt(load=-100.0, sub=1, step="", el=""):
    return CNT.format(load=load, sub=sub, step=step, el=el)


def _workdir(path, cnt, n=(6, 5, 4), mesh=None):
    mesh = box_tet4(*n) if mesh is None else mesh
    order = np.random.default_rng(3).permutation(mesh.n_node)
    write_static_workdir(str(path), ordering.permute_mesh(mesh, order), cnt)
    return str(path)


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", "f64")
    monkeypatch.setenv("FRONTISTR_TPU_REORDER", "1")
    monkeypatch.setenv("FRONTISTR_TPU_COMPILE_CACHE", "0")
    return monkeypatch


def _jax_start_vectors(n0, n1, dtype, device, generator=None):
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    k0, k1 = jax.random.split(jax.random.PRNGKey(11))
    return (torch.as_tensor(np.array(jax.random.normal(k0, (n0,), jd)),
                            device=device),
            torch.as_tensor(np.array(jax.random.normal(k1, (n1,), jd)),
                            device=device))


def _both(tmp_path, cnt, cli=False, **kw):
    """The deck through the JAX package and the port (CLI or
    run_directory); returns (port result, JAX result, port dir, JAX
    dir)."""
    wd = _workdir(tmp_path / "port", cnt, **kw)
    wj = str(tmp_path / "jax")
    shutil.copytree(wd, wj)
    jres = jrun.run_directory(wj)["static"]
    if cli:
        assert main(["--device", "cpu", wd]) == 0
    res = run_directory(wd, device="cpu")["static"]
    return res, jres, wd, wj


def _same_files(wd, wj, name):
    with open(os.path.join(wd, name)) as a, open(os.path.join(wj, name)) as b:
        return a.read() == b.read()


def _assert_match(res, jres, wd, wj):
    uj = np.asarray(jres.u)
    assert res.u.shape == uj.shape and np.isfinite(res.u).all()
    assert np.abs(res.u - uj).max() <= 1e-8 * np.abs(uj).max()
    assert res.iters == int(jres.iters)
    assert _same_files(wd, wj, "FSTR.sta")
    got = jlogio.parse_log_summaries(os.path.join(wd, "0.log"))
    want = jlogio.parse_log_summaries(os.path.join(wj, "0.log"))
    assert got and got == want


# ---------------- element programs -----------------------------------------

def _models(tmp_path, flag, el=""):
    """The JAX model and the port's (``convert.model_from_numpy``) of the
    same deck, the block's strain measure set to ``flag``."""
    wd = _workdir(tmp_path / "m", _cnt(el=el), n=(3, 2, 2))
    mesh = read_mesh(os.path.join(wd, "mesh.msh"))
    jm = jbuild(mesh, jread_cnt(os.path.join(wd, "case.cnt")))
    for b in jm.blocks:
        b.material.nlgeom = flag
    return jm, convert.model_from_numpy(jm, device="cpu")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("flag", [mat.TOTALLAG, mat.UPDATELAG,
                                  mat.INFINITESIMAL])
def test_block_programs_match_jax(tmp_path, flag):
    jm, pm = _models(tmp_path, flag)
    jp = jnl.BlockPrograms(jm, jm.blocks[0])
    pp = nl.BlockPrograms(pm, pm.blocks[0])
    E, nn = jm.blocks[0].conn.shape
    rng = np.random.default_rng(flag)
    u_e = 0.02 * rng.standard_normal((E, nn, 3))
    ddu_e = 0.01 * rng.standard_normal((E, nn, 3))
    st = {k: np.asarray(v) for k, v in
          jnl.init_block_state(jm.blocks[0], jp.table).items()}
    for k in ("stress", "strain_bak", "stress_bak"):
        st[k] = 100.0 * rng.standard_normal(st[k].shape) \
            if "stress" in k else 1e-3 * rng.standard_normal(st[k].shape)
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    pst = convert.states_from_numpy([st], device="cpu")[0]
    kj = jp.tangent(jnp.asarray(u_e), jnp.asarray(ddu_e), jst)
    kp = pp.tangent(torch.as_tensor(u_e), torch.as_tensor(ddu_e), pst)
    assert _rel(kp, kj) <= 1e-12
    nsj, qfj = jp.update(jnp.asarray(u_e), jnp.asarray(ddu_e), jst)
    nsp, qfp = pp.update(torch.as_tensor(u_e), torch.as_tensor(ddu_e), pst)
    assert _rel(qfp, qfj) <= 1e-12
    for k in ("strain", "stress"):
        assert _rel(nsp[k], nsj[k]) <= 1e-12


def test_qforce_matches_jax(tmp_path):
    jm, pm = _models(tmp_path, mat.TOTALLAG)
    jp = [jnl.BlockPrograms(jm, b) for b in jm.blocks]
    pp = [nl.BlockPrograms(pm, b) for b in pm.blocks]
    jst = [jnl.init_block_state(b, p.table) for b, p in zip(jm.blocks, jp)]
    pst = [nl.init_block_state(b, p.table, "cpu")
           for b, p in zip(pm.blocks, pp)]
    rng = np.random.default_rng(4)
    n = jm.n_dof_total
    u, du = 0.01 * rng.standard_normal(n), 0.005 * rng.standard_normal(n)
    inc, total_en = jfemop.build_incidence([b.conn for b in jm.blocks],
                                           jm.n_node)
    qj = jnl._qforce(jm, jp, jst, jnp.asarray(u), jnp.asarray(du),
                     jnp.asarray(inc), [jnp.asarray(b.dofs)
                                        for b in jm.blocks],
                     [b.conn.shape[1] for b in jm.blocks], total_en)
    qp = nl._qforce(pm, pp, pst, torch.as_tensor(u), torch.as_tensor(du),
                    femop.incidence_gather(pm, "cpu"))
    assert _rel(qp, qj) <= 1e-12


# ---------------- whole decks -----------------------------------------------

def test_nlstatic_deck_matches_jax_cli(tmp_path, env, capsys):
    res, jres, wd, wj = _both(tmp_path, _cnt(load=-100.0), cli=True)
    assert "### newton: policy=f64" in capsys.readouterr().out
    _assert_match(res, jres, wd, wj)
    assert res.newton.substeps == 1 and res.iters >= 3
    its = [h["iter"] for h in res.newton.history]
    assert its == list(range(1, res.iters + 1))
    assert res.newton.history[-1]["rres"] < 1e-6
    rj = np.asarray(jres.reaction)
    assert np.abs(res.reaction - rj).max() <= 1e-8 * np.abs(rj).max()


def test_updated_lagrange_deck_matches_jax(tmp_path, env):
    res, jres, wd, wj = _both(tmp_path, _cnt(load=-100.0, el=", CAUCHY"),
                              n=(4, 3, 3))
    assert res.iters >= 3
    _assert_match(res, jres, wd, wj)


@pytest.fixture
def fresh_jax_traces():
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_mixed_policy_amg_matches_jax(tmp_path, env, fresh_jax_traces):
    env.setenv("FRONTISTR_TPU_PRECISION", "mixed")
    env.setenv("FRONTISTR_TPU_AMG_MIN", "100")
    env.setattr(amg, "start_vectors", _jax_start_vectors)
    cg = []
    real = nl.make_constrained_solver

    def spy(*a, **kw):
        solve = real(*a, **kw)
        cg.append(solve)
        return solve
    env.setattr(nl, "make_constrained_solver", spy)
    jcg = []
    jreal = jnl.make_constrained_solver

    def jspy(*a, **kw):
        solve = jreal(*a, **kw)

        def wrapped(*b, **k):
            x = solve(*b, **k)
            jcg.append(int(solve.last_iters))
            return x
        return wrapped
    env.setattr(jnl, "make_constrained_solver", jspy)
    res, jres, wd, wj = _both(tmp_path, _cnt(load=-100.0))
    ours = [h["cg_iters"] for h in res.newton.history]
    assert res.policy == "mixed" and cg and len(ours) == len(jcg)
    for a, b in zip(ours, jcg):
        assert abs(a - b) <= 2 + 0.1 * b
    assert all(h["relres"] <= 1e-8 for h in res.newton.history)
    _assert_match(res, jres, wd, wj)


def test_two_substeps_match_jax(tmp_path, env):
    res, jres, wd, wj = _both(tmp_path, _cnt(load=-100.0, sub=2),
                              n=(4, 3, 3))
    assert res.newton.substeps == 2
    _assert_match(res, jres, wd, wj)


def test_two_steps_match_jax(tmp_path, env):
    """Two !STEPs: a load group held from step 1 and one that ramps in
    step 2 (the cross-step factor rule), each step its own solver."""
    cnt = _cnt(load=-50.0).replace(
        "!STEP, SUBSTEPS=1\n BOUNDARY, 1\n LOAD, 1\n",
        "!CLOAD, GRPID=2\n X1, 2, -30.0\n!STEP, SUBSTEPS=1\n BOUNDARY, 1\n"
        " LOAD, 1\n!STEP, SUBSTEPS=2\n BOUNDARY, 1\n LOAD, 1\n LOAD, 2\n")
    res, jres, wd, wj = _both(tmp_path, cnt, n=(4, 3, 3))
    assert res.newton.substeps == 3
    _assert_match(res, jres, wd, wj)


def test_cutback_matches_jax(tmp_path, env):
    """MAXITER=3 under a load that needs 5 iterations in one substep:
    the substep is cut back (Rc = 0.25) and the rest of the step runs at
    the smaller increment."""
    res, jres, wd, wj = _both(tmp_path,
                              _cnt(load=-400.0, step=", MAXITER=3"),
                              n=(4, 3, 3))
    assert res.newton.cutbacks >= 1
    assert res.newton.substeps > 1
    _assert_match(res, jres, wd, wj)


def test_substep_from_jax_committed_state(tmp_path, env):
    """Substep 2 of 2 from the (u, states) the JAX package committed after
    substep 1: the port's Newton loop and the JAX package's agree."""
    wd = _workdir(tmp_path / "m", _cnt(load=-100.0, sub=2), n=(4, 3, 3))
    mesh = read_mesh(os.path.join(wd, "mesh.msh"))
    jm = jbuild(mesh, jread_cnt(os.path.join(wd, "case.cnt")))
    step = jm.cfg.steps[0]
    n = jm.n_dof_total
    jp = [jnl.BlockPrograms(jm, b) for b in jm.blocks]
    inc, total_en = jfemop.build_incidence([b.conn for b in jm.blocks],
                                           jm.n_node)
    args = (jnp.asarray(inc), [jnp.asarray(b.dofs) for b in jm.blocks],
            [b.conn.shape[1] for b in jm.blocks], total_en, False)
    ufix = jops.full_fixed_vector(n, jm.fixed_dofs, jm.fixed_vals)
    free = jops.make_free_mask(n, jm.fixed_dofs)
    f = jnp.asarray(jm.f_ext)
    st0 = [jnl.init_block_state(b, p.table) for b, p in zip(jm.blocks, jp)]
    ok, du, st1, _, _ = jnl._newton_substep(
        jm, jp, st0, jnp.zeros(n), f, jnp.asarray(free), ufix, 0.0, 0.5,
        step, *args)
    assert ok
    u1 = np.array(du)
    st1 = [{k: np.asarray(v) for k, v in jnl._commit_state(s).items()}
           for s in st1]
    okj, duj, stj, itj, _ = jnl._newton_substep(
        jm, jp, [{k: jnp.asarray(v) for k, v in s.items()} for s in st1],
        jnp.asarray(u1), f, jnp.asarray(free), ufix, 0.5, 1.0, step, *args)

    pm = convert.model_from_numpy(jm, device="cpu")
    pp = [nl.BlockPrograms(pm, b) for b in pm.blocks]
    free_t = torch.as_tensor(free)
    gather = femop.incidence_gather(pm, "cpu")
    solve = nl.make_constrained_solver(pm, free_t, gather, False)
    okp, dup, stp, itp, _ = nl._newton_substep(
        pm, pp, convert.states_from_numpy(st1, device="cpu"),
        torch.as_tensor(u1), torch.as_tensor(jm.f_ext), free_t,
        torch.as_tensor(ufix), 0.5, 1.0, step, gather, solve)
    assert okj and okp and itp == itj >= 2
    assert _rel(dup, duj) <= 1e-8
    assert _rel(stp[0]["stress"], stj[0]["stress"]) <= 1e-8


def test_states_from_numpy_types():
    st = convert.states_from_numpy(
        [dict(stress=np.ones((2, 1, 6), np.float32),
              yielded=np.zeros((2, 1), bool))], device="cpu")[0]
    assert st["stress"].dtype == torch.float64
    assert st["yielded"].dtype == torch.bool


# ---------------- refusals --------------------------------------------------

@pytest.mark.parametrize("what", ["shards"])
def test_unported_requests_raise(tmp_path, env, what):
    """FRONTISTR_TPU_SHARDS=1, which the port used to refuse, runs the
    sharded Newton driver in a group of one: the single run's answer;
    the sharded driver's !CONTACT and !RESTART are still refused by
    name (tests/test_torch_contact_dyn.py, test_torch_static.py)."""
    env.setenv("FRONTISTR_TPU_CACHE_DIR", "0")
    wd = _workdir(tmp_path / "wd", _cnt(), n=(2, 2, 2))
    want = run_directory(wd, device="cpu")["static"]
    env.setenv("FRONTISTR_TPU_SHARDS", "1")
    got = run_directory(wd, device="cpu")["static"]
    np.testing.assert_allclose(got.u, want.u, rtol=0,
                               atol=1e-8 * np.abs(want.u).max())
    assert got.iters == want.iters


@pytest.mark.parametrize("what", ["hex8", "dload", "gmres", "ssor",
                                  "restart"])
def test_formerly_unported_requests_match_jax(tmp_path, env, what):
    """The requests the Newton driver used to refuse: a hex8 mesh (the
    NLSTATIC default formulation, B-bar), a DLOAD card (a BX body force,
    a follower load re-assembled at the deformed geometry), METHOD=GMRES
    (the Newton driver reads the method only to choose DIRECT: CG, as in
    the JAX package), FRONTISTR_TPU_PRECOND=ssor (multicolor block SSOR)
    and !RESTART, FREQUENCY=1 (a checkpoint a substep, the answer
    unchanged)."""
    cnt, mesh = _cnt(), None
    if what == "hex8":
        mesh = box_hex8(4, 3, 3)
    elif what == "dload":
        cnt = cnt.replace("!END\n", "!DLOAD\n ALL, BX, -2000.0\n!END\n")
    elif what == "gmres":
        cnt = cnt.replace("METHOD=CG", "METHOD=GMRES")
    elif what == "ssor":
        env.setenv("FRONTISTR_TPU_PRECOND", "ssor")
    else:
        cnt = _cnt(sub=2).replace("!END\n", "!RESTART, FREQUENCY=1\n!END\n")
    res, jres, wd, wj = _both(tmp_path, cnt, n=(4, 3, 3), mesh=mesh)
    assert res.iters >= 2
    _assert_match(res, jres, wd, wj)
    if what == "restart":
        for d in (wd, wj):
            assert os.path.exists(os.path.join(d, "restart.npz"))


def test_other_materials_raise(tmp_path):
    """A material family the driver does not run raises naming it (the
    hyperelastic, viscoelastic, creep and user materials run now:
    tests/test_torch_hyper.py, test_torch_visco_creep.py,
    test_torch_ortho_user.py)."""
    _, pm = _models(tmp_path, mat.TOTALLAG)
    pm.blocks[0].material.mtype = mat.ORTHOELASTIC
    with pytest.raises(NotImplementedError, match="ORTHOELASTIC"):
        nl.BlockPrograms(pm, pm.blocks[0])
