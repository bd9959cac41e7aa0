"""The plastic / B-bar / F-bar / tet10 / DLOAD / TEMPERATURE slice as a
whole: small decks through ``run_directory`` of the JAX package and of
the port (``python -m frontistr_tpu_torch --device cpu`` for one), on
the CPU in the float64 policy.

Each deck is held to: displacements within 1e-8 of max|u|; equal Newton
iterations (the FSTR.sta files equal); the committed yielded sets equal
and the plastic strains within 1e-8; the 0.log Global Summary equal at
print precision; the ``.res`` file's every component within 1e-8 of its
largest value.  The decks: hex8 B-bar (the NLSTATIC default) under a
Mises law and a follower P2 pressure, yielding in substep 2 only; hex8
F-bar under multilinear hardening with a binary ``.res``; tet10 under
Drucker-Prager and a follower S pressure; a STATIC deck with a dead
DLOAD and a !TEMPERATURE field; a STATIC !PLASTIC deck (hex8 IC under
Mohr-Coulomb, the Newton driver at small strain); a cutback; two
!STEPs with a held and a ramped follower group.  Node numbers are
shuffled and the RCM reorder runs, as on the bench deck.
"""

import os
import shutil

import numpy as np
import pytest

import frontistr_tpu.run as jrun
from frontistr_tpu.analysis import nonlinear as jnl
from frontistr_tpu.io import logio as jlogio
from frontistr_tpu.io.resfile import read_result_any as jread_result
from frontistr_tpu_torch.__main__ import main
from frontistr_tpu_torch.analysis import nonlinear as nl
from frontistr_tpu_torch.io.resfile import read_result_any
from frontistr_tpu_torch.meshgen import box_hex8, box_tet4
from frontistr_tpu_torch.run import run_directory

from _torch_decks import deck, tet10_box, write_deck

MISES = "!PLASTIC, YIELD=MISES, HARDEN=LINEAR\n 250.0, 1000.0\n"


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", "f64")
    monkeypatch.setenv("FRONTISTR_TPU_REORDER", "1")
    monkeypatch.setenv("FRONTISTR_TPU_COMPILE_CACHE", "0")
    return monkeypatch


def _committed(env, module):
    """Spy on ``module._commit_state``: the last committed states."""
    seen = []
    real = module._commit_state

    def spy(s):
        out = real(s)
        seen.append({k: np.asarray(v.cpu() if hasattr(v, "cpu") else v)
                     for k, v in out.items()})
        return out
    env.setattr(module, "_commit_state", spy)
    return seen


def _run_both(tmp_path, env, mesh, cnt, cli=False):
    wd = write_deck(tmp_path / "port", mesh, cnt)
    wj = str(tmp_path / "jax")
    shutil.copytree(wd, wj)
    jst, pst = _committed(env, jnl), _committed(env, nl)
    jres = jrun.run_directory(wj)["static"]
    if cli:
        assert main(["--device", "cpu", wd]) == 0
        del pst[:]
    res = run_directory(wd, device="cpu")["static"]
    return res, jres, wd, wj, pst, jst


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _assert_match(res, jres, wd, wj, pst, jst, newton=True):
    uj = np.asarray(jres.u)
    assert np.isfinite(res.u).all() and _rel(res.u, uj) <= 1e-8
    if newton:
        assert res.iters == int(jres.iters)
        with open(os.path.join(wd, "FSTR.sta")) as a, \
                open(os.path.join(wj, "FSTR.sta")) as b:
            assert a.read() == b.read()
        assert len(pst) == len(jst) > 0
        for a, b in zip(pst[-1:], jst[-1:]):
            assert np.array_equal(a["yielded"], b["yielded"])
            assert np.abs(a["pstrain"] - b["pstrain"]).max() <= \
                1e-8 * max(np.abs(b["pstrain"]).max(), 1e-12)
    got = jlogio.parse_log_summaries(os.path.join(wd, "0.log"))
    want = jlogio.parse_log_summaries(os.path.join(wj, "0.log"))
    assert got and got == want
    rp = read_result_any(os.path.join(wd, "mesh.res.0.1"))
    rj = jread_result(os.path.join(wj, "mesh.res.0.1"))
    assert rp["header"] == rj["header"]
    assert np.array_equal(rp["node_ids"], rj["node_ids"])
    assert np.array_equal(rp["elem_ids"], rj["elem_ids"])
    for part in ("node_comps", "elem_comps"):
        assert [n for n, _ in rp[part]] == [n for n, _ in rj[part]]
        for (_, a), (_, b) in zip(rp[part], rj[part]):
            assert np.abs(a - b).max() <= 1e-8 * max(np.abs(b).max(),
                                                     1e-300)


def _yielded(stats):
    """Yielded gauss points at the last iteration of each substep."""
    last = {}
    for h in stats.history:
        last[(h["step"], h["substep"])] = h["yielded"]
    return [last[k] for k in sorted(last)]


def test_hex8_bbar_mises_follower_matches_jax(tmp_path, env, capsys):
    cnt = deck(loads="!DLOAD\n TOP, P2, 120.0\n", plastic=MISES, sub=2)
    res, jres, wd, wj, pst, jst = _run_both(tmp_path, env,
                                            box_hex8(6, 5, 4), cnt, cli=True)
    assert "### newton: policy=f64" in capsys.readouterr().out
    _assert_match(res, jres, wd, wj, pst, jst)
    assert res.newton.substeps == 2
    y1, y2 = _yielded(res.newton)
    assert y1 == 0 and y2 > 0
    assert pst[-1]["yielded"].sum() == y2
    assert all(h["follower_load"] > 0 for h in res.newton.history)


def test_hex8_fbar_multilinear_binary_matches_jax(tmp_path, env):
    cnt = deck(loads="!DLOAD\n TOP, P2, 120.0\n",
               plastic="!PLASTIC, YIELD=MISES, HARDEN=MULTILINEAR\n"
               " 250.0, 0.0\n 300.0, 0.01\n 320.0, 0.05\n",
               extra="!ELEMOPT, 361=4\n", sub=2)
    wd = write_deck(tmp_path / "port", box_hex8(6, 5, 4), cnt)
    p = os.path.join(wd, "hecmw_ctrl.dat")
    with open(p) as f:
        txt = f.read()
    with open(p, "w") as f:
        f.write(txt.replace("IO=OUT", "IO=OUT, TYPE=BINARY"))
    wj = str(tmp_path / "jax")
    shutil.copytree(wd, wj)
    jst, pst = _committed(env, jnl), _committed(env, nl)
    jres = jrun.run_directory(wj)["static"]
    out = run_directory(wd, device="cpu")
    assert out["model"].blocks[0].formulation == "FBAR"
    with open(os.path.join(wd, "mesh.res.0.1"), "rb") as f:
        assert f.read(19) == b"HECMW_BINARY_RESULT"
    res = out["static"]
    _assert_match(res, jres, wd, wj, pst, jst)
    assert pst[-1]["yielded"].any()


def test_tet10_drucker_prager_follower_s_matches_jax(tmp_path, env):
    cnt = deck(loads="!DLOAD\n STOP, S, 15.0\n",
               plastic="!PLASTIC, YIELD=DRUCKER-PRAGER\n 40.0, 30.0, 500.0\n",
               sub=2)
    res, jres, wd, wj, pst, jst = _run_both(tmp_path, env, tet10_box(3, 2, 2),
                                            cnt)
    _assert_match(res, jres, wd, wj, pst, jst)
    assert _yielded(res.newton)[-1] > 0


def test_static_dload_temperature_matches_jax(tmp_path, env):
    """Linear STATIC on tet4: a dead BX body force and P2 pressure, a
    !TEMPERATURE field on two node groups (thermal load, and the
    thermal strains taken out of the recovered stress)."""
    cnt = deck(sol="STATIC",
               loads="!DLOAD\n ALL, BX, 3.0\n TOP, P2, 5.0\n"
               "!REFTEMP\n 20.0\n!TEMPERATURE\n Z1, 120.0\n Z0, 60.0\n",
               extra="!EXPANSION_COEFF\n 1.2e-5\n")
    res, jres, wd, wj, pst, jst = _run_both(tmp_path, env,
                                            box_tet4(4, 3, 3), cnt)
    assert res.newton is None and res.iters > 0
    _assert_match(res, jres, wd, wj, pst, jst, newton=False)
    for name in ("nodal_stress", "elem_stress", "reaction"):
        assert _rel(getattr(res, name), getattr(jres, name)) <= 1e-8


def test_static_plastic_mohr_coulomb_hex8_ic_matches_jax(tmp_path, env):
    """A STATIC deck with a !PLASTIC material takes the Newton driver at
    small strain: hex8 in its STATIC default, IC."""
    cnt = deck(sol="STATIC", loads="!CLOAD\n X1, 3, -15.0\n",
               plastic="!PLASTIC, YIELD=MOHR-COULOMB\n 60.0, 20.0, 300.0\n")
    res, jres, wd, wj, pst, jst = _run_both(tmp_path, env,
                                            box_hex8(4, 3, 3), cnt)
    assert res.newton is not None
    _assert_match(res, jres, wd, wj, pst, jst)
    assert pst[-1]["yielded"].any()


def test_plastic_cutback_matches_jax(tmp_path, env):
    """MAXITER=4 under a yielding substep: the substep is cut back and
    restarted from the committed plastic state."""
    cnt = deck(loads="!DLOAD\n TOP, P2, 120.0\n", plastic=MISES,
               step=", MAXITER=4")
    res, jres, wd, wj, pst, jst = _run_both(tmp_path, env,
                                            box_hex8(4, 3, 3), cnt)
    assert res.newton.cutbacks >= 1 and res.newton.substeps > 1
    _assert_match(res, jres, wd, wj, pst, jst)


def test_two_steps_follower_matches_jax(tmp_path, env):
    """Two !STEPs: the follower pressure of group 1 held from step 1, a
    second follower group and a temperature rise ramped in step 2."""
    cnt = deck(loads="!DLOAD\n TOP, P2, 40.0\n!DLOAD, GRPID=2\n"
               " TOP, P2, 30.0\n!REFTEMP\n 0.0\n!TEMPERATURE, GRPID=2\n"
               " Z1, 50.0\n",
               plastic=MISES, extra="!EXPANSION_COEFF\n 1.0e-5\n")
    cnt = cnt.replace("!STEP, SUBSTEPS=1\n BOUNDARY, 1\n LOAD, 1\n",
                      "!STEP, SUBSTEPS=1\n BOUNDARY, 1\n LOAD, 1\n"
                      "!STEP, SUBSTEPS=2\n BOUNDARY, 1\n LOAD, 1\n"
                      " LOAD, 2\n")
    res, jres, wd, wj, pst, jst = _run_both(tmp_path, env,
                                            box_hex8(4, 3, 3), cnt)
    assert res.newton.substeps == 3
    _assert_match(res, jres, wd, wj, pst, jst)


def test_substep_from_jax_committed_plastic_state(tmp_path, env):
    """The load step from 50% to 60% of the load from the (u, states)
    the JAX package committed after the step to 50%, which yields (pstrain, yielded, back, stresses
    and strains carried by ``convert.states_from_numpy``): the port's
    Newton loop, its follower load and return mapping agree with the JAX
    package's."""
    import jax.numpy as jnp
    import torch
    from frontistr_tpu.assembly import femop as jfemop
    from frontistr_tpu.assembly import operators as jops
    from frontistr_tpu.assembly.model import build_struct_model as jbuild
    from frontistr_tpu.io.ctrlio import read_cnt as jread_cnt
    from frontistr_tpu_torch import convert
    from frontistr_tpu_torch.assembly import femop
    from frontistr_tpu_torch.io.meshio import read_mesh
    cnt = deck(loads="!DLOAD\n TOP, P2, 200.0\n", plastic=MISES, sub=2,
               write="")
    wd = write_deck(tmp_path / "m", box_hex8(4, 3, 3), cnt)
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
    assert st1[0]["yielded"].any() and st1[0]["pstrain"].max() > 0
    okj, duj, stj, itj, _ = jnl._newton_substep(
        jm, jp, [{k: jnp.asarray(v) for k, v in s.items()} for s in st1],
        jnp.asarray(u1), f, jnp.asarray(free), ufix, 0.5, 0.6, step, *args)

    pm = convert.model_from_numpy(jm, device="cpu")
    pp = [nl.BlockPrograms(pm, b) for b in pm.blocks]
    free_t = torch.as_tensor(free)
    gather = femop.incidence_gather(pm, "cpu")
    solve = nl.make_constrained_solver(pm, free_t, gather, False)
    follow = nl._follower(pm, lambda a: torch.as_tensor(
        np.asarray(a, np.float64)))
    okp, dup, stp, itp, _ = nl._newton_substep(
        pm, pp, convert.states_from_numpy(st1, device="cpu"),
        torch.as_tensor(u1), torch.as_tensor(jm.f_ext), free_t,
        torch.as_tensor(ufix), 0.5, 0.6, step, gather, solve,
        follow=follow)
    assert okj and okp and itp == itj >= 2
    assert _rel(dup, duj) <= 1e-8
    for k in ("stress", "pstrain_new", "strain"):
        assert _rel(stp[0][k], stj[0][k]) <= 1e-8
    assert np.array_equal(stp[0]["yielded"].numpy(),
                          np.asarray(stj[0]["yielded"]))
