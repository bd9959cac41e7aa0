"""Contact in the port's implicit dynamics against the JAX package on the
CPU (``tests/test_dynamic_contact.py``): the drop impact of a cube onto
another across a gap (the augmented-Lagrange arm) and a closed column
under load (SLAGRANGE), whole decks through both packages'
``run_directory``; then the contact requests the port still refuses,
each by name, and a contact deck through ``python -m
frontistr_tpu_torch``.

Bars: u within 1e-8 x its largest of the JAX package's (relres 1e-12),
v and a within 1e-6 (a = a3 du - ..., a3 = 1 / (beta dt^2) about 2.6e4
here, scales the solves' rounding up); the count of contact searches
equal (one a Newton iteration and one a pass, so the Newton and pass
counts agree).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_contact_decks import (close, dyn_cnt, pair_mesh, run_both,
                                  static_cnt, write_deck)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("case", ["drop", "slag"])
def test_implicit_dynamics_contact_matches_jax(tmp_path, monkeypatch,
                                               case):
    if case == "drop":
        mesh = pair_mesh("gap")
        cnt = dyn_cnt(60, 0.01, ray_m=0.5, gamma=0.75, beta=0.390625)
    else:
        mesh = pair_mesh("cubes")
        cnt = dyn_cnt(60, 0.02, algo="SLAGRANGE", ray_m=4.0, gamma=0.75,
                      beta=0.390625)
    ot, oj, tp, tj = run_both(tmp_path, mesh, cnt, monkeypatch, seed=None)
    dr, dj = ot["dynamic"], oj["dynamic"]
    close(dr.u, dj.u)
    close(dr.vel, dj.vel, 1e-6)
    close(dr.acc, dj.acc, 1e-6)
    assert tp["search"] == tj["search"] > 2 * 60
    passes = [len(h["passes"]) for h in dr.history]
    slave = ot["model"].mesh.node_groups["SLAVE"]
    if case == "drop":
        # the impact takes more than one pass in some steps, and the cube
        # is arrested at the interface (the JAX test's bars)
        assert max(passes) > 1
        assert dr.u[slave, 2].min() > -(0.05 + 0.03)
        assert dr.u[slave, 2].max() < -0.05 * 0.6
    else:
        np.testing.assert_allclose(dr.final.elem_stress[:, 2], -8.0,
                                   atol=0.4)
        assert np.abs(dr.vel).max() < 0.01


def _count_tangents(monkeypatch, cls, counts, key):
    real = cls.tangent

    def tangent(self, *a, **kw):
        counts[key] = counts.get(key, 0) + 1
        return real(self, *a, **kw)
    monkeypatch.setattr(cls, "tangent", tangent)


@pytest.mark.parametrize("algo", ["ALAGRANGE", "SLAGRANGE"])
def test_implicit_dynamics_tie_matches_jax(tmp_path, monkeypatch, algo):
    """A redundant !EQUATION tie with contact in the implicit Newton loop
    (``test_contact_mpc.test_dynamic_contact_mpc_*``): eliminated on the
    contact-extended operator (the penalty arm) or composed inside the
    contact elimination (SLAGRANGE).  u within 1e-8, the tie within
    1e-10, the element tangents computed (one a Newton iteration) and
    the contact searches equal in number."""
    import frontistr_tpu.analysis.nonlinear as jnl
    from frontistr_tpu_torch.analysis import nonlinear as nl
    from _torch_contact_decks import tie
    counts = {}
    _count_tangents(monkeypatch, nl.BlockPrograms, counts, "port")
    _count_tangents(monkeypatch, jnl.BlockPrograms, counts, "jax")
    mesh = pair_mesh("block2")
    a, b = tie(mesh, "mid")
    cnt = dyn_cnt(4, 0.01, algo=algo, ray_m=2.0,
                  bc=" BOT, 3, 3, 0.0\n X0, 1, 1, 0.0\n Y0, 2, 2, 0.0\n",
                  conv="1.0e-9")
    ot, oj, tp, tj = run_both(tmp_path, mesh, cnt, monkeypatch)
    close(ot["dynamic"].u, oj["dynamic"].u)
    u = ot["dynamic"].u
    ia, ib = (ot["model"].mesh.id2idx[int(g)] for g in
              (mesh.node_ids[a], mesh.node_ids[b]))
    assert abs(u[ia, 2] - u[ib, 2]) < 1e-10
    assert counts["port"] == counts["jax"] > 4
    assert tp["search"] == tj["search"]


def test_newton_arm_reduces_the_tie_residual(tmp_path, monkeypatch):
    """The implicit Newton loop without contact (taken by
    FRONTISTR_TPU_IMPLICIT_SCAN=0) on a tied plate whose tie carries
    force: its convergence residual is reduced by T^T, as the JAX
    package's (``frontistr_tpu/analysis/dynamic.py:723-726``), so the
    Newton iterations (element tangents computed) are the JAX package's
    and u within 1e-8."""
    import frontistr_tpu.analysis.nonlinear as jnl
    from frontistr_tpu_torch.analysis import nonlinear as nl
    from _torch_decks import dyn_deck, run_both as run_decks, solid_box
    from test_torch_mpc_spring import tie_face
    monkeypatch.setenv("FRONTISTR_TPU_IMPLICIT_SCAN", "0")
    counts = {}
    _count_tangents(monkeypatch, nl.BlockPrograms, counts, "port")
    _count_tangents(monkeypatch, jnl.BlockPrograms, counts, "jax")
    mesh = solid_box(361, 3, 2, 2)
    mast = tie_face(mesh)
    cnt = dyn_deck(eqa=1, n_step=4, dt=1e-6, ray_m=1e3, ray_k=1e-9,
                   loads=f"!CLOAD\n {mast}, 3, -5.0\n")
    ot, oj, _, _ = run_decks(tmp_path, mesh, cnt)
    close(ot["dynamic"].u, oj["dynamic"].u)
    assert counts["port"] == counts["jax"]
    assert [h["newton"] for h in ot["dynamic"].history] == [1] * 4


@pytest.mark.parametrize("case", ["explicit", "shards", "restart",
                                  "heat", "eigen", "staticeigen"])
def test_contact_refusals_name_themselves(tmp_path, monkeypatch, case):
    """Contact where the port does not run it: explicit dynamics,
    EIGEN, STATICEIGEN's Lanczos and HEAT (the JAX package drops the
    card there: ROADMAP queue 3, fault 2), sharded contact's DIRECT arm
    and the restart of a static contact run (the JAX package's
    checkpoint drops the contact state: queue 3, fault 8;
    tests/test_torch_restart.py)."""
    from frontistr_tpu_torch.run import run_directory
    msg = "CONTACT"
    if case == "explicit":
        cnt = dyn_cnt(2, 1e-3, eqa=11)
        msg = "CONTACT in explicit dynamics"
    elif case == "shards":
        # sharded contact runs (tests/test_torch_shard_contact.py); its
        # DIRECT arm is refused by name
        monkeypatch.setenv("FRONTISTR_TPU_SHARDS", "2")
        cnt = static_cnt(method="DIRECT")
        msg = "DIRECT with !CONTACT under FRONTISTR_TPU_SHARDS"
    elif case == "restart":
        cnt = static_cnt().replace("!END\n", "!RESTART, FREQUENCY=1\n!END\n")
        msg = "RESTART"
    elif case == "heat":
        msg = "CONTACT in HEAT"
        cnt = ("!SOLUTION, TYPE=HEAT\n!HEAT\n 0.0, 0.0, 0.0, 0.0, 20, "
               "1.0e-6\n!FIXTEMP\n BOT, 100.0\n!CONTACT, GRPID=1\n CP1, 0.0\n"
               "!SOLVER, METHOD=CG\n 2000, 1\n 1.0e-8, 1.0, 0.0\n!END\n")
    else:
        sol = case.upper()
        cnt = static_cnt(sol=sol).replace(
            "!CONTACT_ALGO", "!EIGEN\n 3, 1.0e-8, 60\n!CONTACT_ALGO")
        msg = f"CONTACT in {sol}"
    wd = write_deck(tmp_path / "wd", pair_mesh("cubes"), cnt)
    with pytest.raises(NotImplementedError, match=msg):
        run_directory(wd, device="cpu")


def test_contact_deck_through_the_cli(tmp_path):
    """``python -m frontistr_tpu_torch --device cpu`` on a SLAGRANGE
    deck: the 0.log and FSTR.sta of a completed run."""
    wd = write_deck(tmp_path / "wd", pair_mesh("block2"),
                    static_cnt("SLAGRANGE"), seed=5)
    out = subprocess.run([sys.executable, "-m", "frontistr_tpu_torch",
                          "--device", "cpu", wd], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    with open(os.path.join(wd, "FSTR.sta")) as fh:
        assert "HAS COMPLETED SUCCESSFULLY" in fh.read()
    assert os.path.getsize(os.path.join(wd, "0.log")) > 0
