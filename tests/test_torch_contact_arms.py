"""The other contact arms of the port's Newton driver against the JAX
package on the CPU, whole NLSTATIC decks through both packages'
``run_directory``: the KKT saddle system by MINRES (forced by
FRONTISTR_TPU_CONTACT_SOLVE=saddle, and taken when !EQUATION dofs lie on
the contact surface), METHOD=DIRECT (the Lagrange rows' host factor
under SLAGRANGE, the penalty blocks assembled under ALAGRANGE), and a
redundant !EQUATION tie eliminated on each iterative arm
(``tests/test_contact_mpc.py``, ``test_contact_saddle.py``).

The port's iterative SLAGRANGE on the flat punch cut to n = 6, where
fixed dofs are masters of slots (ROADMAP queue 3, fault 6), is held
against the JAX package's METHOD=DIRECT SLAGRANGE, whose Lagrange rows
mask the fixed columns as the port's elimination drops them.

Bars: displacements within 1e-8 x max|u| of the JAX package's (relres
1e-12), element stresses within 1e-8 x their largest on the punch;
every contact pass's Newton iterations and active set equal, and the
count of searches; a tie within 1e-10.
"""

import numpy as np
import pytest

from frontistr_tpu_torch.contact.ntos import ContactManager

from _torch_contact_decks import (close, pair_mesh, run_both, static_cnt,
                                  tie, write_deck)


def _check(ot, oj, tp, tj):
    close(ot["static"].u, oj["static"].u)
    assert tp["passes"] == tj["passes"] and tp["passes"]
    assert tp["search"] == tj["search"]


def test_saddle_forced_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("FRONTISTR_TPU_CONTACT_SOLVE", "saddle")
    ot, oj, tp, tj = run_both(tmp_path, pair_mesh("block2"),
                              static_cnt("SLAGRANGE", conv="1.0e-9"),
                              monkeypatch)
    _check(ot, oj, tp, tj)


def test_saddle_for_overlapping_mpc_matches_jax(tmp_path, monkeypatch,
                                                capsys):
    """A tie of two slave nodes' u3: the elimination composition is
    invalid, so both packages solve the saddle system with the equation
    as a row."""
    mesh = pair_mesh("block2")
    a, b = tie(mesh, "slave")
    ot, oj, tp, tj = run_both(tmp_path, mesh,
                              static_cnt("SLAGRANGE", conv="1.0e-9"),
                              monkeypatch)
    assert capsys.readouterr().out.count("no-elimination arm") == 2
    _check(ot, oj, tp, tj)
    u = ot["static"].u
    model = ot["model"]
    ia, ib = (model.mesh.id2idx[int(g)] for g in
              (mesh.node_ids[a], mesh.node_ids[b]))
    assert abs(u[ia, 2] - u[ib, 2]) < 1e-10


@pytest.mark.parametrize("algo", ["SLAGRANGE", "ALAGRANGE"])
def test_direct_matches_jax(tmp_path, monkeypatch, algo):
    """``test_contact.test_direct_solver_contact_decks``: a load on the
    upper cube, lateral dofs held; the host factor does not fall back on
    the iterative arm."""
    from frontistr_tpu_torch.analysis import nonlinear as nl
    states = []
    real = nl.ContactState.make

    def make(*a, **kw):
        st = real(*a, **kw)
        states.append(st)
        return st
    monkeypatch.setattr(nl.ContactState, "make", make)
    cnt = static_cnt(algo, method="DIRECT",
                     bc=" BOT, 3, 3, 0.0\n ALL, 1, 2, 0.0\n",
                     loads="!CLOAD, GRPID=1\n TOP, 3, -2.0\n")
    ot, oj, tp, tj = run_both(tmp_path, pair_mesh("cubes"), cnt,
                              monkeypatch)
    _check(ot, oj, tp, tj)
    assert states[0].direct and states[0].retries == 0
    assert all(h["cg_iters"] == 0 for h in ot["static"].newton.history)


@pytest.mark.parametrize("algo", ["ALAGRANGE", "SLAGRANGE"])
def test_redundant_tie_matches_jax(tmp_path, monkeypatch, algo):
    """A tie of two middle-layer nodes of the lower box, disjoint from
    the contact surfaces: eliminated on the contact-extended operator
    (ALAGRANGE) or composed inside the contact elimination
    (SLAGRANGE)."""
    mesh = pair_mesh("block2")
    a, b = tie(mesh, "mid")
    ot, oj, tp, tj = run_both(tmp_path, mesh,
                              static_cnt(algo, conv="1.0e-9"), monkeypatch)
    _check(ot, oj, tp, tj)
    u = ot["static"].u
    ia, ib = (ot["model"].mesh.id2idx[int(g)] for g in
              (mesh.node_ids[a], mesh.node_ids[b]))
    assert abs(u[ia, 2] - u[ib, 2]) < 1e-10


def test_slagrange_punch_matches_jax_direct(tmp_path, monkeypatch):
    """The flat punch of the smoke's contact path at n = 6: the port's
    iterative SLAGRANGE (CG, the fixed masters dropped) against the JAX
    package's DIRECT SLAGRANGE on the same deck; 3 Newton iterations in
    each of the 2 substeps."""
    cnt = static_cnt("SLAGRANGE", nu="0.3")
    ot, oj, tp, tj = run_both(
        tmp_path, pair_mesh("punch6"), cnt, monkeypatch,
        jcnt=cnt.replace("METHOD=CG", "METHOD=DIRECT"))
    _check(ot, oj, tp, tj)
    close(ot["static"].elem_stress, oj["static"].elem_stress)
    assert [p[0] for p in tp["passes"]] == [3, 3]


def test_saddle_on_the_punch_matches_jax(tmp_path, monkeypatch):
    """The saddle arm forced on the flat punch at n = 6: the port's is
    the JAX package's, and both leave a penetration the elimination
    closes (ROADMAP queue 3, reference-side caveats): the arm's rows ask
    B du = -gap x the substep's load fraction on its first iteration
    and B du = 0 after, so the gap the first linearisation leaves
    stays (7.3e-6 here against the elimination's 3e-11)."""
    from frontistr_tpu_torch.run import run_directory
    cnt = static_cnt("SLAGRANGE", nu="0.3")
    elim = run_directory(write_deck(tmp_path / "elim", pair_mesh("punch6"),
                                    cnt, seed=3), device="cpu")
    monkeypatch.setenv("FRONTISTR_TPU_CONTACT_SOLVE", "saddle")
    ot, oj, tp, tj = run_both(tmp_path, pair_mesh("punch6"), cnt,
                              monkeypatch)
    _check(ot, oj, tp, tj)
    u, ue = ot["static"].u, elim["static"].u
    assert abs(u - ue).max() > 1e-4 * abs(ue).max()
    model = ot["model"]
    cm = ContactManager(model.mesh, model, model.cfg)
    gaps = [np.abs(p["gap"][p["touching"]]).max() for p in
            (cm.search(model.coords + u), cm.search(model.coords + ue))]
    assert gaps[0] > 1e-6 and gaps[1] < 1e-10, gaps
