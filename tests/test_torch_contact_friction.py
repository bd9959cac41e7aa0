"""Coulomb friction at the JAX package's own settings, and how far its
Newton path and its BiCGSTAB counts can be held, on the CPU.

- The JAX package's friction decks (``tests/test_contact.py``
  ``_two_cube_friction_model``: two cubes pressed and sheared, the
  default tangential penalty 1e6, relres 1e-10, CONVERG 1e-6) through
  both packages: every contact pass converges in each, no cutback, and
  the answers agree.  The passes' Newton counts are not held: a load
  changed by 1e-13 changes the JAX package's own count on the first
  pass of the sticking deck (10 -> 7 iterations), and the test below
  shows it.
- BiCGSTAB's count of a single solve on the smoke's sticking punch deck
  moves under a load changed by 1e-13:
  tests/test_torch_contact_friction_bicgstab.py (its own file, so that
  ``--dist loadfile`` gives the long run a worker of its own).
- BiCGSTAB stops at a breakdown and returns its last finite iterate
  (ROADMAP queue 3, fault 7); the JAX package's returns NaN.

Bars: displacements and element stresses within 1e-8 x their largest
(the JAX package moves about 4e-9 from itself under the 1e-13 load
change).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frontistr_tpu.solver import cg as jcg
from frontistr_tpu_torch.solver.cg import bicgstab

from _torch_contact_decks import (_trace, close, pair_mesh, run_both,
                                  static_cnt, write_deck)

SHEAR = (" BOT, 1, 3, 0.0\n TOP, 3, 3, {uz}\n TOP, 1, 1, 1.0e-3\n"
         " TOP, 2, 2, 0.0\n")
# the top's push, and the same changed by 1e-13 of itself
UZ = ("-0.01", repr(-0.01 * (1 + 1e-13)))


@pytest.mark.parametrize("mu,sub", [("100.0", 2), ("0.01", 5)],
                         ids=["stick", "slip"])
def test_default_tangential_penalty_matches_jax(tmp_path, monkeypatch, mu,
                                                sub):
    ot, oj, tp, tj = run_both(
        tmp_path, pair_mesh("cubes"),
        static_cnt("ALAGRANGE", bc=SHEAR.format(uz=UZ[0]), mu=mu, sub=sub,
                   conv="1.0e-6", resid="1.0e-10"), monkeypatch)
    for trace in (tp, tj):
        assert len(trace["passes"]) == sub and \
            all(p[1] for p in trace["passes"])
    close(ot["static"].u, oj["static"].u)
    close(ot["static"].elem_stress, oj["static"].elem_stress)


def test_reference_newton_path_moves_under_a_load_change(tmp_path,
                                                         monkeypatch):
    """The JAX package alone on the sticking deck at the default
    tangential penalty: the push changed by 1e-13 takes 7 Newton
    iterations on the first pass instead of 10; the answer stays."""
    import frontistr_tpu.analysis.nonlinear as jnl
    import frontistr_tpu.contact.ntos as jntos
    import frontistr_tpu.run as jrun
    runs = []
    for k, uz in enumerate(UZ):
        trace = dict(passes=[])
        _trace(monkeypatch, jnl, jntos.ContactManager, trace["passes"],
               trace, False)
        wd = write_deck(tmp_path / f"wd{k}", pair_mesh("cubes"),
                        static_cnt("ALAGRANGE", bc=SHEAR.format(uz=uz),
                                   mu="100.0", sub=2, conv="1.0e-6",
                                   resid="1.0e-10"), seed=3)
        out = jrun.run_directory(wd)
        runs.append((np.asarray(out["static"].u),
                     [p[:2] for p in trace["passes"]]))
        monkeypatch.undo()
    (u0, p0), (u1, p1) = runs
    assert p0 == [(10, True), (2, True)] and p1 == [(7, True), (2, True)]
    close(u1, u0)


def test_bicgstab_stops_at_a_breakdown():
    """A = [[0, 1], [1, 0]], b = e_1: (r~, A p) = 0 on the first step.
    The JAX package's iterate is NaN; the port returns its last finite
    one (x0 = 0) after no step, not converged."""
    A = np.asarray([[0.0, 1.0], [1.0, 0.0]])
    b = np.asarray([1.0, 0.0])
    rj = jcg.bicgstab(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                      tol=1e-10, maxiter=10)
    assert not np.isfinite(np.asarray(rj.x)).all()
    At = torch.as_tensor(A)
    r = bicgstab(lambda x: At @ x, torch.as_tensor(b), tol=1e-10,
                 maxiter=10)
    assert torch.equal(r.x, torch.zeros(2, dtype=torch.float64))
    assert r.iters == 0 and not r.converged and r.relres == 1.0
