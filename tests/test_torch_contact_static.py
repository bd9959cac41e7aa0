"""Node-to-surface contact in the port's Newton driver against the JAX
package on the CPU, whole decks through both packages'
``run_directory``: the augmented-Lagrange arm (a STATIC deck, which the
runner routes into the Newton driver's contact loop, on boxes whose
meshes do not match), Coulomb friction sticking and slipping
(BiCGSTAB) and SLAGRANGE elimination in NLSTATIC.

Bars: displacements within 1e-8 x max|u| of the JAX package's (the
decks solve to a relres of 1e-12); the Newton iterations, convergence
and active set of every contact pass equal, and so is the count of
contact searches.
"""

import numpy as np
import pytest

from _torch_contact_decks import close, pair_mesh, run_both, static_cnt


def _same_passes(ot, tp, tj):
    assert tp["passes"] == tj["passes"] and tp["passes"]
    assert tp["search"] == tj["search"]
    nw = ot["static"].newton
    assert [p for c in nw.contact for p in c["passes"]] == \
        [p[0] for p in tp["passes"] if p[1]]


def test_static_alagrange_deck_matches_jax(tmp_path, monkeypatch):
    """A STATIC deck with !CONTACT takes the Newton driver's contact loop
    (one iteration a pass on a linear material, the AL passes until the
    gap and the multipliers settle) on the non-matching punch boxes."""
    ot, oj, tp, tj = run_both(tmp_path, pair_mesh("punch"),
                              static_cnt("ALAGRANGE", sol="STATIC",
                                         nu="0.3"), monkeypatch)
    close(ot["static"].u, oj["static"].u)
    assert ot["static"].iters == oj["static"].iters
    _same_passes(ot, tp, tj)
    assert max(len(c["passes"]) for c in ot["static"].newton.contact) > 1


FRICTION = (" BOT, 1, 3, 0.0\n TOP, 3, 3, -0.01\n TOP, 1, 1, 1.0e-3\n"
            " TOP, 2, 2, 0.0\n")


@pytest.mark.parametrize("mu,sub", [("100.0", 2), ("0.01", 3)],
                         ids=["stick", "slip"])
def test_friction_matches_jax(tmp_path, monkeypatch, mu, sub):
    """Two cubes pressed and sheared with Coulomb friction
    (``test_contact._two_cube_friction_model``): the slip tangent is
    nonsymmetric and both packages solve it by BiCGSTAB.  The tangential
    penalty is 1e4 (the deck's third column), where the passes' Newton
    counts can be held equal; at the default 1e6 a load changed by 1e-13
    changes the JAX package's own count, so
    ``test_torch_contact_friction.py`` holds the answers there."""
    mu = f"{mu}, 1.0e+4"
    ot, oj, tp, tj = run_both(
        tmp_path, pair_mesh("cubes"),
        static_cnt("ALAGRANGE", bc=FRICTION, mu=mu, sub=sub, conv="1.0e-6"),
        monkeypatch)
    close(ot["static"].u, oj["static"].u)
    close(ot["static"].elem_stress, oj["static"].elem_stress)
    _same_passes(ot, tp, tj)


def test_slagrange_matches_jax_and_closes_the_gap(tmp_path, monkeypatch):
    """SLAGRANGE elimination (``test_contact.test_slagrange_exact_gap_
    closure``): the same answer, and the gap closed to rounding."""
    from frontistr_tpu_torch.contact.ntos import ContactManager
    ot, oj, tp, tj = run_both(tmp_path, pair_mesh("block2"),
                              static_cnt("SLAGRANGE"), monkeypatch)
    close(ot["static"].u, oj["static"].u)
    _same_passes(ot, tp, tj)
    model = ot["model"]
    cm = ContactManager(model.mesh, model, model.cfg)
    proj = cm.search(model.coords + ot["static"].u)
    assert np.abs(proj["gap"])[proj["touching"]].max() < 1e-12
    # the JAX package's test's bar: sigma_zz = E eps through the joint
    np.testing.assert_allclose(ot["static"].elem_stress[:, 2], -5.0,
                               rtol=2e-2)
