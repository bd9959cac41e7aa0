"""2-D contact (plane strain quad4, ``meshgen.contact_pair(...,
etype=241)``; the manager reads ``model.dim``) in the port's Newton
driver against the JAX package on the CPU, and fault 6 of ROADMAP queue
3 in a whole run: on a punch narrower than its base the deformed master
edges tilt, the JAX package's SLAGRANGE elimination then moves the
Dirichlet-fixed dofs that are masters of a slot, and the port's does
not.

Where the JAX package's iterative elimination departs from the port's,
the port's answer is held against the JAX package's METHOD=DIRECT
SLAGRANGE on the same deck: its explicit Lagrange rows mask the fixed
columns (``lag_rows(..., free)``), so it means what the port's
elimination means.

Bars: displacements (and element stresses) within 1e-8 x their largest
of the JAX package's and every contact pass's Newton iterations and
active set equal, where the answers are the same; fixed dofs at their
prescribed values within 1e-12 (the port) and off them by more than
1e-5 (the JAX package's iterative arm) where they are not.
"""

import numpy as np
import pytest

from frontistr_tpu_torch.meshgen import contact_pair

from _torch_contact_decks import close, run_both, static_cnt

BC2 = " BOT, 2, 2, 0.0\n X0, 1, 1, 0.0\n TOP, 2, 2, -0.01\n"


def _mesh(kind):
    if kind == "punch":
        return contact_pair((3, 2), (2, 2), (1.0, 0.5), (0.9, 0.5),
                            etype=241)
    return contact_pair((2, 2), (2, 2), (1.0, 1.0), (1.0, 1.0), etype=241)


@pytest.mark.parametrize("algo,kind,nu", [("ALAGRANGE", "punch", "0.3"),
                                          ("SLAGRANGE", "match", "0.0")])
def test_plane_contact_matches_jax(tmp_path, monkeypatch, algo, kind, nu):
    ot, oj, tp, tj = run_both(tmp_path, _mesh(kind),
                              static_cnt(algo, bc=BC2, nu=nu), monkeypatch)
    assert ot["model"].dim == 2
    close(ot["static"].u, oj["static"].u)
    assert tp["passes"] == tj["passes"] and tp["search"] == tj["search"]


def test_slagrange_keeps_fixed_masters_fixed(tmp_path, monkeypatch):
    """Fault 6 in a whole run: the 2-D punch under SLAGRANGE.  The JAX
    package takes over 50 Newton iterations and leaves fixed dofs off
    their values; the port converges in two a substep and holds them."""
    ot, oj, tp, tj = run_both(tmp_path, _mesh("punch"),
                              static_cnt("SLAGRANGE", bc=BC2), monkeypatch)
    drift = {}
    for name, out in (("port", ot), ("jax", oj)):
        model = out["model"]
        u = np.asarray(out["static"].u).reshape(-1)
        drift[name] = np.abs(u[model.fixed_dofs] - model.fixed_vals).max()
    assert drift["port"] <= 1e-12 and drift["jax"] > 1e-5, drift
    assert [p[0] for p in tp["passes"]] == [2, 2]
    assert sum(p[0] for p in tj["passes"]) > 50


def test_slagrange_punch_matches_jax_direct(tmp_path, monkeypatch):
    """Fault 6 against a JAX arm of the same meaning: the port's
    iterative SLAGRANGE on the 2-D punch (CG, fixed masters dropped)
    against the JAX package's DIRECT SLAGRANGE on the same deck."""
    cnt = static_cnt("SLAGRANGE", bc=BC2, nu="0.3")
    ot, oj, tp, tj = run_both(
        tmp_path, _mesh("punch"), cnt, monkeypatch,
        jcnt=cnt.replace("METHOD=CG", "METHOD=DIRECT"))
    close(ot["static"].u, oj["static"].u)
    close(ot["static"].elem_stress, oj["static"].elem_stress)
    assert tp["passes"] == tj["passes"] and tp["search"] == tj["search"]
    assert [p[0] for p in tp["passes"]] == [2, 2]
