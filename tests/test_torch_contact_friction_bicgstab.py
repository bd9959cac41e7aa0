"""How far BiCGSTAB's counts can be held on a friction deck, on the CPU
(split from tests/test_torch_contact_friction.py, whose decks and bars
it shares, so that ``--dist loadfile`` gives this long run a worker of
its own).

- BiCGSTAB's count of a single solve on the smoke's sticking punch deck
  moves by tens of iterations in either package under a load changed
  by 1e-13, at relres 1e-12 and at 1e-8; the run's total stays within
  10%.  That is the bar the smoke holds the card to on these
  decks (a card's reductions sum in another order).
"""

import jax

from frontistr_tpu.solver import cg as jcg

from _torch_contact_decks import pair_mesh, static_cnt, write_deck
from test_torch_contact_friction import SHEAR, UZ


def _jax_counts(monkeypatch, wd):
    """The JAX package's run of ``wd`` and each BiCGSTAB solve's count."""
    import frontistr_tpu.run as jrun
    counts, real = [], jcg.bicgstab

    def counted(*a, **kw):
        res = real(*a, **kw)
        jax.debug.callback(lambda k: counts.append(int(k)), res.iters)
        return res
    monkeypatch.setattr(jcg, "bicgstab", counted)
    jrun.run_directory(wd)
    monkeypatch.setattr(jcg, "bicgstab", real)
    return counts


def test_bicgstab_counts_move_under_a_load_change(tmp_path, monkeypatch):
    """The smoke's sticking punch deck (225 dofs, tangential penalty
    1e4), the push changed by 1e-13: the contact passes stay, a single
    solve's count moves by more than 1 and the run's total by under
    10%, in the JAX package at the deck's relres 1e-12 and in the port
    at 1e-12 and at 1e-8, where most solves take fewer iterations than
    there are unknowns."""
    from frontistr_tpu_torch.run import run_directory
    runs = {}
    for who, resid in (("jax", "1.0e-12"), ("port", "1.0e-12"),
                       ("port", "1.0e-8")):
        for k, uz in enumerate(UZ):
            cnt = static_cnt("ALAGRANGE", bc=SHEAR.format(uz=uz),
                             mu="100.0, 1.0e+4", conv="1.0e-6", resid=resid)
            wd = write_deck(tmp_path / f"{who}{resid}_{k}",
                            pair_mesh("punch"), cnt, seed=5)
            if who == "jax":
                counts = _jax_counts(monkeypatch, wd)
            else:
                nw = run_directory(wd, device="cpu")["static"].newton
                counts = [h["cg_iters"] for h in nw.history]
            runs.setdefault((who, resid), []).append(counts)
    for key, (a, b) in runs.items():
        assert len(a) == len(b) == 13, key
        assert max(abs(x - y) for x, y in zip(a, b)) > 1, key
        assert abs(sum(a) - sum(b)) <= 0.1 * sum(a), key
