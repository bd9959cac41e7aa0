"""!RESTART of implicit dynamics (with its contact state) and of
transient heat, and the static contact restart the port refuses, held
to the JAX package on the CPU.

- Implicit dynamics, the drop of tests/test_dynamic_contact.py:159
  (ALAGRANGE, the upper cube 0.02 above the lower): 4 steps with a
  checkpoint at step 4, then the 8-step deck resumed from it
  (FREQUENCY=-4), the contact manager's multipliers and released slots
  carried; the port's resumed run equals its uninterrupted one bit for
  bit, and the JAX package's resumed run within 1e-8.
- Transient heat: 2 of 3 steps with a checkpoint, then the full deck
  resumed: bit for bit the uninterrupted run, the JAX package's within
  1e-8.
- NLSTATIC with !CONTACT: the JAX package's static checkpoint carries
  no contact state, and its resumed ALAGRANGE run leaves its
  uninterrupted one; the port refuses the pair by name (ROADMAP queue
  3, fault 8).
"""

import os
import shutil

import numpy as np
import pytest

import frontistr_tpu.run as jrun
from frontistr_tpu_torch.meshgen import contact_pair
from frontistr_tpu_torch.run import run_directory

from _torch_contact_decks import (dyn_cnt, pair_mesh, static_cnt,
                                  write_deck)
from _torch_decks import heat_deck, heat_mesh, write_heat_deck


def _set_deck(wd, cnt):
    with open(os.path.join(wd, "case.cnt"), "w") as fh:
        fh.write(cnt)


def _restart(cnt, freq):
    return cnt.replace("!END\n", f"!RESTART, FREQUENCY={freq}\n!END\n")


def _port(wd):
    return run_directory(wd, device="cpu")


def _by_id(out, field):
    ids = np.asarray(out["mesh"].node_ids)
    return np.asarray(field).reshape(len(ids), -1)[np.argsort(ids)]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.isfinite(a).all()
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_dynamic_contact_resume(tmp_path):
    mesh = contact_pair((1, 1, 1), (1, 1, 1), (1.0, 1.0, 1.0),
                        (1.0, 1.0, 1.0), gap=0.02)

    def cnt(n, freq):
        return _restart(dyn_cnt(n, 0.01, ray_m=0.5, gamma=0.75,
                                beta=0.390625), freq)

    wd = write_deck(tmp_path / "once", mesh, cnt(8, 4), seed=3)
    once = _port(wd)["dynamic"]
    wp = write_deck(tmp_path / "port", mesh, cnt(4, 4), seed=3)
    wj = str(tmp_path / "jax")
    shutil.copytree(wp, wj)
    outs = []
    for d, run in ((wp, _port), (wj, jrun.run_directory)):
        first = run(d)["dynamic"]
        assert os.path.exists(os.path.join(d, "restart.npz"))
        _set_deck(d, cnt(8, -4))
        outs.append((first, run(d)))
    (p4, pout), (j4, jout) = outs
    got, want = pout["dynamic"], jout["dynamic"]
    # the drop reached the lower cube: multipliers carried
    assert got.history[0]["step"] == 5 and len(got.history) == 4
    assert any(h["active"].any() for h in got.history)
    for k in ("u", "vel", "acc"):
        assert np.array_equal(getattr(got, k), getattr(once, k)), k
        assert _rel(_by_id(pout, getattr(got, k)),
                    _by_id(jout, getattr(want, k))) <= 1e-8, k
    assert [h["newton"] for h in got.history] == \
        [h["newton"] for h in once.history[4:]]


def test_transient_heat_resume(tmp_path):
    mesh = heat_mesh("hex8")
    full = heat_deck(mesh)
    half = full.replace("1.0e-4, 3.0e-4,", "1.0e-4, 2.0e-4,")
    assert half != full
    wd = write_heat_deck(tmp_path / "once", mesh, full)
    once = _port(wd)["heat"]
    wp = write_heat_deck(tmp_path / "port", mesh, _restart(half, 2))
    wj = str(tmp_path / "jax")
    shutil.copytree(wp, wj)
    outs = []
    for d, run in ((wp, _port), (wj, jrun.run_directory)):
        assert run(d)["heat"].steps == 2
        _set_deck(d, _restart(full, -2))
        outs.append(run(d))
    got, want = outs[0]["heat"], outs[1]["heat"]
    assert got.steps == want.steps == once.steps == 3
    assert np.array_equal(got.T, once.T)
    assert _rel(_by_id(outs[0], got.T), _by_id(outs[1], want.T)) <= 1e-8
    with open(os.path.join(wp, "0.log")) as fp, \
            open(os.path.join(wj, "0.log")) as fj:
        assert fp.read() == fj.read()


def test_static_contact_restart_is_refused(tmp_path):
    """Fault 8: the JAX package's ALAGRANGE run interrupted after
    substep 1 (half the push in half the step time) and resumed differs
    from its uninterrupted run by more than 1e-5 of max|u| (its
    checkpoint drops the multipliers); the port raises by name."""
    bc = " BOT, 3, 3, 0.0\n X0, 1, 1, 0.0\n Y0, 2, 2, 0.0\n TOP, 3, 3, {}\n"
    full = static_cnt("ALAGRANGE", bc=bc.format(-0.01))
    half = static_cnt("ALAGRANGE", bc=bc.format(-0.005)).replace(
        "!STEP, SUBSTEPS=2, CONVERG=1.0e-7\n",
        "!STEP, SUBSTEPS=2, CONVERG=1.0e-7\n 0.5, 0.5\n")
    mesh = pair_mesh("block2")
    wa = write_deck(tmp_path / "once", mesh, full, seed=3)
    once = jrun.run_directory(wa)["static"]
    wb = write_deck(tmp_path / "jax", mesh, _restart(half, 1), seed=3)
    jrun.run_directory(wb)
    _set_deck(wb, _restart(full, -1))
    resumed = jrun.run_directory(wb)["static"]
    assert _rel(resumed.u, once.u) > 1e-5
    wp = write_deck(tmp_path / "port", mesh, _restart(full, 1), seed=3)
    with pytest.raises(NotImplementedError, match="RESTART with !CONTACT"):
        _port(wp)
