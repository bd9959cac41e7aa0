"""The rate-dependent materials in NLSTATIC VISCO steps, the port against
the JAX package on the CPU through ``run_directory``: Prony-series
viscoelasticity (``fem/visco.py``; total Lagrange) with and without
!TRS, and Norton creep (updated Lagrange), on a shuffled
``box_hex8(3, 2, 2)``, X0 fixed, X1 pulled or loaded, the f64 policy.

!TRS with a temperature field: the JAX package's tangent cannot
broadcast the per-gauss-point shift (``visco_D`` raises a ValueError,
ROADMAP queue 3); the port shifts every gauss point's time.  Under a
uniform temperature the shift a(T) is one number, and a VISCO step with
relaxation times tau and the shift equals one with times tau / a and no
shift: that run of the JAX package is the reference.

Implicit dynamics: a viscoelastic and a NEOHOOKE block under Newmark.

Bars: displacements within 1e-8 of the largest, Newton iterations and
FSTR.sta equal, the 0.log summaries within 1e-8; the Prony and creep
updates at the gauss-point level within 1e-12 relative.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from frontistr_tpu.fem import visco as jvisco
from frontistr_tpu_torch.fem import visco
from frontistr_tpu_torch.meshgen import box_hex8

from frontistr_tpu_torch.run import run_directory

from _torch_decks import run_both, write_deck
from test_torch_hyper import check_static

CNT = ("!VERSION\n 3\n!SOLUTION, TYPE=NLSTATIC\n!BOUNDARY, GRPID=1\n"
       " X0, 1, 3, 0.0\n{bc}{load}{temp}!STEP, TYPE=VISCO, SUBSTEPS=4, "
       "CONVERG=1.0e-8\n 0.25, 1.0\n BOUNDARY, 1\n{lstep}"
       "!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n{mat}"
       "!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
       " 1.0e-10, 1.0, 0.0\n!END\n")
PULL = " X1, 1, 1, 0.002\n"
WLF = (20.0, 8.86, 101.6)


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", "f64")
    monkeypatch.setenv("FRONTISTR_TPU_REORDER", "1")
    return monkeypatch


def visco_cnt(taus=(0.5, 2.0), trs=False, temp=None):
    mat = "!VISCOELASTIC\n" + "".join(f" 0.3, {t!r}\n" for t in taus)
    if trs:
        mat += "!TRS, DEFINITION=WLF\n " + ", ".join(map(str, WLF)) + "\n"
    return CNT.format(bc=PULL, load="", lstep="", mat=mat,
                      temp="" if temp is None else
                      f"!TEMPERATURE\n ALL, {temp!r}\n")


@pytest.mark.parametrize("trs", [False, True])
def test_visco_matches_jax(tmp_path, env, trs):
    """!TRS without a temperature field shifts nothing, as in the JAX
    package."""
    ot, oj, wd, wj = run_both(tmp_path, box_hex8(3, 2, 2),
                              visco_cnt(trs=trs))
    assert ot["model"].blocks[0].material.mtype == "VISCOELASTIC"
    check_static(ot, oj, wd, wj)


def test_visco_trs_shift_matches_scaled_times(tmp_path, env):
    T = 35.0
    a = math.exp(WLF[1] * (T - WLF[0]) / (WLF[2] + T - WLF[0])
                 * math.log(10.0))
    import frontistr_tpu.run as jrun
    wd = write_deck(tmp_path / "p", box_hex8(3, 2, 2),
                    visco_cnt(trs=True, temp=T))
    wj = write_deck(tmp_path / "j", box_hex8(3, 2, 2),
                    visco_cnt(taus=(0.5 / a, 2.0 / a), temp=T))
    w0 = write_deck(tmp_path / "n", box_hex8(3, 2, 2), visco_cnt(temp=T))
    res = run_directory(wd, device="cpu")["static"]
    jres = jrun.run_directory(wj)["static"]
    uj = np.asarray(jres.u)
    assert np.abs(res.u - uj).max() <= 1e-8 * np.abs(uj).max()
    assert res.iters == int(jres.iters)
    # the shift does act: the unshifted run differs
    u0 = np.asarray(jrun.run_directory(w0)["static"].u)
    assert np.abs(u0 - uj).max() > 1e-4 * np.abs(uj).max()


def test_creep_matches_jax(tmp_path, env):
    cnt = CNT.format(bc="", load="!CLOAD, GRPID=1\n X1, 1, 400.0\n",
                     lstep=" LOAD, 1\n", temp="",
                     mat="!CREEP, TYPE=NORTON\n 1.0e-12, 3.0, 0.0\n")
    ot, oj, wd, wj = run_both(tmp_path, box_hex8(3, 2, 2), cnt)
    res = ot["static"]
    assert ot["model"].blocks[0].material.mtype == "NORTON"
    check_static(ot, oj, wd, wj)
    # creep strain accumulated beyond the elastic answer
    assert res.u[:, 0].max() > 0


def test_prony_and_creep_updates_match_jax():
    rng = np.random.default_rng(3)
    eps = rng.uniform(-1e-3, 1e-3, (5, 8, 6))
    vq = rng.uniform(-1e-4, 1e-4, (5, 8, 2, 6))
    ven = rng.uniform(-1e-4, 1e-4, (5, 8, 6))
    dt = rng.uniform(0.0, 2.0, (5, 8))
    mus, taus = np.array([0.3, 0.3]), np.array([0.5, 2.0])
    got = visco.visco_update(*(torch.as_tensor(v) for v in (eps, vq, ven,
                                                            dt)),
                             80000.0, 175000.0, torch.as_tensor(mus),
                             torch.as_tensor(taus))
    want = jvisco.visco_update(*(jnp.asarray(v) for v in (eps, vq, ven, dt)),
                               80000.0, 175000.0, jnp.asarray(mus),
                               jnp.asarray(taus))
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= \
            1e-12 * np.abs(np.asarray(w)).max()
    sig = rng.uniform(-300.0, 300.0, (5, 8, 6))
    s, dg, _ = visco.creep_return(torch.as_tensor(sig), 80000.0, 1e-12, 3.0,
                                  0.0, 1.0, 0.25)
    js, jdg, _ = jvisco.creep_return(jnp.asarray(sig), 80000.0, 1e-12, 3.0,
                                     0.0, 1.0, 0.25)
    assert np.abs(s.numpy() - np.asarray(js)).max() <= 1e-12 * 300.0
    assert np.abs(dg.numpy() - np.asarray(jdg)).max() <= \
        1e-12 * np.abs(np.asarray(jdg)).max()
    # the JAX package takes ln 10 as jnp.log(10.0), a float32 (1.6e-7
    # relative in a); the port takes it in float64
    T = torch.as_tensor(rng.uniform(20.0, 60.0, (5, 8)))
    assert np.allclose(visco.trs_shift(T, WLF).numpy(),
                       np.asarray(jvisco.trs_shift(jnp.asarray(T.numpy()),
                                                   np.asarray(WLF))),
                       rtol=1e-6, atol=0)


@pytest.mark.parametrize("law", ["visco", "hyper"])
def test_rate_and_hyper_materials_in_implicit_dynamics(tmp_path, env, law):
    """Implicit Newmark (its Newton arm) on a viscoelastic block, each
    step's increment the Prony terms' clock, and on a NEOHOOKE block
    under TYPE=NONLINEAR, against the JAX package."""
    from _torch_decks import dyn_deck
    card = ("!VISCOELASTIC\n 0.3, 2.0e-6\n 0.3, 1.0e-5\n" if law == "visco"
            else "!HYPERELASTIC, TYPE=NEOHOOKE\n 1.0, 1.0\n")
    cnt = dyn_deck(eqa=1, n_step=4, dt=1e-6, plastic=card,
                   typ=", TYPE=NONLINEAR" if law == "hyper" else "",
                   loads="!CLOAD\n X1, 3, -50.0\n")
    ot, oj, _, _ = run_both(tmp_path, box_hex8(3, 2, 2), cnt)
    d, dj = ot["dynamic"], oj["dynamic"]
    assert d.steps == dj.steps == 4
    for name in ("u", "vel", "acc"):
        a, b = getattr(d, name), np.asarray(getattr(dj, name))
        assert np.abs(a - b).max() <= 1e-8 * np.abs(b).max(), name
