"""Implicit Newmark-beta decks of the port (``analysis/dynamic.py``)
against the JAX package's ``run_dynamic``, on the CPU: linear hex8 (IC)
and tet4 with Rayleigh damping in both arms (the step train of a linear
deck, ``FRONTISTR_TPU_IMPLICIT_SCAN=1``, and the Newton loop,
``=0``), and ``!DYNAMIC, TYPE=NONLINEAR`` tet4 and hex8 B-bar, elastic
and under ``!PLASTIC`` Mises.

Bars: u, v, a within 1e-8 of each field's largest magnitude; the Newton
iterations of every step equal; every solve's CG count within one of
the JAX package's (its ``pcg`` reports the count through a debug
callback, in the order the solves run).  Unit boxes ``box_tet4(3, 2,
2)`` and ``box_hex8(3, 2, 2)``, steel in N, mm, s, dt 1e-7 s.
"""

import types

import jax
import numpy as np
import pytest

from frontistr_tpu.analysis import dynamic as jdyn
from frontistr_tpu.assembly.model import build_struct_model as jbuild
from frontistr_tpu.io.ctrlio import read_cnt as jread_cnt
from frontistr_tpu.solver import cg as jcg
from frontistr_tpu_torch.analysis import dynamic as dyn
from frontistr_tpu_torch.assembly.model import build_struct_model
from frontistr_tpu_torch.io.ctrlio import read_cnt
from frontistr_tpu_torch.io.meshio import Amplitude
from frontistr_tpu_torch.meshgen import box_hex8, box_tet4

from _torch_decks import dyn_deck

MISES = "!PLASTIC, YIELD=MISES, HARDEN=LINEAR\n 250.0, 1000.0\n"
CASES = {
    # name: (mesh, scan switch, deck keyword arguments)
    "linear_hex8_ic_train": (box_hex8, "1", {}),
    "linear_hex8_ic_newton": (box_hex8, "0", {}),
    "linear_tet4_train": (box_tet4, "1", {}),
    "linear_tet4_newton": (box_tet4, "0", {}),
    "nonlinear_tet4": (box_tet4, "1", dict(load=-2000.0)),
    "nonlinear_tet4_plastic": (box_tet4, "1", dict(load=-2000.0,
                                                   plastic=MISES)),
    "nonlinear_hex8_bbar": (box_hex8, "1", dict(load=-2000.0)),
    "nonlinear_hex8_bbar_plastic": (box_hex8, "1", dict(load=-2000.0,
                                                        plastic=MISES)),
}


def _jax_solves(monkeypatch):
    """Record ("cg", iterations) of every JAX effective solve and
    ("step", i) after every committed step, in order."""
    events = []

    def pcg(*a, **kw):
        res = jcg.pcg(*a, **kw)
        jax.debug.callback(lambda k: events.append(("cg", int(k))),
                           res.iters, ordered=True)
        return res
    monkeypatch.setattr(jdyn, "krylov", types.SimpleNamespace(pcg=pcg))
    return events


def _per_step(events):
    """[[cg, ...] per step] from the JAX event list."""
    steps, cur = [], []
    for kind, v in events:
        if kind == "cg":
            cur.append(v)
        else:
            steps.append(cur)
            cur = []
    return steps + ([cur] if cur else [])


@pytest.mark.parametrize("case", list(CASES))
def test_implicit_matches_jax(tmp_path, monkeypatch, case):
    mk, scan, kw = CASES[case]
    monkeypatch.setenv("FRONTISTR_TPU_IMPLICIT_SCAN", scan)
    nonlinear = "load" in kw
    mesh = mk(3, 2, 2)
    mesh.amplitudes["RAMP"] = Amplitude("RAMP", "TABULAR",
                                        np.asarray([0.0, 2.0e-7]),
                                        np.asarray([0.0, 1.0]))
    n_step = 3 if nonlinear else 4
    cnt = dyn_deck(
        1, n_step=n_step, dt=1.0e-7, ray_m=0.0 if nonlinear else 1.0e4,
        ray_k=0.0 if nonlinear else 1.0e-8,
        typ=", TYPE=NONLINEAR" if nonlinear else "",
        loads=f"!CLOAD, AMP=RAMP\n X1, 3, {kw.get('load', -1.0)!r}\n",
        plastic=kw.get("plastic", ""))
    p = tmp_path / "case.cnt"
    p.write_text(cnt)
    jm = jbuild(mesh, jread_cnt(str(p)))
    pm = build_struct_model(mesh, read_cnt(str(p)), device="cpu")
    events = _jax_solves(monkeypatch)
    train = scan == "1" and not nonlinear
    # the step marks come from on_interval, which selects the Newton
    # loop; the linear step train is one solve a step by construction
    mark = None if train else (lambda i, *a: events.append(("step", i)))
    want = jdyn.run_dynamic(jm, on_interval=mark)
    got = dyn.run_dynamic(pm, on_interval=None if train else
                          (lambda *a: None))
    assert got.arm == ("linear" if train else "newton")
    for f in ("u", "vel", "acc"):
        a, b = getattr(got, f), getattr(want, f)
        assert np.isfinite(a).all() and np.abs(b).max() > 0.0
        assert np.abs(a - b).max() <= 1e-8 * np.abs(b).max(), f
    jsteps = [[v for _, v in events]] if train else _per_step(events)
    if train:
        jsteps = [[v] for v in jsteps[0]]
    psteps = [h["cg"] for h in got.history]
    assert [len(s) for s in psteps] == [len(s) for s in jsteps]
    assert all(abs(a - b) <= 1 for ps, js in zip(psteps, jsteps)
               for a, b in zip(ps, js)), (psteps, jsteps)
    assert [h["newton"] for h in got.history] == [len(s) for s in jsteps]
    if nonlinear:
        assert max(h["newton"] for h in got.history) > 1
    if "plastic" in kw:
        assert got.final.nodal_mises.max() > 250.0
