"""The u-p flow stepper (3414) through ``run_directory`` in the port
against the JAX package's ``run_flow`` and ``write_flow_result`` on the
CPU: the lid-driven cavity at mu = 1 (the Stokes limit, with
FRONTISTR_TPU_REORDER=1), mu = 0.01 (advection dominated) and with a
pressure condition and several solves a step, on a shuffled
``box_tet4(3)`` cube, 2 steps.

Bars: velocity, pressure, strain rate and stress within 1e-8 of the
largest; the linear-solve count equal and the BiCGSTAB count of every
solve within 10% + 2; the 0.log step lines equal; the port's ``.res``
writer byte-equal to the JAX writer's on the JAX package's result, and
the port's own file read back within 1e-8.  The lid holds exactly."""

import os

import numpy as np
import pytest

import frontistr_tpu.analysis.flow as jflow
from frontistr_tpu_torch.analysis.flow import write_flow_result
from frontistr_tpu_torch.io.resfile import read_result

from _torch_flow_decks import cavity_cnt, flow_mesh, rel, run_both

CASES = {
    # name: (deck keywords, env)
    "stokes_reordered": (dict(mu=1.0, rho=1.0, dt=0.25),
                         {"FRONTISTR_TPU_REORDER": "1"}),
    "advective": (dict(mu=0.01, rho=1.0, dt=1.0 / 3.0), {}),
    # a pressure condition on X0 (no gauge pin) and a loose RESID under
    # a tight CONVERG: several solves a step, up to MAXITER
    "pressure_bc": (dict(mu=0.05, rho=2.0, dt=0.2, resid="1.0e-2",
                         pressure=" X0, 4, 4, 0.0\n",
                         step="!STEP, CONVERG=1.0e-12, MAXITER=3\n"), {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cavity_matches_jax(tmp_path, monkeypatch, case):
    kw, envs = CASES[case]
    for k, v in envs.items():
        monkeypatch.setenv(k, v)
    counts = []
    jbicgstab = jflow.bicgstab

    def spy(*a, **k):
        res = jbicgstab(*a, **k)
        counts.append(int(res.iters))
        return res
    monkeypatch.setattr(jflow, "bicgstab", spy)
    mesh = flow_mesh(3)
    ot, oj, wd, wj = run_both(tmp_path, mesh, cavity_cnt(n_step=2, **kw))
    ft, fj = ot["flow"], oj["flow"]
    assert ft.steps == fj.steps == 2
    for name in ("strain", "stress"):
        assert rel(getattr(ft, name), getattr(fj, name)) <= 1e-8
    assert rel(ft.v[:, :3], fj.v[:, :3]) <= 1e-8
    assert rel(ft.v[:, 3], fj.v[:, 3]) <= 1e-8
    assert ft.iters == fj.iters
    mine = [c for h in ft.history for c in h["bicgstab"]]
    assert len(mine) == len(counts) >= 2
    for a, b in zip(mine, counts):
        assert abs(a - b) <= 0.1 * b + 2
    if case == "pressure_bc":
        assert len(mine) > 2
    else:
        assert all(h["resid"] <= 1e-8 for h in ft.history)
    # the lid (the last !BOUNDARY rows) holds exactly
    lid = ot["mesh"].node_groups["Z1"]
    assert np.all(ft.v[lid, 0] == 1.0) and np.all(ft.v[lid, 1:3] == 0.0)
    with open(os.path.join(wd, "0.log")) as a, \
            open(os.path.join(wj, "0.log")) as b:
        assert a.read() == b.read()
    # the .res: the port's writer on the JAX result is byte-equal to the
    # JAX file; the port's own file holds the port's fields
    jres = os.path.join(wj, "mesh.res.0.2")
    mine_path = str(tmp_path / "jax_through_port.res")
    write_flow_result(mine_path, oj["mesh"], fj, step=2)
    with open(mine_path, "rb") as a, open(jres, "rb") as b:
        assert a.read() == b.read()
    back = read_result(os.path.join(wd, "mesh.res.0.2"))
    vel = dict(back["node_comps"])["VELOCITY"]
    assert rel(vel, ft.v[:, :3]) <= 1e-15
