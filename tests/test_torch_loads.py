"""The load assembly of the port (``assembly/loads.py``) against the JAX
package's, on the CPU: ``collect_dload`` for every DLOAD type (BX, BY,
BZ, GRAV, CENT, P1..P6 on element groups, S on a surface group) on tet4
(341), tet10 (342) and hex8 (361) meshes; ``FollowerDload`` at a
deformed geometry against the JAX package's; ``collect_temperature``,
``thermal_strains`` and ``thermal_load``; and the model build's
``f_ext`` / ``f_base`` with DLOAD and TEMPERATURE cards.

Meshes: ``box_tet4(3, 2, 2)``, its tet10 raise and ``box_hex8(3, 2, 2)``
with every node moved by up to 5% of the spacing (numpy seed), so no
two faces alike.  Bar: float64, within 1e-12 of the largest magnitude.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from frontistr_tpu.assembly import loads as jloads
from frontistr_tpu.assembly.model import build_struct_model as jbuild
from frontistr_tpu.io.ctrlio import read_cnt as jread_cnt
from frontistr_tpu_torch import convert
from frontistr_tpu_torch.assembly import loads
from frontistr_tpu_torch.assembly.model import build_struct_model
from frontistr_tpu_torch.io.ctrlio import read_cnt
from frontistr_tpu_torch.meshgen import box_hex8, box_tet4

from _torch_decks import tet10_box, top_faces

BODY = {"BX": " ALL, BX, 2.0\n", "BY": " ALL, BY, -1.5\n",
        "BZ": " ALL, BZ, 0.5\n",
        "GRAV": " ALL, GRAV, 9.8, 0.3, 0.0, -1.0\n",
        "CENT": " ALL, CENT, 100.0, 0.1, 0.2, 0.0, 0.2, 0.1, 1.0\n",
        "S": " STOP, S, 4.0\n"}
CASES = [(e, t) for e in (341, 342, 361)
         for t in list(BODY) + [f"P{k}" for k in
                                range(1, 5 if e != 361 else 7)]]


def _mesh(etype):
    m = {341: lambda: box_tet4(3, 2, 2), 342: lambda: tet10_box(3, 2, 2),
         361: lambda: box_hex8(3, 2, 2)}[etype]()
    rows = top_faces(m)
    rng = np.random.default_rng(etype)
    m.coords = m.coords + 0.05 * 0.33 * rng.uniform(-1, 1, m.coords.shape)
    m.elem_groups["TOP"] = np.unique(rows[:, 0])
    m.surf_groups["STOP"] = rows
    return m


def _models(tmp_path, etype, extra):
    p = tmp_path / "case.cnt"
    p.write_text("!VERSION\n 3\n!SOLUTION, TYPE=NLSTATIC\n!BOUNDARY\n"
                 " X0, 1, 3, 0.0\n" + extra + "!MATERIAL, NAME=M1\n"
                 "!ELASTIC\n 210000.0, 0.3\n!EXPANSION_COEFF\n 1.1e-5\n"
                 "!SOLVER, METHOD=CG\n 10000, 1\n 1.0e-8, 1.0, 0.0\n!END\n")
    mesh = _mesh(etype)
    jm = jbuild(mesh, jread_cnt(str(p)))
    pm = build_struct_model(mesh, read_cnt(str(p)), device="cpu")
    return mesh, jm, pm


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.isfinite(a).all()
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("etype,token", CASES)
def test_collect_dload_matches_jax(tmp_path, etype, token):
    row = BODY.get(token, f" TOP, {token}, 3.0\n")
    mesh, jm, pm = _models(tmp_path, etype, "!DLOAD\n" + row)
    want = jloads.collect_dload(mesh, jm, jm.cfg.dloads)
    got = loads.collect_dload(mesh, pm, pm.cfg.dloads)
    assert np.abs(want).max() > 0
    assert _rel(got, want) <= 1e-12
    # the model build adds it to f_ext and keeps f_base without it
    assert _rel(pm.f_ext, jm.f_ext) <= 1e-12
    assert _rel(pm.f_base, jm.f_base) <= 1e-12


@pytest.mark.parametrize("etype", [341, 342, 361])
def test_follower_dload_matches_jax(tmp_path, etype):
    rows = "".join(BODY[t] for t in ("BX", "GRAV", "CENT", "S")) + \
        " TOP, P2, 3.0\n TOP, P1, -2.0\n"
    mesh, jm, pm = _models(tmp_path, etype, "!DLOAD\n" + rows)
    jf = jloads.FollowerDload(jm, jm.cfg.dloads)
    assert jf.ok
    pf = loads.FollowerDload(pm, *pm.dload_grp)
    u = 0.02 * np.random.default_rng(7).standard_normal(pm.n_dof_total)
    want = np.asarray(jf(jnp.asarray(u)))
    got = pf(torch.as_tensor(u))
    assert _rel(got, want) <= 1e-12
    # at u = 0 it is the dead load
    assert _rel(pf(torch.zeros(pm.n_dof_total, dtype=torch.float64)),
                jloads.collect_dload(mesh, jm, jm.cfg.dloads)) <= 1e-12


def test_follower_dload_group_filter(tmp_path):
    mesh, jm, pm = _models(tmp_path, 361, "!DLOAD\n TOP, P2, 3.0\n"
                           "!DLOAD, GRPID=2\n ALL, BX, 1.0\n")
    u = torch.as_tensor(0.01 * np.random.default_rng(8).standard_normal(
        pm.n_dof_total))
    for sel in ({1}, {2}, set()):
        want = jloads.collect_dload(
            mesh, jm, jm.cfg.dloads, sel,
            coords=jm.coords + u.numpy().reshape(-1, 3))
        got = loads.FollowerDload(pm, pm.cfg.dloads, sel)(u)
        assert np.abs(got.numpy() - want).max() <= \
            1e-12 * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("etype", [341, 342, 361])
def test_temperature_and_thermal_load_match_jax(tmp_path, etype):
    extra = "!REFTEMP\n 15.0\n!TEMPERATURE\n Z1, 80.0\n X1, 40.0\n 1, 5.0\n"
    mesh, jm, pm = _models(tmp_path, etype, extra)
    T = loads.collect_temperature(mesh, pm.cfg.temperatures, pm.n_node,
                                  pm.cfg.reftemp)
    Tj = jloads.collect_temperature(mesh, jm.cfg.temperatures, jm.n_node,
                                    jm.cfg.reftemp)
    assert np.array_equal(T, Tj) and np.array_equal(pm.temperature, Tj)
    assert pm.reftemp == 15.0
    for b, jb in zip(pm.blocks, jm.blocks):
        assert _rel(loads.thermal_strains(pm, b, T),
                    jloads.thermal_strains(jm, jb, Tj)) <= 1e-12
    assert _rel(loads.thermal_load(pm, T),
                jloads.thermal_load(jm, Tj)) <= 1e-12
    assert _rel(pm.f_ext, jm.f_ext) <= 1e-12


def test_no_temperature_match_is_none(tmp_path):
    mesh, jm, pm = _models(tmp_path, 341, "!TEMPERATURE\n NOSUCH, 80.0\n")
    assert pm.temperature is None and jm.temperature is None
    assert loads.collect_temperature(mesh, pm.cfg.temperatures, pm.n_node,
                                     0.0) is None


def test_model_from_numpy_carries_loads(tmp_path):
    mesh, jm, _ = _models(tmp_path, 361, "!DLOAD\n TOP, P2, 3.0\n"
                          "!TEMPERATURE\n Z1, 80.0\n")
    pm = convert.model_from_numpy(jm, device="cpu")
    assert np.array_equal(pm.f_base, jm.f_base)
    assert np.array_equal(pm.temperature, jm.temperature)
    assert pm.dload_grp[0] is jm.dload_grp[0]
