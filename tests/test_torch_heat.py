"""The heat slice of the port (``analysis/heat.py``) against the JAX
package's ``analysis/heat.py`` on the CPU.

- ``_interp`` against ``jnp.interp`` on random temperatures, the knots,
  both clamps, a one-row table and a repeated knot: equal to the last
  bit but one (1e-15 relative).
- The element routines (``conduct_ke``, ``interface_ke_541``,
  ``lumped_capacity`` row-sum and HRZ, ``_surface_film_terms`` film and
  radiation) and ``weld_flux``, fed the JAX package's ``HeatModel``
  through ``convert.heat_model_from_numpy`` and random temperatures:
  within 1e-12 of each result's largest magnitude.
- Whole decks through both packages' ``run_directory`` (``heat_mesh`` of
  ``_torch_decks``: hex8, tet4, tet10, quad, triangle and a 541 pair,
  interior nodes jittered from a seed so that no two nodes tie by
  symmetry), steady and transient, with !CFLUX, !DFLUX BF, !SFLUX,
  !SFILM, !SRADIATE, !ZERO, an initial temperature and, on three meshes,
  a weld line and ``!WRITE, RESULT, FREQUENCY=2`` (the JAX package's
  eager arm; the others take its ``lax.scan``): temperatures within
  1e-8 of the largest at RESID 1e-12, the same steps and fixed-point
  iterations, the 0.log equal line for line and the ``.res`` snapshots
  equal in ids and within 1e-8.
- A heat result read by a STATIC deck's ``!TEMPERATURE, READRESULT``:
  displacements within 1e-8 of the largest.
- ``!WRITE, VISUAL, FREQUENCY=2`` (PSR): the JAX runner's pictures.
- Each excluded feature raises ``NotImplementedError`` naming itself.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import frontistr_tpu.run as jrun
from frontistr_tpu.analysis import heat as jheat
from frontistr_tpu.io.ctrlio import read_cnt as jread_cnt
from frontistr_tpu.io.resfile import read_result_any as jread_res
from frontistr_tpu_torch.analysis import heat
from frontistr_tpu_torch.assembly.loads import FACE_TABLES
from frontistr_tpu_torch.convert import heat_model_from_numpy
from frontistr_tpu_torch.elements.tables import get_table
from frontistr_tpu_torch.io.resfile import read_result_any
from frontistr_tpu_torch.run import run_directory

from _torch_decks import heat_deck, heat_mesh, shi_faces, write_heat_deck
from _torch_vis_decks import VISUAL, assert_pictures_close, run_pair

KINDS = ("hex8", "tet4", "tet10", "quad", "tri", "iface")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("FRONTISTR_TPU_COMPILE_CACHE", "0")
    monkeypatch.setenv("FRONTISTR_TPU_REORDER", "1")


TABLES = {
    "three_rows": np.asarray([[50.0, 0.0], [42.0, 150.0], [30.0, 400.0]]),
    "one_row": np.asarray([[7.8e-6, 0.0]]),
    "repeated_knot": np.asarray([[1.0, -10.0], [2.0, 50.0], [5.0, 50.0],
                                 [4.0, 80.0]]),
}


@pytest.mark.parametrize("name", list(TABLES))
def test_interp_matches_jnp(name):
    tab = TABLES[name]
    rng = np.random.default_rng(11)
    T = np.concatenate([rng.uniform(-200.0, 600.0, 500), tab[:, 1],
                        [tab[0, 1] - 1.0, tab[-1, 1] + 1.0, 1e9, -1e9]])
    if len(tab) == 1:
        want = np.full_like(T, tab[0, 0])
    else:
        want = np.asarray(jnp.interp(jnp.asarray(T), jnp.asarray(tab[:, 1]),
                                     jnp.asarray(tab[:, 0])))
    got = heat._interp(tab, torch.as_tensor(T)[None, :]).numpy()
    np.testing.assert_allclose(got.reshape(-1), want, rtol=1e-15, atol=0)


def _models(kind, tmp_path):
    mesh = heat_mesh(kind)
    cnt = tmp_path / "h.cnt"
    cnt.write_text(heat_deck(mesh, weld=True))
    mesh.surf_groups = {"SHI": shi_faces(mesh)}
    jm = jheat.build_heat_model(mesh, jread_cnt(str(cnt)))
    return jm, heat_model_from_numpy(jm, "cpu")


def _close(got, want, bar=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=bar * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("kind", KINDS)
def test_element_routines_match_jax(tmp_path, kind):
    jm, tm = _models(kind, tmp_path)
    rng = np.random.default_rng(7)
    T = rng.uniform(0.0, 450.0, jm.n_node)
    Tt = torch.as_tensor(T)
    for jb, tb in zip(jm.blocks, tm.blocks):
        ce = np.asarray(jm.coords[jb.conn])
        cet, Tet = torch.as_tensor(ce), Tt[torch.as_tensor(tb.conn)]
        if jb.iface is not None:
            _close(heat.interface_ke_541(cet, Tet, tm.zero_temp, *tb.iface),
                   jheat.interface_ke_541(jnp.asarray(ce),
                                          jnp.asarray(T[jb.conn]),
                                          jm.zero_temp, *jb.iface))
            continue
        table = get_table(tb.etype)
        jtab = jheat.get_table(jb.etype)
        _close(heat.conduct_ke(table, cet, Tet, tb.cond_table, tb.thick,
                               tm.dim),
               jheat.conduct_ke(jtab, jnp.asarray(ce),
                                jnp.asarray(T[jb.conn]), jb.cond_table,
                                jb.thick, jm.dim))
        for hrz in (False, True):
            _close(heat.lumped_capacity(table, cet, Tet, tb.rho_table,
                                        tb.cp_table, tb.thick, tm.dim,
                                        hrz=hrz),
                   jheat.lumped_capacity(jtab, jnp.asarray(ce),
                                         jnp.asarray(T[jb.conn]),
                                         jb.rho_table, jb.cp_table,
                                         jb.thick, jm.dim, hrz=hrz))
    assert jm.films and jm.radiates
    for kind_, entries in (("film", jm.films), ("rad", jm.radiates)):
        for bi, sel, face, coef, sink in entries:
            b = jm.blocks[bi]
            ftype, ln = FACE_TABLES[b.etype][face - 1]
            fc = np.asarray(jm.coords[b.conn[sel]][:, ln, :])
            fconn = b.conn[sel][:, ln]
            got = heat._surface_film_terms(
                get_table(ftype), torch.as_tensor(fc), Tt[fconn], coef,
                sink, kind_, tm.zero_temp, b.thick, tm.dim)
            want = jheat._surface_film_terms(
                jheat.get_table(ftype), jnp.asarray(fc),
                jnp.asarray(T[fconn]), coef, sink, kind_, jm.zero_temp,
                b.thick, jm.dim)
            _close(got[0], want[0])
            _close(got[1], want[1])
    assert tm.weldlines
    for t in (0.5, 2.0, 3.9):
        _close(heat.weld_flux(tm, t), jheat.weld_flux(jm, t))
    np.testing.assert_array_equal(tm.f_const, jm.f_const)


# (kind, transient, weld line and !WRITE, RESULT)
RUNS = [(k, tr, False) for k in KINDS for tr in (False, True)] + \
    [(k, True, True) for k in ("hex8", "tri", "iface")]


def _by_id(out, field):
    ids = np.asarray(out["mesh"].node_ids)
    return np.asarray(field)[np.argsort(ids)]


@pytest.mark.parametrize("kind,transient,weld", RUNS,
                         ids=[f"{k}-{'transient' if t else 'steady'}"
                              f"{'-weld' if w else ''}" for k, t, w in RUNS])
def test_run_heat_matches_jax(tmp_path, kind, transient, weld):
    mesh = heat_mesh(kind)
    cnt = heat_deck(mesh, transient=transient, weld=weld,
                    write="!WRITE, RESULT, FREQUENCY=2\n" if weld else "")
    wd = write_heat_deck(tmp_path / "port", mesh, cnt)
    wj = str(tmp_path / "jax")
    shutil.copytree(wd, wj)
    oj = jrun.run_directory(wj)
    ot = run_directory(wd, device="cpu")
    hj, ht = oj["heat"], ot["heat"]
    assert (ht.steps, ht.iters) == (hj.steps, hj.iters)
    Tj = _by_id(oj, hj.T)
    np.testing.assert_allclose(_by_id(ot, ht.T), Tj, rtol=0,
                               atol=1e-8 * np.abs(Tj).max())
    with open(os.path.join(wj, "0.log")) as fj, \
            open(os.path.join(wd, "0.log")) as ft:
        assert ft.read().splitlines() == fj.read().splitlines()
    res = sorted(f for f in os.listdir(wj) if ".res." in f)
    assert res == sorted(f for f in os.listdir(wd) if ".res." in f)
    assert bool(res) == weld
    for f in res:
        a, b = jread_res(os.path.join(wj, f)), read_result_any(
            os.path.join(wd, f))
        ia, ib = np.argsort(a["node_ids"]), np.argsort(b["node_ids"])
        np.testing.assert_array_equal(np.asarray(b["node_ids"])[ib],
                                      np.asarray(a["node_ids"])[ia])
        (na, va), = a["node_comps"]
        (nb, vb), = b["node_comps"]
        assert na == nb == "TEMPERATURE"
        va, vb = np.asarray(va)[ia], np.asarray(vb)[ib]
        np.testing.assert_allclose(vb, va, rtol=0,
                                   atol=1e-8 * np.abs(va).max())


def test_transient_restart_matches_jax(tmp_path):
    """A transient deck with !RESTART, FREQUENCY=2 (formerly refused):
    T, the counts and the 0.log as the JAX package's, and the last
    checkpoint's T, t and step count."""
    from frontistr_tpu.io.restart import load_restart as jload
    mesh = heat_mesh("hex8")
    cnt = heat_deck(mesh).replace("!END", "!RESTART, FREQUENCY=2\n!END")
    wd = write_heat_deck(tmp_path / "port", mesh, cnt)
    wj = str(tmp_path / "jax")
    shutil.copytree(wd, wj)
    oj = jrun.run_directory(wj)
    ot = run_directory(wd, device="cpu")
    hj, ht = oj["heat"], ot["heat"]
    assert (ht.steps, ht.iters) == (hj.steps, hj.iters) and ht.steps >= 2
    Tj = _by_id(oj, hj.T)
    np.testing.assert_allclose(_by_id(ot, ht.T), Tj, rtol=0,
                               atol=1e-8 * np.abs(Tj).max())
    with open(os.path.join(wj, "0.log")) as fj, \
            open(os.path.join(wd, "0.log")) as ft:
        assert ft.read().splitlines() == fj.read().splitlines()
    a, b = (jload(os.path.join(d, "restart.npz")) for d in (wd, wj))
    assert int(a["steps"]) == int(b["steps"]) == ht.steps - ht.steps % 2
    assert abs(float(a["t"]) - float(b["t"])) <= 1e-12 * float(b["t"])
    np.testing.assert_allclose(np.sort(a["T"]), np.sort(b["T"]), rtol=0,
                               atol=1e-8 * np.abs(b["T"]).max())


STATIC_READ = ("!VERSION\n 3\n!SOLUTION, TYPE=STATIC\n!BOUNDARY\n"
               " X0, 1, 3, 0.0\n!TEMPERATURE, READRESULT=1, SSTEP=1\n"
               "!REFTEMP\n 20.0\n!MATERIAL, NAME=M1\n!ELASTIC\n"
               " 210000.0, 0.3\n!EXPANSION_COEFF\n 1.2e-5\n"
               "!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
               " 1.0e-10, 1.0, 0.0\n!END\n")


def test_heat_readresult_static_matches_jax(tmp_path, monkeypatch):
    """A steady heat run's ``.res`` read by a STATIC deck's
    ``!TEMPERATURE, READRESULT=1`` through the fstrTEMP binding."""
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", "f64")
    mesh = heat_mesh("hex8")
    wd = write_heat_deck(tmp_path / "port", mesh, heat_deck(
        mesh, transient=False, write="!WRITE, RESULT\n"))
    run_directory(wd, device="cpu")
    assert os.path.exists(os.path.join(wd, "mesh.res.0.1"))
    with open(os.path.join(wd, "case.cnt"), "w") as f:
        f.write(STATIC_READ)
    with open(os.path.join(wd, "hecmw_ctrl.dat"), "a") as f:
        f.write("!RESULT, NAME=fstrTEMP, IO=IN\n mesh.res\n")
    wj = str(tmp_path / "jax")
    shutil.copytree(wd, wj)
    oj = jrun.run_directory(wj)
    ot = run_directory(wd, device="cpu")
    T = ot["model"].temperature
    assert T is not None and T.max() > 90.0
    np.testing.assert_allclose(_by_id(ot, T), _by_id(oj, oj[
        "model"].temperature), rtol=0, atol=1e-12 * np.abs(T).max())
    uj = _by_id(oj, np.asarray(oj["static"].u).reshape(-1, 3))
    np.testing.assert_allclose(
        _by_id(ot, np.asarray(ot["static"].u).reshape(-1, 3)), uj, rtol=0,
        atol=1e-8 * np.abs(uj).max())


def test_write_visual_matches_jax(tmp_path, capsys):
    """``!WRITE, VISUAL, FREQUENCY=2`` on a transient deck of 3 steps
    (formerly refused), the PSR surface: the JAX runner's file set,
    ``result.2.bmp`` alone, the picture within ``_torch_vis_decks``' bar
    (one level a byte, 0.1% of the pixels further apart)."""
    mesh = heat_mesh("hex8")
    cnt = heat_deck(mesh, write=VISUAL.format(freq=", FREQUENCY=2",
                                              method="PSR", more=""))
    wd = write_heat_deck(tmp_path / "port", mesh, cnt)
    got, want, wj = run_pair(wd)
    assert "visualizer skipped" not in capsys.readouterr().out
    assert got["heat"].steps == want["heat"].steps == 3
    files = sorted(f for f in os.listdir(wj) if f.endswith(".bmp"))
    assert files == ["result.2.bmp"]
    assert files == sorted(f for f in os.listdir(wd) if f.endswith(".bmp"))
    for f in files:
        assert_pictures_close(os.path.join(wd, f), os.path.join(wj, f))
    assert {"psr_extract", "psr_render"} <= set(got["timings"])


UNPORTED = {
    # name: (deck edit, env, mesh edit, message)
    # sharded HEAT runs (tests/test_torch_shard_families.py): the case
    # holds two spawned ranks' answer to the single run's; its !RESTART
    # is refused by name
    "shards": (None, {"FRONTISTR_TPU_SHARDS": "2"}, None, None),
}


@pytest.mark.parametrize("case", list(UNPORTED))
def test_unported_heat_requests_raise(tmp_path, monkeypatch, case):
    edit, envs, medit, msg = UNPORTED[case]
    for k, v in envs.items():
        monkeypatch.setenv(k, v)
    mesh = heat_mesh("hex8")
    if medit is not None:
        mesh = medit(mesh)
    cnt = heat_deck(mesh)
    if edit is not None:
        cnt = edit(cnt)
    wd = write_heat_deck(tmp_path / "wd", mesh, cnt)
    if msg is None:
        got = run_directory(wd, device="cpu")["heat"]
        cntp = os.path.join(wd, "case.cnt")
        with open(cntp) as f:
            txt = f.read()
        with open(cntp, "w") as f:
            f.write(txt.replace("!END", "!RESTART, FREQUENCY=1\n!END"))
        with pytest.raises(NotImplementedError,
                           match="RESTART under FRONTISTR_TPU_SHARDS"):
            run_directory(wd, device="cpu")
        for k in envs:
            monkeypatch.delenv(k)
        want = run_directory(wd, device="cpu")["heat"]
        np.testing.assert_allclose(got.T, want.T, rtol=1e-8, atol=0)
        return
    with pytest.raises(NotImplementedError, match=msg):
        run_directory(wd, device="cpu")
