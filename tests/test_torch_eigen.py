"""The eigen slice of the port (``analysis/eigen.py``, ``analysis/freq.py``)
against the JAX package on the CPU.

- EIGEN decks through both packages' ``run_directory`` on tet4, tet10 and
  hex8 (IC) boxes whose sides differ (no repeated eigenvalue), shuffled
  and RCM-reordered: eigenvalues within 1e-8 relative, the same Lanczos
  iterations, participation factors and effective masses within 1e-6 of
  the largest, modes equal up to sign within 1e-6 of the largest entry,
  the EGLIST block equal after parsing (to its print precision, 1e-4
  relative; the participation columns up to sign), and the mode ``.res``
  files the same modes up to sign.
- The square beam of ``tests/test_freq_restart.py`` (its first two
  bending modes are one repeated eigenvalue): the pair's subspace and its
  effective masses summed over the pair, instead of the vectors.
- ``run_frequency`` with !FLOAD in LOAD CASE 1 and 2 and Rayleigh
  damping, both packages fed the same modes: displacements and amplitude
  maxima within 1e-10 of the largest.
- ``!EIGENREAD`` and STATICEIGEN: tests/test_torch_eigen_static.py (a
  file of their own, so that ``--dist loadfile`` spreads the runs over
  two workers).
- Each excluded feature raises ``NotImplementedError`` naming itself.
"""

import os
import shutil

import numpy as np
import pytest

import frontistr_tpu.run as jrun
from frontistr_tpu.analysis import eigen as jeigen
from frontistr_tpu.analysis.dynamic import lumped_mass_vector as jmass
from frontistr_tpu.analysis import freq as jfreq
from frontistr_tpu.assembly.model import build_struct_model as jbuild
from frontistr_tpu.io.ctrlio import read_cnt as jread_cnt
from frontistr_tpu.io.resfile import read_result_any as jread_res
from frontistr_tpu_torch.analysis import freq
from frontistr_tpu_torch.assembly.model import build_struct_model
from frontistr_tpu_torch.io.ctrlio import read_cnt
from frontistr_tpu_torch.io.neu import write_static_workdir
from frontistr_tpu_torch.io.resfile import read_result_any
from frontistr_tpu_torch.meshgen import box_hex8, box_tet4
from frontistr_tpu_torch.run import run_directory

from _torch_decks import tet10_box, write_deck


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("FRONTISTR_TPU_COMPILE_CACHE", "0")
    monkeypatch.setenv("FRONTISTR_TPU_REORDER", "1")
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", "f64")


EIGEN = ("!VERSION\n 3\n!SOLUTION, TYPE={sol}\n!EIGEN\n {nget}, 1.0e-8, 60\n"
         "!BOUNDARY\n X0, 1, 3, 0.0\n{loads}!MATERIAL, NAME=M1\n!ELASTIC\n"
         " 210000.0, 0.3\n!DENSITY\n 7.85e-9\n{step}"
         "!SOLVER, METHOD=CG, PRECOND=1, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
         " 1.0e-10, 1.0, 0.0\n!WRITE, RESULT\n!END\n")


def eigen_deck(sol="EIGEN", nget=5, loads="", step=""):
    return EIGEN.format(sol=sol, nget=nget, loads=loads, step=step)


def _mesh(kind):
    if kind == "tet4":
        return box_tet4(4, 2, 2, lx=4.0, ly=1.0, lz=0.6)
    if kind == "tet10":
        m = tet10_box(3, 2, 1)
        m.coords = m.coords * [3.0, 1.0, 0.6]
        return m
    if kind == "hex8":
        return box_hex8(4, 2, 2, lx=4.0, ly=1.0, lz=0.6)
    return box_hex8(6, 1, 1, lx=6.0)                       # "beam"


def _by_id(out, rows):
    """Node-major rows (n_node, ...) of ``rows`` ordered by node id."""
    ids = np.asarray(out["mesh"].node_ids)
    return np.asarray(rows).reshape(len(ids), -1)[np.argsort(ids)]


def _clusters(lam, gap=1e-6):
    """Index groups of eigenvalues within ``gap`` relative of each other."""
    groups, cur = [], [0]
    for i in range(1, len(lam)):
        if abs(lam[i] - lam[cur[-1]]) <= gap * abs(lam[i]):
            cur.append(i)
        else:
            groups.append(cur)
            cur = [i]
    return groups + [cur]


def _modes(out, er):
    """(n_node * 3, nget) modes in node-id order."""
    k = er.eigenvectors.shape[1]
    return _by_id(out, er.eigenvectors.reshape(-1, 3 * k)).reshape(
        -1, 3, k).reshape(-1, k)


def _hold_eigen(oj, ot):
    """The bars of the module docstring for two run_directory outputs."""
    ej, et = oj["eigen"], ot["eigen"]
    assert et.iters == ej.iters
    np.testing.assert_allclose(et.eigenvalues, ej.eigenvalues, rtol=1e-8)
    mj, mt = _modes(oj, ej), _modes(ot, et)
    m = _by_id(oj, np.asarray(jmass(oj["model"]))).reshape(-1)
    for g in _clusters(ej.eigenvalues):
        if len(g) == 1:
            i = g[0]
            s = np.sign(mj[:, i] @ mt[:, i])
            np.testing.assert_allclose(s * mt[:, i], mj[:, i], rtol=0,
                                       atol=1e-6 * np.abs(mj[:, i]).max())
            np.testing.assert_allclose(s * et.partfactor[i],
                                       ej.partfactor[i], rtol=0, atol=1e-6 *
                                       np.abs(ej.partfactor).max())
            np.testing.assert_allclose(et.effmass[i], ej.effmass[i], rtol=0,
                                       atol=1e-6 * np.abs(ej.effmass).max())
        else:
            # a repeated eigenvalue: the same M-orthonormal subspace
            P, Q = mj[:, g], mt[:, g]
            resid = Q - P @ (P.T @ (m[:, None] * Q))
            assert np.abs(resid).max() <= 1e-6 * np.abs(Q).max()
            np.testing.assert_allclose(et.effmass[g].sum(0),
                                       ej.effmass[g].sum(0), rtol=0,
                                       atol=1e-6 * np.abs(ej.effmass).max())
    return mj, mt


def _eglist(path):
    """The EGLIST rows of an eigen 0.log as floats: (nget, 9)."""
    rows, on = [], False
    with open(path) as f:
        for ln in f:
            t = ln.split()
            if ln.strip().startswith("---"):
                on = True
            elif on and t and t[0].isdigit():
                rows.append([float(v) for v in t[1:]])
            elif on and not t:
                break
    return np.asarray(rows)


def _pair(tmp_path, mesh, cnt):
    wd = write_deck(tmp_path / "port", mesh, cnt)
    wj = str(tmp_path / "jax")
    shutil.copytree(wd, wj)
    return wj, wd


@pytest.mark.parametrize("kind", ["tet4", "tet10", "hex8", "beam"])
def test_eigen_run_directory_matches_jax(tmp_path, kind):
    wj, wd = _pair(tmp_path, _mesh(kind), eigen_deck(nget=4 if kind ==
                                                      "beam" else 5))
    oj = jrun.run_directory(wj)
    ot = run_directory(wd, device="cpu")
    assert ot["model"].blocks[0].formulation == \
        ("IC" if kind in ("hex8", "beam") else "FI")
    mj, mt = _hold_eigen(oj, ot)
    gj = _eglist(os.path.join(wj, "0.log"))
    gt = _eglist(os.path.join(wd, "0.log"))
    assert gt.shape == gj.shape == (len(ot["eigen"].eigenvalues), 9)
    np.testing.assert_allclose(gt[:, :3], gj[:, :3], rtol=1e-4)
    single = [g[0] for g in _clusters(oj["eigen"].eigenvalues) if len(g) == 1]
    for cols in (slice(3, 6), slice(6, 9)):
        np.testing.assert_allclose(
            np.abs(gt[single, cols]), np.abs(gj[single, cols]), rtol=1e-4,
            atol=1e-6 * np.abs(gj[:, cols]).max())
    for k in single:
        a = jread_res(os.path.join(wj, f"mesh.res.0.{k + 1}"))
        b = read_result_any(os.path.join(wd, f"mesh.res.0.{k + 1}"))
        va = np.asarray(a["node_comps"][0][1])[np.argsort(a["node_ids"])]
        vb = np.asarray(b["node_comps"][0][1])[np.argsort(b["node_ids"])]
        s = np.sign((va * vb).sum())
        np.testing.assert_allclose(s * vb, va, rtol=0,
                                   atol=1e-6 * np.abs(va).max())


FLOAD = ("!FLOAD, LOAD CASE=1\n X1, 3, 1.0\n!FLOAD, LOAD CASE=2\n"
         " {node}, 2, 0.5\n")


def _models(tmp_path, mesh, cnt):
    p = tmp_path / "c.cnt"
    p.write_text(cnt)
    return (jbuild(mesh, jread_cnt(str(p))),
            build_struct_model(mesh, read_cnt(str(p)), device="cpu"))


def test_run_frequency_matches_jax(tmp_path):
    mesh = _mesh("hex8")
    jm, tm = _models(tmp_path, mesh, eigen_deck(
        loads=FLOAD.format(node=int(mesh.node_ids[-1]))))
    eig = jeigen.run_eigen(jm)
    f0, f1 = 0.5 * eig.freq[0], 1.5 * eig.freq[2]
    kw = dict(n_freq=41, ray_alpha=3.0, ray_beta=2e-6, eigen_result=eig)
    rj = jfreq.run_frequency(jm, f0, f1, **kw)
    rt = freq.run_frequency(tm, f0, f1, **kw)
    np.testing.assert_array_equal(rt.freqs, rj.freqs)
    for a, b in ((rt.disp_re, rj.disp_re), (rt.disp_im, rj.disp_im)):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-10 * np.abs(b).max())
    assert np.abs(rj.disp_im).max() > 0
    for a, b in ((rt.disp_amp_max, rj.disp_amp_max),
                 (rt.vel_amp_max, rj.vel_amp_max),
                 (rt.acc_amp_max, rj.acc_amp_max)):
        np.testing.assert_allclose(a, b, rtol=1e-10)


UNPORTED = {
    # name: (solution type, deck edit, env, mesh edit, message)
    # the JAX package's Lanczos leaves !SPRING out of K (ROADMAP fault 2)
    "spring": ("EIGEN", lambda c: c.replace("!MATERIAL", "!SPRING\n 1, 3, "
                                            "10.0\n!MATERIAL"),
               {}, None, "SPRING"),
    # sharded EIGEN runs (tests/test_torch_shard_families.py): the case
    # holds two spawned ranks' answer to the single run's
    "shards": ("EIGEN", None, {"FRONTISTR_TPU_SHARDS": "2"}, None, None),
    # the id predates the shell port: the case is the truss 301
    "shell_731": ("EIGEN", None, {}, "shell", "301"),
}


@pytest.mark.parametrize("case", list(UNPORTED))
def test_unported_eigen_requests_raise(tmp_path, monkeypatch, case):
    sol, edit, envs, medit, msg = UNPORTED[case]
    for k, v in envs.items():
        monkeypatch.setenv(k, v)
    mesh = box_tet4(2, 2, 1)
    if medit == "shell":
        b = mesh.blocks[0]
        b.etype, b.conn_hecmw = 301, None
        b.conn = b.conn[:, :2]
    elif medit is not None:
        mesh = medit(mesh)
    cnt = eigen_deck(sol="DYNAMIC" if sol == "FREQ" else sol)
    if sol == "FREQ":
        cnt = cnt.replace("!EIGEN\n", "!DYNAMIC\n 11, 2\n 1.0, 2.0, 3, 1.0"
                          "\n!EIGEN\n")
    if edit is not None:
        cnt = edit(cnt)
    wd = str(tmp_path / "wd")
    write_static_workdir(wd, mesh, cnt)
    if msg is None:
        got = run_directory(wd, device="cpu")["eigen"]
        for k in envs:
            monkeypatch.delenv(k)
        want = run_directory(wd, device="cpu")["eigen"]
        np.testing.assert_allclose(got.eigenvalues, want.eigenvalues,
                                   rtol=1e-8)
        return
    with pytest.raises(NotImplementedError, match=msg):
        run_directory(wd, device="cpu")
