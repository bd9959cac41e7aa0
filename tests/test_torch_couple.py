"""Coupling in the port (``couple/mapping.py``, ``couple/rcap.py`` and
its hooks in ``analysis/dynamic.py``) against the JAX package on the CPU.

- ``build_map`` on the same meshes: the same source nodes, weights
  within 1e-12; a linear field transferred exactly (1e-12).
- The staggered heat -> stress run of ``tests/test_couple.py``: the
  mapped temperature exact (1e-10), u within 1e-8 of max|u|.
- The file protocol of ``tests/test_couple_external.py`` with a thread
  peer, through ``FRONTISTR_TPU_COUPLE_DIR`` (the port refused it
  before), in implicit (Newmark) and explicit dynamics: every state the
  peer reads (disp, velo, acc) within 1e-10 of max|.| of the JAX
  package's, and the final u too.
- A peer that never answers raises ``TimeoutError``.
"""

import os
import threading

import numpy as np
import pytest

from frontistr_tpu.analysis.dynamic import run_dynamic as jrun_dynamic
from frontistr_tpu.analysis.static import run_linear_static as jrun_static
from frontistr_tpu.assembly.loads import thermal_load as jthermal_load
from frontistr_tpu.assembly.model import build_struct_model as jbuild
from frontistr_tpu.couple import mapping as jmapping
from frontistr_tpu.io.ctrlio import read_cnt as jread_cnt
from frontistr_tpu.meshgen import box_hex8 as jbox_hex8
from frontistr_tpu.meshgen import box_tet4 as jbox_tet4
from frontistr_tpu_torch.analysis.dynamic import run_dynamic
from frontistr_tpu_torch.analysis.static import run_linear_static
from frontistr_tpu_torch.assembly.loads import FACE_TABLES, thermal_load
from frontistr_tpu_torch.assembly.model import build_struct_model
from frontistr_tpu_torch.couple import mapping
from frontistr_tpu_torch.couple.rcap import (CoupleDriver, FileCoupler,
                                             couple_traction_force)
from frontistr_tpu_torch.io.ctrlio import read_cnt
from frontistr_tpu_torch.meshgen import box_hex8, box_tet4

DYN_CNT = """!VERSION
 3
!SOLUTION, TYPE=DYNAMIC
!DYNAMIC
 {eqa}, 1
 0.0, {T}, {N}, {DT}
 0.5, 0.25
 1, 1, 0.0, 0.0
 10
!BOUNDARY, GRPID=1
 X0, 1, 3, 0.0
!COUPLE, TYPE=1
 WET
!STEP, SUBSTEPS=1, CONVERG=1.0e-8
 BOUNDARY, 1
!MATERIAL, NAME=M1
!ELASTIC
 1000.0, 0.0
!DENSITY
 1.0
!SOLVER,METHOD=CG,PRECOND=1
 10000, 1
 1.0e-12, 1.0, 0.0
!END
"""

THERMAL_CNT = """!VERSION
 3
!SOLUTION, TYPE=STATIC
!BOUNDARY
 X0, 1, 1, 0.0
 Y0, 2, 2, 0.0
 Z0, 3, 3, 0.0
!MATERIAL, NAME=M1
!ELASTIC
 210000., 0.3
!EXPANSION_COEFF
 1.0e-5
!SOLVER,METHOD=CG,PRECOND=1
 10000, 1
 1.0e-10, 1.0, 0.0
!END
"""


def _cfgs(tmp_path, text):
    p = tmp_path / "case.cnt"
    p.write_text(text)
    return jread_cnt(str(p)), read_cnt(str(p))


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("src_kind", ["hex8", "tet4"])
def test_build_map_matches_jax(src_kind):
    """Weights on a hex and a tet source, destination points from a seed
    (some outside the box: clamped and renormalised)."""
    gen = {"hex8": (jbox_hex8, box_hex8), "tet4": (jbox_tet4, box_tet4)}
    jsrc, src = (g(2, 2, 1) for g in gen[src_kind])
    pts = np.random.default_rng(4).uniform(-0.1, 1.1, (12, 3))
    jm = jmapping.build_map(jsrc, pts)
    m = mapping.build_map(src, pts)
    np.testing.assert_array_equal(m.src_nodes, jm.src_nodes)
    np.testing.assert_array_equal(m.outside, jm.outside)
    assert m.outside.any() and not m.outside.all()
    _close(m.weights, jm.weights, 1e-12)
    f = np.random.default_rng(5).standard_normal((src.n_node, 2))
    _close(m.transfer(f), jm.transfer(f), 1e-12)


def test_linear_field_transferred_exactly():
    src = box_hex8(3, 3, 3)
    dst = box_tet4(4, 4, 4)
    f = 2.0 * src.coords[:, 0] - 0.7 * src.coords[:, 1] \
        + 0.3 * src.coords[:, 2]
    m = mapping.build_map(src, dst.coords)
    want = 2.0 * dst.coords[:, 0] - 0.7 * dst.coords[:, 1] \
        + 0.3 * dst.coords[:, 2]
    np.testing.assert_allclose(m.transfer(f), want, atol=1e-12)
    assert not m.outside.any()


def test_staggered_heat_to_stress_matches_jax(tmp_path):
    """The port's staggered transfer of T = 100 x (exact: the field is
    linear; ``build_map`` is held to the JAX package's above), then the
    thermal stress run of that T in each package."""
    jcfg, cfg = _cfgs(tmp_path, THERMAL_CNT)
    src, dst = box_hex8(2, 2, 2), box_hex8(3, 3, 3)
    T = mapping.StaggeredCoupling(src, dst).transfer(100.0 * src.coords[:, 0])
    np.testing.assert_allclose(T, 100.0 * dst.coords[:, 0], atol=1e-10)
    out = []
    for build, box, c, tl, run in (
            (jbuild, jbox_hex8, jcfg, jthermal_load, jrun_static),
            (lambda m, c: build_struct_model(m, c, device="cpu"), box_hex8,
             cfg, thermal_load, run_linear_static)):
        model = build(box(3, 3, 3), c)
        model.temperature = T
        model.f_ext = model.f_ext + tl(model, T)
        out.append(np.asarray(run(model).u))
    ju, u = out
    assert np.abs(u).max() > 1e-5
    _close(u, ju, 1e-8)


def _wet_mesh(box):
    """A unit cube of one hex; its +x face is the coupled surface WET."""
    m = box(1, 1, 1)
    conn = m.blocks[0].conn[0]
    face_no = next(fi for fi, (_, ln) in enumerate(FACE_TABLES[361], 1)
                   if np.allclose(m.coords[conn[np.asarray(ln)]][:, 0], 1.0))
    m.surf_groups = {"WET": np.asarray([[1, face_no]])}
    return m


def _fluid_peer(d, n_step, px, got, timeout=60):
    """The mock fluid code: a constant +x traction each step; records the
    solid's published states."""
    ep = FileCoupler(d, role="fluid", peer="solid", timeout=timeout)
    ids = ep.peer_interface()["node_ids"]
    tr = np.zeros((len(ids), 3))
    tr[:, 0] = px
    for i in range(1, n_step + 1):
        ep.send(i, node_ids=ids, trac=tr)
        got.append(ep.get(i))


def _coupled_run(pkg, eqa, tmp_path, monkeypatch, n_step=4, dt=0.01):
    d = tmp_path / f"{pkg}{eqa}"
    d.mkdir()
    jcfg, cfg = _cfgs(tmp_path, DYN_CNT.format(eqa=eqa, T=n_step * dt,
                                               N=n_step, DT=dt))
    monkeypatch.setenv("FRONTISTR_TPU_COUPLE_DIR", str(d))
    monkeypatch.setenv("FRONTISTR_TPU_COUPLE_TIMEOUT", "60")
    if pkg == "jax":
        model = jbuild(_wet_mesh(jbox_hex8), jcfg)
        run = jrun_dynamic
    else:
        model = build_struct_model(_wet_mesh(box_hex8), cfg, device="cpu")
        run = run_dynamic
    got = []
    th = threading.Thread(target=_fluid_peer, args=(str(d), n_step, 3.0,
                                                    got))
    th.start()
    out = run(model)
    th.join(timeout=60)
    assert not th.is_alive() and len(got) == n_step
    return got, np.asarray(out.u)


@pytest.mark.parametrize("eqa", [1, 11], ids=["implicit", "explicit"])
def test_file_protocol_round_trip_matches_jax(eqa, tmp_path, monkeypatch):
    jgot, ju = _coupled_run("jax", eqa, tmp_path, monkeypatch)
    got, u = _coupled_run("torch", eqa, tmp_path, monkeypatch)
    for j, g in zip(jgot, got):
        assert sorted(g) == sorted(j) == ["acc", "disp", "node_ids", "velo"]
        np.testing.assert_array_equal(g["node_ids"], j["node_ids"])
        for k in ("disp", "velo", "acc"):
            _close(g[k], j[k], 1e-10)
    _close(u, ju, 1e-10)
    assert u[:, 0].max() > 0           # the traction pushed +x


def test_traction_force_balance(tmp_path):
    _, cfg = _cfgs(tmp_path, DYN_CNT.format(eqa=1, T=0.04, N=4, DT=0.01))
    mesh = _wet_mesh(box_hex8)
    model = build_struct_model(mesh, cfg, device="cpu")
    drv = CoupleDriver(model, mesh, cfg.couple,
                       FileCoupler(str(tmp_path / "c"), timeout=1))
    fvec = couple_traction_force(model, mesh, cfg.couple,
                                 {int(k): np.array([3.0, 0.0, 0.0])
                                  for k in drv.nodes})
    assert np.isclose(fvec.reshape(-1, 3)[:, 0].sum(), 3.0)
    assert sorted(np.nonzero(fvec.reshape(-1, 3)[:, 0])[0]) == \
        sorted(drv.nodes)


def test_silent_peer_times_out(tmp_path):
    _, cfg = _cfgs(tmp_path, DYN_CNT.format(eqa=1, T=0.04, N=4, DT=0.01))
    mesh = _wet_mesh(box_hex8)
    model = build_struct_model(mesh, cfg, device="cpu")
    ep = FileCoupler(str(tmp_path / "c"), timeout=0.2)
    with pytest.raises(TimeoutError):
        run_dynamic(model, coupler=CoupleDriver(model, mesh, cfg.couple, ep))
    assert os.path.exists(tmp_path / "c" / "solid.init.npz")
