"""Multicolor block SSOR (``solver/ssor.py``) held to the JAX package's
``frontistr_tpu/solver/ssor.py`` on the CPU: the color maps bit for
bit; M(r) within 1e-12 of max|M(r)| from the scalar ELL blocks in both
forms (nd*nd planes and (N, W, nd, nd)); the Newton driver with
PRECOND=10 and 21 and FRONTISTR_TPU_PRECOND=ssor on a shuffled tet4 box:
Newton counts equal, CG within 1 a solve, u within 1e-8."""

import os
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import frontistr_tpu.run as jrun
from frontistr_tpu.analysis import nonlinear as jnl
from frontistr_tpu.analysis import static as jstatic
from frontistr_tpu.assembly import ell as jell
from frontistr_tpu.assembly.model import build_struct_model as jbuild
from frontistr_tpu.io.ctrlio import read_cnt as jread_cnt
from frontistr_tpu.solver import ssor as jssor
from frontistr_tpu_torch import ordering
from frontistr_tpu_torch.assembly import ell
from frontistr_tpu_torch.assembly.model import build_struct_model
from frontistr_tpu_torch.io.ctrlio import read_cnt
from frontistr_tpu_torch.io.neu import write_static_workdir
from frontistr_tpu_torch.meshgen import box_hex8, box_tet4
from frontistr_tpu_torch.run import run_directory
from frontistr_tpu_torch.solver import ssor

CNT = ("!VERSION\n 3\n!SOLUTION, TYPE={sol}\n!BOUNDARY\n X0, 1, 3, 0.0\n"
       "!CLOAD\n X1, 3, -100.0\n!MATERIAL, NAME=M1\n!ELASTIC\n"
       " 210000.0, 0.3\n!STEP, SUBSTEPS=1\n BOUNDARY, 1\n LOAD, 1\n"
       "!SOLVER, METHOD=CG, PRECOND={precond}, ITERLOG=NO, TIMELOG=NO\n"
       " 10000, 1\n 1.0e-8, 1.0, 0.0\n!END\n")


def _models(tmp_path, mesh):
    p = str(tmp_path / "case.cnt")
    with open(p, "w") as fh:
        fh.write(CNT.format(sol="STATIC", precond=1))
    return (jbuild(mesh, jread_cnt(p)),
            build_struct_model(mesh, read_cnt(p), device="cpu"))


@pytest.mark.parametrize("etype", [341, 361])
def test_color_maps_bit_equal(tmp_path, etype):
    mesh = (box_tet4 if etype == 341 else box_hex8)(4, 3, 3)
    _, pm = _models(tmp_path, mesh)
    prof = ell.profile_from_model(pm)
    want = jssor.build_color_maps(np.asarray(prof.cols), prof.n_node)
    got = ssor.build_color_maps(np.asarray(prof.cols), prof.n_node)
    assert got.ncol == want.ncol > 1 and got.n_node == want.n_node
    assert np.array_equal(got.rows, want.rows)
    assert ssor.eligible_maps(prof, "ssor") is ssor.eligible_maps(prof,
                                                                  "ssor")
    assert ssor.eligible_maps(prof, "amg") is None
    # a color holds no two neighbours
    cols = np.asarray(prof.cols)
    for rc in got.colors("cpu"):
        rc = rc.numpy()
        nb = cols[rc]
        inside = np.isin(nb, rc) & (nb != rc[:, None])
        assert not inside.any()


@pytest.mark.parametrize("form", ["planes", "blocks"])
def test_setup_ssor_matches_jax(tmp_path, form):
    jm, pm = _models(tmp_path, box_tet4(4, 3, 3))
    jop = jell.from_model(jm, jstatic.compute_element_stiffness(jm))
    blocks = np.array(jop.blocks)                        # (N, W, 3, 3)
    cols, free = np.array(jop.cols), np.array(jop.free_mask)
    N, W = cols.shape
    diag = np.array(jop.diag_blocks())
    maps = jssor.build_color_maps(cols, N)
    M_j = jssor.setup_ssor(maps.device(), jnp.asarray(blocks),
                           jnp.asarray(cols), jnp.asarray(diag),
                           jnp.asarray(free), 3)
    b = torch.as_tensor(blocks)
    if form == "planes":
        b = b.permute(2, 3, 0, 1).reshape(9, N, W)
    M_t = ssor.setup_ssor(ssor.build_color_maps(cols, N), b,
                          torch.as_tensor(cols, dtype=torch.int64),
                          torch.as_tensor(diag), torch.as_tensor(free), 3)
    for seed in (0, 1):
        r = np.random.default_rng(seed).standard_normal(N * 3)
        want = np.asarray(M_j(jnp.asarray(r)))
        got = M_t(torch.as_tensor(r)).numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def _spy(monkeypatch, mod, out, attr):
    real = mod.make_constrained_solver

    def spy(*a, **kw):
        solve = real(*a, **kw)

        def wrapped(*b, **k):
            x = solve(*b, **k)
            out.append(int(getattr(solve, attr)))
            return x
        for k, v in vars(solve).items():
            setattr(wrapped, k, v)
        return wrapped
    monkeypatch.setattr(mod, "make_constrained_solver", spy)


@pytest.mark.parametrize("precond", ["10", "21", "env"])
def test_nlstatic_ssor_matches_jax(tmp_path, monkeypatch, precond):
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", "f64")
    monkeypatch.setenv("FRONTISTR_TPU_REORDER", "1")
    if precond == "env":
        monkeypatch.setenv("FRONTISTR_TPU_PRECOND", "ssor")
    cnt = CNT.format(sol="NLSTATIC", precond=1 if precond == "env"
                     else precond)
    mesh = box_tet4(4, 3, 3)
    order = np.random.default_rng(3).permutation(mesh.n_node)
    wd, wj = str(tmp_path / "port"), str(tmp_path / "jax")
    write_static_workdir(wd, ordering.permute_mesh(mesh, order), cnt)
    shutil.copytree(wd, wj)
    cg_j = []
    _spy(monkeypatch, jnl, cg_j, "last_iters")
    jres = jrun.run_directory(wj)["static"]
    res = run_directory(wd, device="cpu")["static"]
    cg_p = [h["cg_iters"] for h in res.newton.history]
    assert res.iters == int(jres.iters) >= 2
    assert len(cg_p) == len(cg_j)
    assert all(abs(a - b) <= 1 for a, b in zip(cg_p, cg_j))
    uj = np.asarray(jres.u)
    assert np.abs(res.u - uj).max() <= 1e-8 * np.abs(uj).max()
    with open(os.path.join(wd, "FSTR.sta")) as a, \
            open(os.path.join(wj, "FSTR.sta")) as b:
        assert a.read() == b.read()

