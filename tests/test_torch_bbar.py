"""The hex8 B-bar / F-bar element functions of the port
(``fem/solid.py``, ``analysis/nonlinear.py``) against the JAX package's,
on the CPU: ``centroid_gderiv``, ``volavg_gderiv`` (with and without
jacobian weights), ``_bbar_correction`` (both of its JAX twins),
``stiffness_hex8fbar``, ``stiffness_nlgeom_fbar`` (TOTALLAG and
UPDATELAG), the B-bar arm of ``stiffness_nlgeom`` (the three strain
measures, an elastic and a per-gauss-point D) and ``_qf_bbar_extra``;
then ``BlockPrograms.tangent`` / ``update`` of B-bar and F-bar blocks,
elastic and plastic, at random displacements and states.

Inputs: the elements of ``box_hex8(3, 2, 2)`` with every node moved by
up to 8% of the spacing, random displacements, stresses and plastic
states from a numpy seed.  Bar: float64, within 1e-12 of the largest
magnitude.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from frontistr_tpu.analysis import nonlinear as jnl
from frontistr_tpu.assembly.model import build_struct_model as jbuild
from frontistr_tpu.elements import tables as jtables
from frontistr_tpu.fem import solid as jsolid
from frontistr_tpu.fem.material import D3, elastic_D
from frontistr_tpu.io.ctrlio import read_cnt as jread_cnt
from frontistr_tpu_torch import convert
from frontistr_tpu_torch.analysis import nonlinear as nl
from frontistr_tpu_torch.elements import tables
from frontistr_tpu_torch.fem import material as mat
from frontistr_tpu_torch.fem import solid
from frontistr_tpu_torch.meshgen import box_hex8

T = tables.get_table(361)
JT = jtables.get_table(361)


def _hexes(seed):
    mesh = box_hex8(3, 2, 2)
    rng = np.random.default_rng(seed)
    coords = mesh.coords + 0.08 * 0.33 * rng.uniform(-1, 1,
                                                     mesh.coords.shape)
    x = coords[mesh.blocks[0].conn]
    return x, 0.01 * rng.standard_normal(x.shape), rng


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.isfinite(a).all()
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _D(E, rng=None, per_gauss=False):
    D = elastic_D(210e3, 0.3, D3)
    if not per_gauss:
        return np.broadcast_to(D, (E, 6, 6)).copy()
    # a symmetric per-gauss perturbation, as the plastic tangent gives
    P = rng.standard_normal((E, 8, 6, 6)) * 1e3
    return D + P + P.transpose(0, 1, 3, 2)


def test_centroid_and_volavg_gderiv_match_jax():
    x, u, rng = _hexes(0)
    assert _rel(solid.centroid_gderiv(T, torch.as_tensor(x)),
                jsolid.centroid_gderiv(JT, jnp.asarray(x))) <= 1e-12
    jac = 1.0 + 0.1 * rng.random((len(x), 8))
    for j in (None, jac):
        got = solid.volavg_gderiv(T, torch.as_tensor(x),
                                  None if j is None else torch.as_tensor(j))
        want = jsolid.volavg_gderiv(JT, jnp.asarray(x),
                                    None if j is None else jnp.asarray(j))
        for g, w in zip(got, want):
            assert _rel(g, w) <= 1e-12


def test_bbar_correction_matches_jax():
    x, _, rng = _hexes(1)
    g = rng.standard_normal((len(x), 8, 3))
    g0 = rng.standard_normal((len(x), 8, 3))
    got = solid._bbar_correction(torch.as_tensor(g), torch.as_tensor(g0))
    assert _rel(got, jsolid._bbar_correction(None, jnp.asarray(g),
                                             jnp.asarray(g0))) <= 1e-12
    assert _rel(got, jsolid._fbar_correction(jnp.asarray(g),
                                             jnp.asarray(g0))) <= 1e-12


@pytest.mark.parametrize("per_gauss", [False, True])
def test_stiffness_hex8fbar_matches_jax(per_gauss):
    x, _, rng = _hexes(2)
    D = _D(len(x), rng, per_gauss)
    got = solid.stiffness_hex8fbar(T, torch.as_tensor(x), torch.as_tensor(D))
    want = jsolid.stiffness_hex8fbar(JT, jnp.asarray(x), jnp.asarray(D))
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("flag", [mat.TOTALLAG, mat.UPDATELAG])
@pytest.mark.parametrize("per_gauss", [False, True])
def test_stiffness_nlgeom_fbar_matches_jax(flag, per_gauss):
    x, u, rng = _hexes(3 + flag)
    D = _D(len(x), rng, per_gauss)
    sig = 100.0 * rng.standard_normal((len(x), 8, 6))
    got = solid.stiffness_nlgeom_fbar(T, torch.as_tensor(x),
                                      torch.as_tensor(u), torch.as_tensor(D),
                                      torch.as_tensor(sig), flag)
    want = jsolid.stiffness_nlgeom_fbar(JT, jnp.asarray(x), jnp.asarray(u),
                                        jnp.asarray(D), jnp.asarray(sig),
                                        flag)
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("flag", [mat.INFINITESIMAL, mat.TOTALLAG,
                                  mat.UPDATELAG])
@pytest.mark.parametrize("per_gauss", [False, True])
def test_stiffness_nlgeom_bbar_matches_jax(flag, per_gauss):
    x, u, rng = _hexes(7 + flag)
    D = _D(len(x), rng, per_gauss)
    sig = 100.0 * rng.standard_normal((len(x), 8, 6))
    got = solid.stiffness_nlgeom(T, torch.as_tensor(x), torch.as_tensor(u),
                                 torch.as_tensor(D), torch.as_tensor(sig),
                                 flag, bbar=True)
    want = jsolid.stiffness_nlgeom(JT, jnp.asarray(x), jnp.asarray(u),
                                   jnp.asarray(D), jnp.asarray(sig), flag,
                                   bbar=True)
    assert _rel(got, want) <= 1e-12


def test_qf_bbar_extra_matches_jax():
    x, _, rng = _hexes(11)
    det = 0.01 + rng.random((len(x), 8))
    g = rng.standard_normal((len(x), 8, 8, 3))
    g0 = rng.standard_normal((len(x), 8, 3))
    sig = 100.0 * rng.standard_normal((len(x), 8, 6))
    got = nl._qf_bbar_extra(T, torch.as_tensor(g), torch.as_tensor(g0),
                            torch.as_tensor(det), torch.as_tensor(sig))
    want = jnl._qf_bbar_extra(JT, jnp.asarray(g), jnp.asarray(g0),
                              jnp.asarray(det), jnp.asarray(sig), 1.0)
    assert _rel(got, want) <= 1e-12


CNT = ("!VERSION\n 3\n!SOLUTION, TYPE=NLSTATIC\n!BOUNDARY\n X0, 1, 3, 0.0\n"
       "!CLOAD\n X1, 3, -1.0\n!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n"
       "{plastic}{elemopt}!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n"
       " 10000, 1\n 1.0e-8, 1.0, 0.0\n!END\n")


@pytest.mark.parametrize("plastic", ["", "!PLASTIC, YIELD=MISES, "
                                     "HARDEN=COMBINED\n 250.0, 800.0, 1200.0\n"])
@pytest.mark.parametrize("flag", [mat.INFINITESIMAL, mat.TOTALLAG,
                                  mat.UPDATELAG])
@pytest.mark.parametrize("form", ["BBAR", "FBAR"])
def test_block_programs_bbar_fbar_match_jax(tmp_path, form, flag, plastic):
    """Tangent and update of a hex8 block in its formulation, elastic and
    plastic (the per-gauss-point plastic tangent, the return mapping from
    a committed plastic state)."""
    p = tmp_path / "case.cnt"
    p.write_text(CNT.format(plastic=plastic, elemopt="!ELEMOPT, 361=%d\n"
                            % {"BBAR": 2, "FBAR": 4}[form]))
    x, _, rng = _hexes(20 + flag)
    mesh = box_hex8(3, 2, 2)
    mesh.coords = mesh.coords + 0.08 * 0.33 * rng.uniform(
        -1, 1, mesh.coords.shape)
    jm = jbuild(mesh, jread_cnt(str(p)))
    jb = jm.blocks[0]
    jb.material.nlgeom = flag
    assert jb.formulation == form
    pm = convert.model_from_numpy(jm, device="cpu")
    jp = jnl.BlockPrograms(jm, jb)
    pp = nl.BlockPrograms(pm, pm.blocks[0])
    assert (pp.bbar, pp.fbar) == (jp.bbar, jp.fbar)
    E, nn = jb.conn.shape
    u_e = 0.01 * rng.standard_normal((E, nn, 3))
    ddu_e = 0.005 * rng.standard_normal((E, nn, 3))
    st = {k: np.array(v) for k, v in
          jnl.init_block_state(jb, jp.table).items()}
    st["stress"] = 150.0 * rng.standard_normal(st["stress"].shape)
    st["stress_bak"] = 150.0 * rng.standard_normal(st["stress"].shape)
    st["strain_bak"] = 1e-3 * rng.standard_normal(st["stress"].shape)
    st["pstrain"] = 1e-3 * rng.random(st["pstrain"].shape)
    st["pstrain_new"] = st["pstrain"] + 1e-4
    st["yielded"] = rng.random(st["yielded"].shape) < 0.5
    st["back"] = 20.0 * rng.standard_normal(st["back"].shape)
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    pst = convert.states_from_numpy([st], device="cpu")[0]
    kj = jp.tangent(jnp.asarray(u_e), jnp.asarray(ddu_e), jst)
    kp = pp.tangent(torch.as_tensor(u_e), torch.as_tensor(ddu_e), pst)
    assert _rel(kp, kj) <= 1e-12
    nsj, qfj = jp.update(jnp.asarray(u_e), jnp.asarray(ddu_e), jst)
    nsp, qfp = pp.update(torch.as_tensor(u_e), torch.as_tensor(ddu_e), pst)
    assert _rel(qfp, qfj) <= 1e-12
    for k in ("strain", "stress", "pstrain_new", "back"):
        assert _rel(nsp[k], nsj[k]) <= 1e-12
    assert np.array_equal(nsp["yielded"].numpy(), np.asarray(nsj["yielded"]))
    if plastic:
        assert np.asarray(nsj["yielded"]).any()
