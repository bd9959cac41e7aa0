"""Model build, symbolic profiles and operators of the port against the
JAX package.  Profiles and maps must be bit-equal; float64 operator
outputs agree to 1e-12 of their max magnitude (sums in another order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from frontistr_tpu.analysis.static import compute_element_stiffness
from frontistr_tpu.assembly import bell as jbell
from frontistr_tpu.assembly import ell as jell
from frontistr_tpu.assembly import femop as jfemop
from frontistr_tpu.assembly.model import build_struct_model as jbuild
from frontistr_tpu.io.ctrlio import read_cnt as jread_cnt
from frontistr_tpu.meshgen import box_tet4 as jbox_tet4
from frontistr_tpu.solver import amg as jamg
from frontistr_tpu_torch.assembly import bell, ell, femop
from frontistr_tpu_torch.assembly.model import build_struct_model
from frontistr_tpu_torch.convert import model_from_numpy
from frontistr_tpu_torch.io.ctrlio import read_cnt
from frontistr_tpu_torch.meshgen import box_hex8, box_tet4
from frontistr_tpu_torch.solver import amg

CNT = ("!VERSION\n 3\n!SOLUTION, TYPE=STATIC\n!BOUNDARY\n X0, 1, 3, 0.0\n"
       " X1, 1, 1, 0.01\n!CLOAD\n X1, 3, -1.0\n!MATERIAL, NAME=M1\n"
       "!ELASTIC\n 210000.0, 0.3\n!SOLVER, METHOD=CG\n 10000, 1\n"
       " 1.0e-8, 1.0, 0.0\n!END\n")
SIZE = (5, 4, 3)


def _close(got, want, rtol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-300)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The same box through both packages: (JAX model, JAX f64 element
    matrices, port model, port element matrices)."""
    p = tmp_path_factory.mktemp("deck") / "case.cnt"
    p.write_text(CNT)
    jmodel = jbuild(jbox_tet4(*SIZE), jread_cnt(str(p)))
    jkes = [np.asarray(k) for k in compute_element_stiffness(jmodel)]
    model, kes = model_from_numpy(jmodel, "cpu", kes=jkes)
    return jmodel, jkes, model, kes


def test_model_build_matches_jax(tmp_path, models):
    jmodel = models[0]
    p = tmp_path / "case.cnt"
    p.write_text(CNT)
    model = build_struct_model(box_tet4(*SIZE), read_cnt(str(p)))
    for name in ("coords", "fixed_dofs", "fixed_vals", "f_ext"):
        assert np.array_equal(getattr(model, name), getattr(jmodel, name))
    for b, jb in zip(model.blocks, jmodel.blocks):
        assert b.etype == jb.etype
        for name in ("conn", "dofs", "D", "elem_ids"):
            assert np.array_equal(getattr(b, name), getattr(jb, name))


@pytest.mark.parametrize("extra", [
    "!DLOAD\n ALL, BX, 1.0\n", "!SPRING\n 1, 1, 1.0\n",
    "!TEMPERATURE\n ALL, 10.0\n",
])
def test_unported_cards_raise(tmp_path, extra):
    p = tmp_path / "case.cnt"
    p.write_text(CNT.replace("!END\n", extra + "!END\n"))
    with pytest.raises(NotImplementedError):
        build_struct_model(box_tet4(2, 2, 2), read_cnt(str(p)))


def test_unported_element_type_raises(tmp_path):
    p = tmp_path / "case.cnt"
    p.write_text(CNT)
    with pytest.raises(NotImplementedError, match="element type 361"):
        build_struct_model(box_hex8(2, 2, 2), read_cnt(str(p)))


def test_profiles_and_maps_bit_equal(models):
    jmodel = models[0]
    conns = [b.conn for b in jmodel.blocks]
    n = jmodel.n_node
    jp, p = jell.build_profile(conns, n, 3), ell.build_profile(conns, n, 3)
    for name in ("W", "cols", "diag_slot", "perm", "seg_sorted",
                 "pair_counts"):
        assert np.array_equal(getattr(p, name), getattr(jp, name)), name
    jc = jbell.build_cluster_profile(conns, n, 3, scalar=jp)
    c = bell.build_cluster_profile(conns, n, 3, scalar=p)
    for name in ("G", "C", "Wc", "ccols", "diag_wc", "perm", "seg_sorted",
                 "scal_src", "pair_counts"):
        assert np.array_equal(getattr(c, name), getattr(jc, name)), name
    jm, m = jamg.build_maps(jp.cols, n, 3), amg.build_maps(p.cols, n, 3)
    for name in ("Na", "Na2", "Wc", "cols1", "diag_slot1", "perm01",
                 "seg01", "perm12", "seg12"):
        assert np.array_equal(getattr(m, name), getattr(jm, name)), name
    jinc, jtot = jfemop.build_incidence(conns, n)
    inc, tot = femop.build_incidence(conns, n)
    assert tot == jtot and np.array_equal(inc, jinc)


@pytest.fixture(scope="module")
def cluster_ops(models):
    jmodel, jkes, model, kes = models
    jprof = jell.build_profile([b.conn for b in jmodel.blocks],
                               jmodel.n_node, 3)
    jop, jsb = jbell.from_model(jmodel, [jnp.asarray(k) for k in jkes],
                                want_scalar=True, scalar=jprof)
    prof = ell.build_profile([b.conn for b in model.blocks],
                             model.n_node, 3)
    op, sb = bell.from_model(model, kes, want_scalar=True, scalar=prof)
    return jop, jsb, op, sb


def _vec(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


def test_cluster_operator_matches_jax(cluster_ops):
    jop, jsb, op, sb = cluster_ops
    _close(op.blocks.numpy(), jop.blocks)
    x = _vec(op.n_dof, 0)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    _close(op.matvec(xt).numpy(), jop.matvec(xj))
    _close(op.apply_constrained(xt).numpy(), jop.apply_constrained(xj))
    f = _vec(op.n_dof, 1)
    _close(op.constrained_rhs(torch.as_tensor(f), xt).numpy(),
           jop.constrained_rhs(jnp.asarray(f), xj))


def test_extract_diag_and_scalar_blocks_match_jax(cluster_ops):
    jop, jsb, op, sb = cluster_ops
    _close(op.diag.numpy(), jop.diag)
    _close(sb.numpy(), np.stack([np.asarray(p) for p in jsb]))


def test_block_jacobi_matches_jax(cluster_ops):
    jop, _, op, _ = cluster_ops
    r = _vec(op.n_dof, 2)
    _close(op.block_jacobi()(torch.as_tensor(r)).numpy(),
           jop.block_jacobi()(jnp.asarray(r)))


def test_feoperator_matches_jax(models):
    jmodel, jkes, model, kes = models
    jop = jfemop.from_model(jmodel, [jnp.asarray(k) for k in jkes])
    op = femop.from_model(model, kes)
    x = _vec(op.n_dof, 3)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    _close(op.matvec(xt).numpy(), jop.matvec(xj))
    _close(op.apply_constrained(xt).numpy(), jop.apply_constrained(xj))
    f = _vec(op.n_dof, 4)
    _close(op.constrained_rhs(torch.as_tensor(f), xt).numpy(),
           jop.constrained_rhs(jnp.asarray(f), xj))
