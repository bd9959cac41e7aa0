"""Krylov solvers and the AMG preconditioner of the port against the JAX
package, on the constrained cluster operator of a small tet box.

- pcg in float64: equal iteration count, solutions within 1e-10.
- setup_amg in float64, fed the JAX package's power-iteration start
  vectors: M(r) within 1e-10 of max|M(r)| (Cholesky/inverse of the small
  mode Gram matrices come from different LAPACK paths).
- refined_cg (float32 inner CG + float64 refinement): inner float32 sums
  run in another order, so the total iteration count may differ by 2;
  both meet the true relative residual 1e-8, and the solutions agree to
  1e-6 of their max.
"""

import numpy as np
import jax
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
from frontistr_tpu.solver import cg as jcg
from frontistr_tpu.solver import mixed as jmixed
from frontistr_tpu_torch.assembly import bell, ell, femop
from frontistr_tpu_torch.assembly import operators as ops
from frontistr_tpu_torch.convert import model_from_numpy
from frontistr_tpu_torch.solver import amg, cg, mixed

CNT = ("!VERSION\n 3\n!SOLUTION, TYPE=STATIC\n!BOUNDARY\n X0, 1, 3, 0.0\n"
       "!CLOAD\n X1, 3, -1.0\n!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n"
       "!SOLVER, METHOD=CG\n 10000, 1\n 1.0e-8, 1.0, 0.0\n!END\n")


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    p = tmp_path_factory.mktemp("deck") / "case.cnt"
    p.write_text(CNT)
    jmodel = jbuild(jbox_tet4(6, 4, 4), jread_cnt(str(p)))
    jkes = [np.asarray(k) for k in compute_element_stiffness(jmodel)]
    model, kes = model_from_numpy(jmodel, "cpu", kes=jkes)
    jprof = jell.build_profile([b.conn for b in jmodel.blocks],
                               jmodel.n_node, 3)
    prof = ell.build_profile([b.conn for b in model.blocks],
                             model.n_node, 3)
    n = model.n_dof_total
    u_fix = ops.full_fixed_vector(n, model.fixed_dofs, model.fixed_vals)
    jfe = jfemop.from_model(jmodel, [jnp.asarray(k) for k in jkes])
    fe = femop.from_model(model, kes)
    b = np.asarray(jfe.constrained_rhs(jnp.asarray(model.f_ext),
                                       jnp.asarray(u_fix)))
    return dict(jmodel=jmodel, jkes=jkes, model=model, kes=kes,
                jprof=jprof, prof=prof, jfe=jfe, fe=fe, b=b)


def _ops(s, jdt, tdt):
    jop, jsb = jbell.from_model(s["jmodel"], [jnp.asarray(k)
                                              for k in s["jkes"]],
                                dtype=jdt, want_scalar=True,
                                scalar=s["jprof"])
    op, sb = bell.from_model(s["model"], s["kes"], dtype=tdt,
                             want_scalar=True, scalar=s["prof"])
    return jop, jsb, op, sb


def test_pcg_f64_matches_jax(system):
    jop, _, op, _ = _ops(system, jnp.float64, torch.float64)
    b = system["b"]
    jres = jcg.pcg(jop.apply_constrained, jnp.asarray(b),
                   M=jop.block_jacobi(), tol=1e-8, hist_len=50)
    res = cg.pcg(op.apply_constrained, torch.as_tensor(b),
                 M=op.block_jacobi(), tol=1e-8, hist_len=50)
    assert res.iters == int(jres.iters) > 10
    assert res.converged and res.relres <= 1e-8
    x, jx = res.x.numpy(), np.asarray(jres.x)
    assert np.abs(x - jx).max() <= 1e-10 * np.abs(jx).max()
    # the last slot holds the final recursive residual (~tol): absolute
    np.testing.assert_allclose(res.hist, np.asarray(jres.hist), rtol=1e-6,
                               atol=1e-9)


def _jax_start(maps, dtype):
    k0, k1 = jax.random.split(jax.random.PRNGKey(11))
    return (np.asarray(jax.random.normal(k0, (maps.n_node * maps.nd,),
                                         dtype)),
            np.asarray(jax.random.normal(k1, (maps.Na * maps.nv,), dtype)))


def test_amg_vcycle_matches_jax(system):
    jop, jsb, op, sb = _ops(system, jnp.float64, torch.float64)
    jprof, prof, model = system["jprof"], system["prof"], system["model"]
    jmaps = jamg.build_maps(jprof.cols, jprof.n_node, 3)
    maps = amg.build_maps(prof.cols, prof.n_node, 3)
    jM = jamg.setup_amg(jmaps.device(), jsb, jnp.asarray(jprof.cols),
                        jnp.asarray(model.coords), jop.free_mask,
                        jop.apply_constrained, jop.block_jacobi())
    v0, v1 = _jax_start(maps, jnp.float64)
    M = amg.setup_amg(maps, sb, torch.as_tensor(prof.cols.astype(np.int64)),
                      torch.as_tensor(model.coords), op.free_mask,
                      op.apply_constrained, op.block_jacobi(),
                      start=(torch.as_tensor(v0), torch.as_tensor(v1)))
    r = np.random.default_rng(0).standard_normal(op.n_dof)
    want = np.asarray(jM(jnp.asarray(r)))
    got = M(torch.as_tensor(r)).numpy()
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def test_amg_default_generator_is_seeded(system):
    _, _, op, sb = _ops(system, jnp.float64, torch.float64)
    prof, model = system["prof"], system["model"]
    maps = amg.build_maps(prof.cols, prof.n_node, 3)
    args = (maps, sb, torch.as_tensor(prof.cols.astype(np.int64)),
            torch.as_tensor(model.coords), op.free_mask,
            op.apply_constrained, op.block_jacobi())
    r = torch.as_tensor(np.random.default_rng(1).standard_normal(op.n_dof))
    assert torch.equal(amg.setup_amg(*args)(r), amg.setup_amg(*args)(r))


# The ITERLOG variant runs a fixed number of passes; two here, because in
# both packages a pass started from an already converged residual
# underflows the float32 inner CG to NaN (see ROADMAP, queue 3).
@pytest.mark.parametrize("hist_len,max_passes", [(0, 4), (100, 2)])
def test_refined_cg_matches_jax(system, hist_len, max_passes):
    jop, _, op, _ = _ops(system, jnp.float32, torch.float32)
    b = system["b"]
    jres = jmixed.refined_cg(system["jfe"].apply_constrained,
                             jop.apply_constrained, jop.block_jacobi(),
                             jnp.asarray(b), tol=1e-8, inner_tol=1e-6,
                             max_passes=max_passes, hist_len=hist_len)
    res = mixed.refined_cg(system["fe"].apply_constrained,
                           op.apply_constrained, op.block_jacobi(),
                           torch.as_tensor(b), tol=1e-8, inner_tol=1e-6,
                           max_passes=max_passes, hist_len=hist_len)
    assert abs(res.iters - int(jres.iters)) <= 2
    assert res.passes == int(jres.passes)
    assert res.relres <= 1e-8 and float(jres.relres) <= 1e-8
    x, jx = res.x.numpy(), np.asarray(jres.x)
    assert np.abs(x - jx).max() <= 1e-6 * np.abs(jx).max()
    if hist_len:
        assert res.hist.shape == np.asarray(jres.hist).shape
