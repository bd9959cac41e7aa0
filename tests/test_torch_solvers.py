"""Krylov solvers and the AMG preconditioner of the port against the JAX
package, on the constrained cluster operator of a small tet box.

- pcg in float64: equal iteration count, solutions within 1e-10.
- setup_amg in float64, fed the JAX package's power-iteration start
  vectors: M(r) within 1e-10 of max|M(r)| (Cholesky/inverse of the small
  mode Gram matrices come from different LAPACK paths).
- the Galerkin sums, now K1's planes entry (``coarse_levels``): on the
  CPU bit-equal to the per-plane ``index_add_`` sums they replaced, and
  from call to call.
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


def _index_add_levels(maps, sb, cols, Bo):
    """The level-1 blocks (nv*nv, Na*Wc) and dense level 2 (nv*nv,
    Na2*Na2) summed plane by plane with index_add_ over the sorted maps,
    as the setup did before K1's planes entry."""
    nd, nv, Na, Wc, Na2, S1 = (maps.nd, maps.nv, maps.Na, maps.Wc,
                               maps.Na2, maps.S1)
    Bpl = Bo.reshape(Na * maps.S0, nd, nv)[:maps.n_node].permute(1, 2, 0)
    seg01, perm01, seg12, perm12 = (
        torch.as_tensor(getattr(maps, k).astype(np.int64))
        for k in ("seg01", "perm01", "seg12", "perm12"))
    S_jp = [[sum(Bpl[i, p][:, None] * sb[i * nd + j] for i in range(nd))
             for p in range(nv)] for j in range(nd)]
    Bcols = Bpl[:, :, cols]
    blocks1f = torch.zeros((Na * Wc, nv * nv), dtype=sb.dtype)
    for p in range(nv):
        for q in range(nv):
            Cpq = sum(S_jp[j][p] * Bcols[j, q] for j in range(nd))
            blocks1f[:, p * nv + q].index_add_(0, seg01,
                                               Cpq.reshape(-1)[perm01])
    cnt1 = torch.clamp(Na - torch.arange(Na2) * S1, min=1, max=S1).to(
        sb.dtype)
    w1 = 1.0 / torch.sqrt(cnt1)
    wnode = w1[torch.clamp(torch.arange(Na) // S1, max=Na2 - 1)]
    cols1 = torch.as_tensor(maps.cols1.astype(np.int64))
    sblk = wnode[torch.arange(Na).repeat_interleave(Wc)] \
        * wnode[cols1.reshape(-1)]
    dense2 = torch.zeros((Na2 * Na2, nv * nv), dtype=sb.dtype)
    dense2.index_add_(0, seg12, (blocks1f * sblk[:, None])[perm12])
    return blocks1f.T, dense2.T


def test_coarse_levels_equal_index_add_sums(system):
    _, _, op, sb = _ops(system, jnp.float64, torch.float64)
    prof, model = system["prof"], system["model"]
    maps = amg.build_maps(prof.cols, prof.n_node, 3)
    cols = torch.as_tensor(prof.cols.astype(np.int64))
    args = (maps, sb, cols, torch.as_tensor(model.coords), op.free_mask)
    lv = amg.coarse_levels(*args)
    again = amg.coarse_levels(*args)
    for name in ("Bo", "blocks1", "Dinv1", "dense2", "A2inv"):
        assert torch.equal(getattr(lv, name), getattr(again, name)), name
    blocks1, dense2 = _index_add_levels(maps, sb, cols, lv.Bo)
    assert torch.equal(lv.blocks1, blocks1)
    assert torch.equal(lv.dense2, dense2)


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
