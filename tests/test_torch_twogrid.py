"""The box arm's pieces (the dof-major stencil operators, the two-grid
preconditioner and the refined box solve of
``frontistr_tpu_torch/microbench/box_twogrid.py``) against the JAX
package on the CPU, on the same inputs made from a seed with numpy.

Tolerances: the layout conversions and the interpolation weights exact;
the operators' products in f64 within 1e-12 of the largest magnitude
(the same sums in another order), in f32 within 1e-4 of it; the
transfers, the Chebyshev coarse solve and the two-grid M(r) in f64
within 1e-10 of it (20 Chebyshev steps of such sums).  The box solve at
n = 6 against the same loop composed here from the JAX package's
``structured``, ``mg`` and ``cg.pcg``, with one power-iteration start
vector for both (``jax.random`` cannot be matched): the CG total within
2 + 10% (f32 sums in another order), both relres <= 1e-8, x within 1e-6
of max|x|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frontistr_tpu.assembly import structured as jst
from frontistr_tpu.elements.tables import get_table as jget_table
from frontistr_tpu.fem import solid as jsolid
from frontistr_tpu.fem.material import D3 as JD3, elastic_D as jelastic_D
from frontistr_tpu.meshgen import box_hex8 as jbox_hex8
from frontistr_tpu.solver import cg as jcg
from frontistr_tpu.solver import mg as jmg
from frontistr_tpu_torch.assembly import structured as st
from frontistr_tpu_torch.microbench import box_twogrid as bt
from frontistr_tpu_torch.solver import mg

F64, F32 = torch.float64, torch.float32


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _ops(dims, rng, dtype, jdtype):
    """A D operator of each package on random element matrices and a
    random free mask of the box ``dims``."""
    nx, ny, nz = dims
    E = nx * ny * nz
    n_dof = 3 * (nx + 1) * (ny + 1) * (nz + 1)
    keT = rng.standard_normal((24, 24, E))
    free = (rng.random(n_dof) > 0.2).astype(float)
    return (st.StructuredHexOperatorD(nx, ny, nz,
                                      torch.as_tensor(keT, dtype=dtype),
                                      torch.as_tensor(free, dtype=dtype)),
            jst.StructuredHexOperatorD(nx, ny, nz, jnp.asarray(keT, jdtype),
                                       jnp.asarray(free, jdtype)))


def test_dof_major_round_trip_exact():
    rng = np.random.default_rng(0)
    v = rng.standard_normal(3 * 35)
    got = st.to_dof_major(torch.as_tensor(v), 35)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jst.to_dof_major(v, 35)))
    back = st.from_dof_major(got, 35)
    np.testing.assert_array_equal(back.numpy(), v)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jst.from_dof_major(np.asarray(got), 35)))


@pytest.mark.parametrize("n_f,factor", [(6, 3), (9, 3), (8, 2), (23, 1)])
def test_interp1d_weights_bit_equal(n_f, factor):
    got = mg.interp1d_weights(n_f, n_f // factor, factor)
    want = jmg.interp1d_weights(n_f, n_f // factor, factor)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype,jdtype,tol", [(F64, jnp.float64, 1e-12),
                                              (F32, jnp.float32, 1e-4)])
def test_d_and_const_d_products(dtype, jdtype, tol):
    rng = np.random.default_rng(1)
    dims = (3, 4, 2)
    op, jop = _ops(dims, rng, dtype, jdtype)
    x = rng.standard_normal(op.free_mask.numel())
    xt = torch.as_tensor(x, dtype=dtype)
    xj = jnp.asarray(x, jdtype)
    _close(op.matvec(xt), jop.matvec(xj), tol)
    _close(op.apply_constrained(xt), jop.apply_constrained(xj), tol)
    _close(op.diag_blocks(), jop.diag_blocks(), tol)
    _close(op.block_jacobi()(xt), jop.block_jacobi()(xj), 1e3 * tol)
    ke = rng.standard_normal((24, 24))
    cop = st.StructuredHexOperatorConstD(*dims, torch.as_tensor(ke, dtype=dtype),
                                         op.free_mask)
    jcop = jst.StructuredHexOperatorConstD(*dims, jnp.asarray(ke, jdtype),
                                           jop.free_mask)
    _close(cop.matvec(xt), jcop.matvec(xj), tol)
    _close(cop.apply_constrained(xt), jcop.apply_constrained(xj), tol)


def test_d_operator_is_the_node_major_operator():
    """The dof-major product on the stiffness of a box equals the
    node-major ``StructuredHexOperator``'s in the other layout."""
    box = bt.make_box(6)
    keT = bt.assemble_soa(box, F64, "cpu")
    nn = box.mesh.n_node
    free = torch.as_tensor(box.free)
    op = st.StructuredHexOperatorD(6, 6, 6, keT, free)
    opn = st.StructuredHexOperator(6, 6, 6, keT, st.from_dof_major(free, nn))
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(3 * nn))
    _close(st.from_dof_major(op.apply_constrained(x), nn),
           opn.apply_constrained(st.from_dof_major(x, nn)), 1e-12)


def test_transfers_chebyshev_twogrid_f64():
    rng = np.random.default_rng(3)
    n = 6
    op, jop = _ops((n, n, n), rng, F64, jnp.float64)
    opc, jopc = _ops((n // 3,) * 3, rng, F64, jnp.float64)
    # SPD element matrices, so the Chebyshev recurrence stays bounded
    for o, jo in ((op, jop), (opc, jopc)):
        k = o.keT.permute(2, 0, 1)
        spd = (k @ k.transpose(1, 2) + 24.0 * torch.eye(24)).permute(1, 2, 0)
        o.keT = spd.contiguous()
        jo.keT = jnp.asarray(o.keT.numpy())
    P, R = mg.make_transfers(n, n, n, 3, dtype=F64)
    jP, jR = jmg.make_transfers(n, n, n, 3, dtype=jnp.float64)
    vc = rng.standard_normal(opc.free_mask.numel())
    vf = rng.standard_normal(op.free_mask.numel())
    _close(P(torch.as_tensor(vc)), jP(jnp.asarray(vc)), 1e-10)
    _close(R(torch.as_tensor(vf)), jR(jnp.asarray(vf)), 1e-10)
    lmax = 2.0
    z = mg.chebyshev_apply(opc.apply_constrained, opc.block_jacobi(), lmax,
                           20, torch.as_tensor(vc))
    jz = jmg.chebyshev_apply(jopc.apply_constrained, jopc.block_jacobi(),
                             lmax, 20, jnp.asarray(vc))
    _close(z, jz, 1e-10)
    M = mg.make_twogrid(op, opc, P, R, lmax)
    jM = jmg.make_twogrid(jop, jopc, jP, jR, lmax)
    _close(M(torch.as_tensor(vf)), jM(jnp.asarray(vf)), 1e-10)


def _jax_box_solve(n, v0):
    """``bench.py``'s box loop from the JAX package's modules, eager
    outside ``pcg`` (a jitted chunk)."""
    def t32(t):
        return dataclasses.replace(t, dN=t.dN.astype(np.float32),
                                   N=t.N.astype(np.float32),
                                   weights=t.weights.astype(np.float32))
    table = jget_table(361)
    D1 = jelastic_D(210e3, 0.3, JD3)

    def setup(m):
        mesh = jbox_hex8(m, m, m)
        conn = mesh.blocks[0].conn
        free = np.ones((3, mesh.n_node))
        free[:, mesh.node_groups["X0"]] = 0.0
        ke = jsolid.stiffness_linear(
            t32(table), jnp.asarray(mesh.coords, jnp.float32)[conn],
            jnp.asarray(np.broadcast_to(D1, (len(conn), 6, 6)), jnp.float32))
        return mesh, jst.soa_from_blocks(ke, pad=False), free.reshape(-1)

    mesh, keT, free = setup(n)
    meshc, keTc, freec = setup(n // 3)
    f = np.zeros((3, mesh.n_node))
    f[2, mesh.node_groups["X1"]] = -1.0
    f = f.reshape(-1)
    op = jst.StructuredHexOperatorD(n, n, n, keT, jnp.asarray(free,
                                                              jnp.float32))
    opc = jst.StructuredHexOperatorD(n // 3, n // 3, n // 3, keTc,
                                     jnp.asarray(freec, jnp.float32))
    Mc = opc.block_jacobi()
    v = jnp.asarray(v0, jnp.float32)
    v = v / jnp.linalg.norm(v)
    for _ in range(15):
        w = Mc(opc.apply_constrained(v))
        lam = jnp.linalg.norm(w)
        v = w / lam
    lmax_c = lam * 1.05
    lam_ = 210e3 * 0.3 / (1.3 * 0.4)
    mu = 210e3 / 2.6
    conn = mesh.blocks[0].conn
    ke64 = jsolid.stiffness_linear_iso(
        table, jnp.asarray(mesh.coords)[conn[:1]], lam_, mu)[0]
    free64 = jnp.asarray(free)
    op64 = jst.StructuredHexOperatorConstD(n, n, n, ke64, free64)
    P, R = jmg.make_transfers(n, n, n, 3)
    M = jmg.make_twogrid(op, opc, P, R, lmax_c)
    cg32 = jax.jit(lambda b, x0: jcg.pcg(op.apply_constrained, b, M=M,
                                         x0=x0, tol=1e-3, maxiter=600))
    x = jnp.zeros(f.size)
    bnrm = float(np.linalg.norm(f))
    total = 0
    for _ in range(6):
        r = f * free64 - op64.matvec(x * free64) * free64
        if float(jnp.linalg.norm(r)) / bnrm <= 1e-8:
            break
        b = r.astype(jnp.float32)
        dx = jnp.zeros_like(b)
        for _ in range(6):
            res = cg32(b, dx)
            dx = res.x
            total += int(res.iters)
            if float(res.relres) <= 1e-3:
                break
        x = x + dx.astype(jnp.float64)
    r = f * free64 - op64.matvec(x * free64) * free64
    return np.asarray(x), total, float(jnp.linalg.norm(r)) / bnrm


def test_box_solve_matches_jax():
    n = 6
    v0 = np.random.default_rng(7).standard_normal(
        3 * (n // 3 + 1) ** 3).astype(np.float32)
    res = bt.solve(n, "cpu", v0=torch.as_tensor(v0))
    jx, jtotal, jrel = _jax_box_solve(n, v0)
    assert res.relres <= 1e-8 and jrel <= 1e-8
    assert abs(res.cg_iters - jtotal) <= 2 + 0.1 * jtotal, \
        (res.cg_iters, jtotal)
    _close(res.x.numpy(), jx, 1e-6)
    assert bt.node_major_relres(bt.make_box(n), res.x) <= 1e-8
