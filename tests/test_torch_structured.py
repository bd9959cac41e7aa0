"""The structured hex8 operator and the K2 element matvec of the port
against the JAX package, on the CPU (where the K2 wrapper takes its
plain version and the JAX function its jnp path).

Tolerances: float64 within 1e-12 of the largest magnitude (the same sums
in another order); float32 within 1e-5 of it (24-term sums of float32
products, rounded in another order: a few units of float32's 1.2e-7).
A second operator check uses random non-symmetric element matrices on
non-cubic boxes against the port's incidence operator and a dense
assembly, so a stencil with its corners, dofs or element order
transposed cannot pass.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from frontistr_tpu.analysis.static import compute_element_stiffness
from frontistr_tpu.assembly import structured as jstructured
from frontistr_tpu.assembly.model import build_struct_model as jbuild
from frontistr_tpu.io.ctrlio import read_cnt as jread_cnt
from frontistr_tpu.meshgen import box_hex8 as jbox_hex8
from frontistr_tpu.ops import pallas_mv
from frontistr_tpu_torch.assembly import femop
from frontistr_tpu_torch.assembly.structured import (StructuredHexOperator,
                                                     soa_from_blocks)
from frontistr_tpu_torch.meshgen import box_hex8
from frontistr_tpu_torch.ops import element_mv

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
CNT = ("!VERSION\n 3\n!SOLUTION, TYPE=STATIC\n!BOUNDARY\n X0, 1, 3, 0.0\n"
       "!CLOAD\n X1, 3, -1.0\n!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n"
       "!SOLVER, METHOD=CG\n 10000, 1\n 1.0e-8, 1.0, 0.0\n!END\n")


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("E", [1, 37, 2051])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_element_matvec_soa_matches_jax(dtype, E):
    rng = np.random.default_rng(E)
    keT = rng.standard_normal((24, 24, E))
    xeT = rng.standard_normal((24, E))
    jd = jnp.float32 if dtype == torch.float32 else jnp.float64
    want = pallas_mv.element_matvec_soa(jnp.asarray(keT, jd),
                                        jnp.asarray(xeT, jd))
    before = element_mv.element_matvec_soa.launches
    got = element_mv.element_matvec_soa(torch.as_tensor(keT, dtype=dtype),
                                        torch.as_tensor(xeT, dtype=dtype))
    assert got.dtype == dtype
    assert element_mv.element_matvec_soa.launches == before   # plain path
    _close(got.numpy(), want, TOL[dtype])


def test_element_matvec_soa_rejects_bad_input():
    keT = torch.zeros((24, 24, 5), dtype=torch.float64)
    xeT = torch.zeros((24, 5), dtype=torch.float64)
    with pytest.raises(TypeError):
        element_mv.element_matvec_soa(keT.half(), xeT.half())
    with pytest.raises(ValueError):
        element_mv.element_matvec_soa(keT, xeT.float())
    with pytest.raises(ValueError):
        element_mv.element_matvec_soa(keT[:12], xeT)
    with pytest.raises(ValueError):
        element_mv.element_matvec_soa(keT, xeT[:, :4])
    with pytest.raises(ValueError):
        element_mv.element_matvec_soa(keT.transpose(0, 1), xeT)


@pytest.fixture(scope="module")
def jax_box(tmp_path_factory):
    """box_hex8(3, 4, 5) through the JAX package: model (X0 fixed) and
    its IC element matrices."""
    p = tmp_path_factory.mktemp("deck") / "case.cnt"
    p.write_text(CNT)
    jmodel = jbuild(jbox_hex8(3, 4, 5), jread_cnt(str(p)))
    assert jmodel.blocks[0].formulation == "IC"
    return jmodel, np.array(compute_element_stiffness(jmodel)[0])


def test_structured_operator_matches_jax(jax_box):
    jmodel, ke = jax_box
    free = np.ones(jmodel.n_dof_total)
    free[jmodel.fixed_dofs] = 0.0
    jop = jstructured.StructuredHexOperator(
        3, 4, 5, jstructured.soa_from_blocks(jnp.asarray(ke)),
        jnp.asarray(free))
    op = StructuredHexOperator(3, 4, 5, soa_from_blocks(torch.as_tensor(ke)),
                               torch.as_tensor(free))
    x = np.random.default_rng(0).standard_normal(jmodel.n_dof_total)
    tx = torch.as_tensor(x)
    _close(op.matvec(tx).numpy(), jop.matvec(jnp.asarray(x)), 1e-12)
    _close(op.apply_constrained(tx).numpy(),
           jop.apply_constrained(jnp.asarray(x)), 1e-12)
    _close(op.diag_blocks().numpy(), jop.diag_blocks(), 1e-12)
    _close(op.block_jacobi()(tx).numpy(),
           jop.block_jacobi()(jnp.asarray(x)), 1e-12)


def _dense(conn, ke, n_dof):
    """Dense K = sum_e P_e^T ke_e P_e."""
    dofs = (conn[:, :, None] * 3 + np.arange(3)).reshape(len(conn), 24)
    K = np.zeros((n_dof, n_dof))
    for d, k in zip(dofs, ke):
        K[np.ix_(d, d)] += k
    return K


@pytest.mark.parametrize("shape", [(2, 3, 4), (4, 1, 3)])
def test_structured_operator_orders_non_cubic(shape):
    mesh = box_hex8(*shape)
    conn = mesh.blocks[0].conn
    n_dof = 3 * mesh.n_node
    rng = np.random.default_rng(sum(shape))
    ke = rng.standard_normal((len(conn), 24, 24))       # not symmetric
    free = (rng.random(n_dof) > 0.2).astype(np.float64)
    op = StructuredHexOperator(*shape, soa_from_blocks(torch.as_tensor(ke)),
                               torch.as_tensor(free))
    assert torch.equal(op.keT, torch.as_tensor(ke).permute(1, 2, 0))
    inc, _ = femop.build_incidence([conn], mesh.n_node)
    fe_op = femop.FEOperator(
        kes=[torch.as_tensor(ke)],
        dofs=[torch.as_tensor((conn[:, :, None] * 3 + np.arange(3))
                              .reshape(len(conn), 24), dtype=torch.int64)],
        gather=torch.as_tensor(inc, dtype=torch.int64)[:, :, None] * 3
        + torch.arange(3),
        n_node=mesh.n_node, ndof=3, free_mask=torch.as_tensor(free))
    K = _dense(conn, ke, n_dof)
    x = rng.standard_normal(n_dof)
    tx = torch.as_tensor(x)
    _close(op.matvec(tx).numpy(), K @ x, 1e-12)
    _close(op.matvec(tx).numpy(), fe_op.matvec(tx).numpy(), 1e-12)
    _close(op.apply_constrained(tx).numpy(),
           fe_op.apply_constrained(tx).numpy(), 1e-12)
    diag = np.stack([K[3 * n:3 * n + 3, 3 * n:3 * n + 3]
                     for n in range(mesh.n_node)])
    _close(op.diag_blocks().numpy(), diag, 1e-12)
