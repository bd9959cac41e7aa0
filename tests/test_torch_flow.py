"""The u-p flow element 3414 and its nd = 4 operator in the port against
the JAX package on the CPU (``fem/fluid.py``, ``assembly/ell.py``
``from_blocks``, K1's plain version at nd = 4): the element matrices,
right-hand sides, strain rates and stresses within 1e-13 of the largest,
at rest (tau's t3 at rest) and moving; element chunks that agree; the
assembled nd = 4 operator, whose blocks are not symmetric, against the
element-by-element product within 1e-12 of its largest and against the
JAX package's ELL product.  Also ROADMAP queue 3 fault 11: a mesh that
mixes 2-D and 3-D solids is refused by name, where the JAX package's
linear STATIC fails inside its isoparametric routine."""

import shutil
import traceback

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import frontistr_tpu.run as jrun
from frontistr_tpu.assembly import ell as jell
from frontistr_tpu.elements.tables import get_table as jtable
from frontistr_tpu.fem import fluid as jfluid
from frontistr_tpu_torch.assembly import ell
from frontistr_tpu_torch.assembly import segsum as segmod
from frontistr_tpu_torch.elements.tables import get_table
from frontistr_tpu_torch.fem import fluid
from frontistr_tpu_torch.io.meshio import ElemBlock
from frontistr_tpu_torch.io.neu import write_static_workdir
from frontistr_tpu_torch.meshgen import box_hex8
from frontistr_tpu_torch.run import run_directory

from _torch_flow_decks import flow_mesh, rel


def _field(mesh, scale, seed=0):
    return np.random.default_rng(seed).standard_normal((mesh.n_node, 4)) \
        * scale


@pytest.mark.parametrize("case", ["rest", "moving"])
def test_element_system_matches_jax(case):
    m = flow_mesh(2)
    conn = np.asarray(m.blocks[0].conn, np.int64)
    v = _field(m, 0.0 if case == "rest" else 0.3)
    mu, rho, dt = (1.0, 1.0, 1e12) if case == "rest" else (0.7, 1.3, 0.5)
    x = jnp.asarray(m.coords)[conn]
    Kj, bj = jfluid.stf_load_c3_vp(jtable(3414), x, jnp.asarray(v)[conn],
                                   mu, rho, dt)
    K, b = fluid.element_system(get_table(3414), torch.as_tensor(m.coords),
                                torch.as_tensor(conn), torch.as_tensor(v),
                                mu, rho, dt)
    assert rel(K.numpy(), Kj) <= 1e-13
    if case == "moving":
        assert rel(b.numpy(), bj) <= 1e-13
        # advection, SUPG and the velocity-pressure coupling
        assert rel(K.numpy(), K.transpose(1, 2).numpy()) > 1e-3
    else:
        assert float(b.abs().max()) == 0.0 and not np.asarray(bj).any()
    eps, p = jfluid.update_c3_vp(jtable(3414), x, jnp.asarray(v)[conn])
    sig = jfluid.fluid_stress(eps, p, mu)
    strain, stress = fluid.element_strain(
        get_table(3414), torch.as_tensor(m.coords), torch.as_tensor(conn),
        torch.as_tensor(v), mu)
    if case == "moving":
        assert rel(strain.numpy(), eps.mean(axis=1)) <= 1e-13
        assert rel(stress.numpy(), sig.mean(axis=1)) <= 1e-13


def test_element_chunks_agree():
    m = flow_mesh(3)
    conn = torch.as_tensor(np.asarray(m.blocks[0].conn, np.int64))
    xyz = torch.as_tensor(m.coords)
    v = torch.as_tensor(_field(m, 0.5, seed=1))
    whole = fluid.element_system(get_table(3414), xyz, conn, v, 0.01, 1.0,
                                 0.1)
    parts = fluid.element_system(get_table(3414), xyz, conn, v, 0.01, 1.0,
                                 0.1, chunk=17)
    for a, b in zip(parts, whole):
        assert float((a - b).abs().max()) <= 1e-15 * float(b.abs().max())
    s_whole = fluid.element_strain(get_table(3414), xyz, conn, v, 0.01)
    s_parts = fluid.element_strain(get_table(3414), xyz, conn, v, 0.01,
                                   chunk=17)
    for a, b in zip(s_parts, s_whole):
        assert float((a - b).abs().max()) <= 1e-15 * float(b.abs().max())


@pytest.mark.parametrize("kind", ["fluid", "random"])
def test_nd4_operator_matches_elementwise(kind):
    """The counterpart of ``tests/test_flow.py::
    test_global_assembly_matches_elementwise``: K1's nd = 4 element entry
    (its plain version) at the scalar-ELL plan reproduces sum_e K_e w_e,
    on the fluid's K and on random matrices with no symmetry at all."""
    m = flow_mesh(2)
    conn = np.asarray(m.blocks[0].conn, np.int64)
    n = m.n_node
    rng = np.random.default_rng(0)
    if kind == "fluid":
        K, _ = fluid.element_system(
            get_table(3414), torch.as_tensor(m.coords), torch.as_tensor(conn),
            torch.as_tensor(rng.standard_normal((n, 4)) * 0.1), 0.7, 1.3, 0.5)
    else:
        K = torch.as_tensor(rng.standard_normal((len(conn), 16, 16)))
    prof = ell.build_profile([conn], n, 4)
    op = ell.from_blocks(prof, [K], [4], np.ones(n * 4))
    w = rng.standard_normal(n * 4)
    got = op.matvec(torch.as_tensor(w)).numpy()
    want = np.zeros(n * 4)
    dof = (conn[:, :, None] * 4 + np.arange(4)).reshape(-1, 16)
    np.add.at(want, dof.reshape(-1),
              np.einsum("eij,ej->ei", K.numpy(), w[dof]).reshape(-1))
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    # the JAX package's nd = 4 ELL product on the same K
    jprof = jell.build_profile([conn], n, 4)
    jop = jell.ELLOperator(
        blocks=jell._assemble_jit(jprof.device(), (jnp.asarray(K.numpy()),),
                                  (4,)),
        cols=jnp.asarray(jprof.cols), diag_slot=jnp.asarray(jprof.diag_slot),
        n_node=n, ndof=4, free_mask=jnp.ones(n * 4))
    assert rel(got, jop.matvec(jnp.asarray(w))) <= 1e-13
    # the block-Jacobi preconditioner inverts the nodal 4 x 4 blocks
    D = op.diag_blocks().numpy()
    r = rng.standard_normal(n * 4)
    z = op.block_jacobi()(torch.as_tensor(r)).numpy().reshape(n, 4)
    assert rel(np.einsum("nij,nj->ni", D, z), r.reshape(n, 4)) <= 1e-12


def test_nd4_plain_planes_are_oriented():
    """Plane i*4 + j of slot (row node, col node) holds K[a*4 + i, b*4 + j]
    of pair (a, b): one element whose 256 entries all differ."""
    conn = np.asarray([[2, 0, 3, 1]], np.int64)
    prof = ell.build_profile([conn], 4, 4)
    K = torch.arange(256, dtype=torch.float64).reshape(1, 16, 16)
    out = segmod.segsum(prof.plan("cpu"), [K], [4], 4)
    for a in range(4):
        for b in range(4):
            r, c = conn[0, a], conn[0, b]
            w = int(np.flatnonzero(prof.cols[r] == c)[0])
            got = out[:, r * prof.W + w].reshape(4, 4)
            assert torch.equal(got, K[0, a * 4:a * 4 + 4, b * 4:b * 4 + 4])


def test_mixed_2d_3d_solids_refused_where_jax_fails(tmp_path):
    """ROADMAP queue 3 fault 11: ``box_hex8(2, 2, 2)`` with four 241
    quads on its Z0 face.  The JAX package's ``build_struct_model``
    takes the largest dimension, and its linear STATIC then fails with
    ValueError in ``frontistr_tpu/fem/isoparam.py``; the port refuses
    the deck by name."""
    mesh = box_hex8(2, 2, 2)
    conn = mesh.blocks[0].conn
    bottom = conn[np.all(mesh.coords[conn[:, :4], 2] == 0.0, axis=1), :4]
    assert len(bottom) == 4
    mesh.blocks.append(ElemBlock(241, np.arange(9, 13), bottom, bottom, 0))
    cnt = ("!VERSION\n 3\n!SOLUTION, TYPE=STATIC\n!BOUNDARY\n X0, 1, 3, 0.0\n"
           "!CLOAD\n X1, 3, -1.0\n!MATERIAL, NAME=M1\n!ELASTIC\n"
           " 210000.0, 0.3\n!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n"
           " 10000, 1\n 1.0e-8, 1.0, 0.0\n!END\n")
    wd, wj = str(tmp_path / "port"), str(tmp_path / "jax")
    write_static_workdir(wd, mesh, cnt)
    shutil.copytree(wd, wj)
    with pytest.raises(NotImplementedError,
                       match="2-D and 3-D solids in one mesh"):
        run_directory(wd, device="cpu")
    with pytest.raises(ValueError) as err:
        jrun.run_directory(wj)
    tb = traceback.extract_tb(err.value.__traceback__)
    frames = [f.filename for f in tb]
    assert any(f.endswith("frontistr_tpu/fem/isoparam.py") for f in frames)
