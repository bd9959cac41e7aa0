"""K1 on the card: the CUDA segment-sum kernels (the element assembly
``segsum`` and the planes entry ``segsum_planes``) against their plain
PyTorch versions on the same inputs, and the AMG setup and the nodal
smoothing that sum through the planes entry, run twice; K1 at the
hex20 (m = 60) and spring shapes and the !EQUATION reduction that sums
through the planes entry, run twice; the element entry at nd = 2 (the
2-D solids' four planes) on one-node and plane-box cluster profiles, and
a quad8 deck's 2-D AMG setup run twice; the element entry at scalar-ELL
plans (tet4 and hex8, the plan of ``ell.from_model``, the operator of
linear STATIC's BiCGSTAB, GMRES and GPBiCG).  The file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_segsum_cuda.py

Every test skips, inside the test, where ``torch.cuda.is_available()`` is
false: the kernel has no CPU mode.  Tolerances: float32 within
1e-4 x max|plain| (the bar of tests/test_segsum_pallas.py); float64
within 1e-12 x max|plain| (the same sums in another order).  Two
launches are bit-equal (no atomics), and so are two AMG setups and two
nodal smoothings on the same inputs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from frontistr_tpu_torch.analysis import static as stmod
from frontistr_tpu_torch.assembly import bell, ell, femop
from frontistr_tpu_torch.assembly import segsum as sm
from frontistr_tpu_torch.assembly.model import build_struct_model
from frontistr_tpu_torch.io.ctrlio import read_cnt
from frontistr_tpu_torch.meshgen import box_hex8, box_plane, box_tet4
from frontistr_tpu_torch.post import nodal
from frontistr_tpu_torch.solver import amg

CNT = ("!VERSION\n 3\n!SOLUTION, TYPE=STATIC\n!BOUNDARY\n X0, 1, 3, 0.0\n"
       "!CLOAD\n X1, 3, -1.0\n!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n"
       "!SOLVER, METHOD=CG\n 10000, 1\n 1.0e-8, 1.0, 0.0\n!END\n")

TOL = {torch.float32: 1e-4, torch.float64: 1e-12}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the K1 kernel has no CPU mode)")
    return torch.device("cuda")


def _seg_case(case: str):
    rng = np.random.default_rng(0)
    if case == "random":
        return np.sort(rng.integers(0, 3000, 20000)).astype(np.int32), 3000
    if case == "empty_slots":
        return np.asarray([0, 0, 5, 5, 5], np.int32), 10     # slots 1-4
    if case == "lengths":
        # segments of 0, 1, 24 and 1,500 entries, each several times
        lens = np.tile([0, 1, 24, 0, 1500, 1, 24, 0], 5)
        return (np.repeat(np.arange(len(lens)), lens).astype(np.int32),
                len(lens))
    long = np.r_[np.zeros(50, np.int64), np.full(1500, 3),
                 rng.integers(4, 40, 400)]
    return np.sort(long).astype(np.int32), 40


def _nodal_case(case: str, seed: int, dtype, device):
    """One block of one-node 'elements' with nd=3: raw entry p is ke[p]."""
    seg, n_slots = _seg_case(case)
    rng = np.random.default_rng(seed)
    P = len(seg)
    perm = rng.permutation(P).astype(np.int32)
    plan = sm.make_plan(perm, seg, n_slots, (P,), device)
    ke = torch.as_tensor(rng.standard_normal((P, 3, 3)), dtype=dtype,
                         device=device)
    return plan, ke


def _assert_close(got, want, dtype):
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= \
        TOL[dtype] * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "empty_slots", "long_segment",
                                  "lengths"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_on_card(cuda_device, case, dtype):
    plan, ke = _nodal_case(case, 5, dtype, cuda_device)
    before = sm.segsum.launches
    got = sm.segsum(plan, [ke], [1], 3)
    again = sm.segsum(plan, [ke], [1], 3)
    want = sm.segsum_reference(plan, [ke], [1], 3)
    torch.cuda.synchronize()
    assert sm.segsum.launches == before + 2
    assert torch.equal(got, again)
    _assert_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_two_block_cluster_on_card(cuda_device, dtype):
    conn = box_tet4(3, 3, 2).blocks[0].conn
    h = conn.shape[0] // 3
    conns = [conn[:h], conn[h:]]
    prof = bell.build_cluster_profile(conns, 4 * 4 * 3, 3)
    rng = np.random.default_rng(6)
    kes = [torch.as_tensor(rng.standard_normal((c.shape[0], 12, 12)),
                           dtype=dtype, device=cuda_device) for c in conns]
    plan = prof.plan(cuda_device)
    got = sm.segsum(plan, kes, [4, 4], 3)
    again = sm.segsum(plan, kes, [4, 4], 3)
    want = sm.segsum_reference(plan, kes, [4, 4], 3)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_cluster_tiles_on_card(cuda_device, dtype):
    """A one-block cluster profile whose tiles follow its slot shape over
    several chunks of clusters, the last one ragged."""
    mesh = box_tet4(9, 8, 7)
    conn = mesh.blocks[0].conn
    prof = bell.build_cluster_profile([conn], mesh.n_node, 3)
    plan = prof.plan(cuda_device)
    sc = sm.element_schedule(plan, [4], 3, torch.tensor([], dtype=dtype)
                             .element_size())
    assert sc.bw == prof.G * prof.Wc and sc.n_chunks > 1
    kes = [torch.as_tensor(np.random.default_rng(11).standard_normal(
        (conn.shape[0], 12, 12)), dtype=dtype, device=cuda_device)]
    got = sm.segsum(plan, kes, [4], 3)
    again = sm.segsum(plan, kes, [4], 3)
    want = sm.segsum_reference(plan, kes, [4], 3)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_tet10_cluster_on_card(cuda_device, dtype):
    """The cluster profile of a tet10 (342) mesh: m = 30 entries per
    element row, the widest element the Newton path assembles."""
    from _torch_decks import tet10_box
    mesh = tet10_box(7, 6, 5)
    conn = mesh.blocks[0].conn
    prof = bell.build_cluster_profile([conn], mesh.n_node, 3)
    plan = prof.plan(cuda_device)
    kes = [torch.as_tensor(np.random.default_rng(12).standard_normal(
        (conn.shape[0], 30, 30)), dtype=dtype, device=cuda_device)]
    got = sm.segsum(plan, kes, [10], 3)
    again = sm.segsum(plan, kes, [10], 3)
    want = sm.segsum_reference(plan, kes, [10], 3)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_hex20_spring_cluster_on_card(cuda_device, dtype):
    """The cluster profile of a hex20 (362) mesh with a one-node spring
    block beside it: m = 60 and m = 3 in one launch, the hex20_mpc
    path's shapes."""
    from _torch_decks import hex20_box
    mesh = hex20_box(6, 5, 4)
    conns = [mesh.blocks[0].conn,
             mesh.node_groups["X1"][:1].reshape(1, 1).astype(np.int32)]
    plan = bell.build_cluster_profile(conns, mesh.n_node, 3).plan(
        cuda_device)
    rng = np.random.default_rng(13)
    kes = [torch.as_tensor(rng.standard_normal((c.shape[0], m, m)),
                           dtype=dtype, device=cuda_device)
           for c, m in zip(conns, (60, 3))]
    got = sm.segsum(plan, kes, [20, 1], 3)
    again = sm.segsum(plan, kes, [20, 1], 3)
    want = sm.segsum_reference(plan, kes, [20, 1], 3)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("etype", [341, 361])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_ell_plan_on_card(cuda_device, etype, dtype):
    """K1 at a scalar-ELL plan (one slot row of W slots a node, no slot
    shape: the (1, 1, 1, n_slots) tiling), tet4 m = 12 and hex8 m = 24,
    run twice bit-equal; then ``ell.from_model`` on the card against the
    CPU."""
    mesh = (box_tet4 if etype == 341 else box_hex8)(9, 8, 7)
    conn = mesh.blocks[0].conn
    nn = conn.shape[1]
    prof = ell.build_profile([conn], mesh.n_node, 3)
    plan = prof.plan(cuda_device)
    kes = [torch.as_tensor(np.random.default_rng(14).standard_normal(
        (conn.shape[0], 3 * nn, 3 * nn)), dtype=dtype, device=cuda_device)]
    before = sm.segsum.launches
    got = sm.segsum(plan, kes, [nn], 3)
    again = sm.segsum(plan, kes, [nn], 3)
    want = sm.segsum_reference(plan, kes, [nn], 3)
    torch.cuda.synchronize()
    assert sm.segsum.launches == before + 2
    assert got.shape == (9, prof.n_slots)
    assert torch.equal(got, again)
    _assert_close(got, want, dtype)


@pytest.mark.cuda
def test_ell_operator_on_card(cuda_device, tmp_path):
    p = tmp_path / "case.cnt"
    p.write_text(CNT)
    mesh = box_tet4(6, 5, 4)
    ops = []
    for dev in (cuda_device, "cpu"):
        model = build_struct_model(mesh, read_cnt(str(p)), device=dev)
        kes = stmod.compute_element_stiffness(model)
        ops.append(ell.from_model(model, kes))
    x = torch.as_tensor(np.random.default_rng(15).standard_normal(
        ops[1].n_dof))
    _assert_close(ops[0].rows.cpu(), ops[1].rows, torch.float64)
    _assert_close(ops[0].apply_constrained(x.to(cuda_device)).cpu(),
                  ops[1].apply_constrained(x), torch.float64)


@pytest.mark.cuda
def test_mpc_reduction_repeats_bit_equal_on_card(cuda_device):
    """The !EQUATION reduction T^T (``extras.mpc_Tt``) sums through the
    planes entry: hundreds of dependents on one master, twice on the
    card bit-equal, and within 1e-12 of the CPU's plain version."""
    from _torch_decks import hex20_box
    from frontistr_tpu_torch.assembly import extras
    from frontistr_tpu_torch.io.meshio import Equation
    mesh = hex20_box(6, 5, 4)
    x1 = mesh.node_groups["X1"]
    mesh.equations = [Equation(np.asarray([int(k), int(x1[0])]),
                               np.asarray([3, 3]), np.asarray([1.0, -1.0]),
                               0.0) for k in x1[1:]]
    n = mesh.n_node * 3
    y = torch.as_tensor(np.random.default_rng(14).standard_normal(n))
    m = extras.mpc_arrays(mesh, 3, n, cuda_device)
    got = extras.mpc_Tt(m, y.to(cuda_device))
    again = extras.mpc_Tt(m, y.to(cuda_device))
    want = extras.mpc_Tt(extras.mpc_arrays(mesh, 3, n, "cpu"), y)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_close(got.cpu(), want, torch.float64)


@pytest.mark.cuda
def test_kernel_rejects_bad_input(cuda_device):
    """After a good call, element matrices of the same shape with another
    dtype, other strides or on the CPU are checked anew and raise,
    launching nothing."""
    plan, ke = _nodal_case("random", 7, torch.float64, cuda_device)
    sm.segsum(plan, [ke], [1], 3)
    n0 = sm.segsum.launches
    with pytest.raises(TypeError):
        sm.segsum(plan, [ke.to(torch.float16)], [1], 3)
    with pytest.raises(ValueError):
        sm.segsum(plan, [ke.transpose(1, 2)], [1], 3)
    with pytest.raises(ValueError):
        sm.segsum(plan, [ke.cpu()], [1], 3)
    assert sm.segsum.launches == n0


# --- the planes entry, and its callers


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "empty_slots", "lengths"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_planes_kernel_matches_plain_on_card(cuda_device, case, dtype):
    seg, n_slots = _seg_case(case)
    rng = np.random.default_rng(8)
    P = len(seg)
    plan = sm.make_plan(rng.permutation(P).astype(np.int32), seg, n_slots,
                        (P,), cuda_device)
    values = torch.as_tensor(rng.standard_normal((13, P)), dtype=dtype,
                             device=cuda_device)
    before = sm.segsum_planes.launches
    got = sm.segsum_planes(values, plan)
    again = sm.segsum_planes(values, plan)
    want = sm.segsum_planes_reference(values, plan)
    torch.cuda.synchronize()
    assert sm.segsum_planes.launches == before + 2
    assert torch.equal(got, again)
    _assert_close(got, want, dtype)


@pytest.mark.cuda
def test_planes_rejects_bad_input_on_card(cuda_device):
    """After a good call, values of the same shape with another dtype,
    other strides or on the CPU are checked anew and raise, launching
    nothing."""
    seg, n_slots = _seg_case("random")
    P = len(seg)
    plan = sm.make_plan(np.arange(P, dtype=np.int32), seg, n_slots, (P,),
                        cuda_device)
    values = torch.ones((4, P), dtype=torch.float64, device=cuda_device)
    sm.segsum_planes(values, plan)
    n0 = sm.segsum_planes.launches
    for bad, error in ((values.half(), TypeError),
                       (values.T.contiguous().T, ValueError),
                       (values.cpu(), ValueError)):
        with pytest.raises(error):
            sm.segsum_planes(bad, plan)
    assert sm.segsum_planes.launches == n0


def _amg_inputs(tmp_path, device):
    """A small tet deck's AMG setup inputs on ``device``."""
    p = tmp_path / "case.cnt"
    p.write_text(CNT)
    model = build_struct_model(box_tet4(12, 10, 8), read_cnt(str(p)),
                               device=device)
    kes = stmod.compute_element_stiffness(model)
    setup = stmod.cluster_setup(model, {}, policy="amg")
    cop, sb = bell.from_model(model, kes, dtype=torch.float64,
                              profile=setup.cprof, want_scalar=True,
                              scalar=setup.prof)
    cop = dataclasses.replace(cop,
                              free_mask=femop.from_model(model,
                                                         kes).free_mask)
    return (setup.amaps, sb, setup.cols, setup.coords, cop.free_mask,
            cop.apply_constrained, cop.block_jacobi())


@pytest.mark.cuda
def test_amg_setup_repeats_bit_equal_on_card(cuda_device, tmp_path):
    """Two setups on the same inputs: bit-equal coarse levels and a
    bit-equal V-cycle on a fixed vector."""
    args = _amg_inputs(tmp_path, cuda_device)
    before = sm.segsum_planes.launches
    lv, again = amg.coarse_levels(*args[:5]), amg.coarse_levels(*args[:5])
    assert sm.segsum_planes.launches == before + 4
    for name in ("Bo", "blocks1", "Dinv1", "dense2", "A2inv"):
        assert torch.equal(getattr(lv, name), getattr(again, name)), name
    r = torch.as_tensor(np.random.default_rng(9).standard_normal(
        args[4].numel()), device=cuda_device)
    assert torch.equal(amg.setup_amg(*args)(r), amg.setup_amg(*args)(r))


@pytest.mark.cuda
def test_nodal_smoothing_repeats_bit_equal_on_card(cuda_device):
    rng = np.random.default_rng(10)
    conns = [rng.integers(0, 500, (900, 4)), rng.integers(0, 500, (300, 8))]
    block_data = [dict(etype=et, conn=c,
                       gauss_strain=torch.as_tensor(
                           rng.standard_normal((c.shape[0], nq, 6)),
                           device=cuda_device),
                       gauss_stress=torch.as_tensor(
                           rng.standard_normal((c.shape[0], nq, 6)),
                           device=cuda_device))
                  for et, nq, c in ((341, 1, conns[0]), (361, 8, conns[1]))]
    before = sm.segsum_planes.launches
    a = nodal.smooth(500, block_data, 3)
    b = nodal.smooth(500, block_data, 3)
    assert sm.segsum_planes.launches == before + 2
    for k in ("strain", "stress", "mises", "count"):
        assert np.array_equal(a[k], b[k]), k
    cpu = nodal.smooth(500, [dict(d, gauss_strain=d["gauss_strain"].cpu(),
                                  gauss_stress=d["gauss_stress"].cpu())
                             for d in block_data], 3)
    scale = np.abs(cpu["stress"]).max()
    assert np.abs(a["stress"] - cpu["stress"]).max() <= 1e-12 * scale


# ---- the nd = 2 entry (the 2-D solids 231/232/241/242) -------------------

PLANE_CNT = ("!VERSION\n 3\n!SOLUTION, TYPE=STATIC\n!BOUNDARY\n"
             " X0, 1, 2, 0.0\n!CLOAD\n X1, 2, -1.0\n!MATERIAL, NAME=M1\n"
             "!ELASTIC\n 210000.0, 0.3\n!SOLVER, METHOD=CG\n 10000, 1\n"
             " 1.0e-8, 1.0, 0.0\n!END\n")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "empty_slots", "long_segment",
                                  "lengths"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_nd2_matches_plain_on_card(cuda_device, case, dtype):
    """One-node 'elements' with nd = 2: raw entry p is ke[p] (2, 2)."""
    seg, n_slots = _seg_case(case)
    rng = np.random.default_rng(12)
    P = len(seg)
    plan = sm.make_plan(rng.permutation(P).astype(np.int32), seg, n_slots,
                        (P,), cuda_device)
    ke = torch.as_tensor(rng.standard_normal((P, 2, 2)), dtype=dtype,
                         device=cuda_device)
    before = sm.segsum.launches
    got = sm.segsum(plan, [ke], [1], 2)
    again = sm.segsum(plan, [ke], [1], 2)
    want = sm.segsum_reference(plan, [ke], [1], 2)
    torch.cuda.synchronize()
    assert sm.segsum.launches == before + 2 and got.shape[0] == 4
    assert torch.equal(got, again)
    _assert_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("etype", [231, 232, 241, 242])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_plane_cluster_on_card(cuda_device, etype, dtype):
    """The cluster profile of a plane box (nd = 2, m = 6, 12, 8 or 16)
    over several chunks of clusters: the element entry against its plain
    version, and a relaunch bit-equal."""
    mesh = box_plane(23, 17, etype=etype)
    conn = mesh.blocks[0].conn
    nn = conn.shape[1]
    prof = bell.build_cluster_profile([conn], mesh.n_node, 2)
    plan = prof.plan(cuda_device)
    kes = [torch.as_tensor(np.random.default_rng(13).standard_normal(
        (conn.shape[0], 2 * nn, 2 * nn)), dtype=dtype, device=cuda_device)]
    got = sm.segsum(plan, kes, [nn], 2)
    again = sm.segsum(plan, kes, [nn], 2)
    want = sm.segsum_reference(plan, kes, [nn], 2)
    torch.cuda.synchronize()
    assert got.shape == (4, plan.n_slots)
    assert torch.equal(got, again)
    _assert_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_planes_nd2_amg_repeats_bit_equal_on_card(cuda_device, tmp_path,
                                                  dtype):
    """A quad8 deck's AMG setup at nd = 2 (three rigid modes): the planes
    entry at its level-1 shapes against the plain version, and two
    setups bit-equal."""
    p = tmp_path / "case.cnt"
    p.write_text(PLANE_CNT)
    model = build_struct_model(box_plane(30, 20, etype=242),
                               read_cnt(str(p)), device=cuda_device)
    kes = stmod.compute_element_stiffness(model)
    setup = stmod.cluster_setup(model, {}, policy="amg")
    cop, sb = bell.from_model(model, kes, dtype=dtype,
                              profile=setup.cprof, want_scalar=True,
                              scalar=setup.prof)
    cop = dataclasses.replace(cop, free_mask=femop.from_model(
        model, kes).free_mask.to(dtype))
    args = (setup.amaps, sb, setup.cols, setup.coords.to(dtype),
            cop.free_mask)
    before = sm.segsum_planes.launches
    lv, again = amg.coarse_levels(*args), amg.coarse_levels(*args)
    assert sm.segsum_planes.launches == before + 4
    for name in ("Bo", "blocks1", "Dinv1", "dense2", "A2inv"):
        assert torch.equal(getattr(lv, name), getattr(again, name)), name
    assert setup.amaps.nd == 2 and setup.amaps.nv == 3
    plan01, _ = setup.amaps.plans(cuda_device)
    vals = torch.randn((9, plan01.perm.numel()), dtype=dtype,
                       device=cuda_device)
    _assert_close(sm.segsum_planes(vals, plan01),
                  sm.segsum_planes_reference(vals, plan01), dtype)
