"""The box arm on the card: ``StructuredHexOperatorD`` through K2
against its plain version, and the two-grid box solve at n = 9 on the
card against the same solve on the CPU.  The file imports nothing of
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_twogrid_cuda.py

Every test skips, inside the test, where ``torch.cuda.is_available()`` is
false: K2 has no CPU mode.  Tolerances: the product in float32 within
1e-4 and in float64 within 1e-12 of the largest magnitude (the 24-term
sums in another order); the box solve's CG count within 2 + 10% of the
CPU's (float32 sums in another order), both relres <= 1e-8 by the
one-element f64 operator and by the node-major one, x within 1e-6 of
max|x|.
"""

import numpy as np
import pytest
import torch

from frontistr_tpu_torch.assembly.structured import StructuredHexOperatorD
from frontistr_tpu_torch.microbench import box_twogrid as bt
from frontistr_tpu_torch.ops import element_mv


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the K2 kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-12)])
def test_d_operator_through_k2(cuda_device, dtype, tol):
    box = bt.make_box(9)
    keT = bt.assemble_soa(box, dtype, cuda_device)
    free = torch.as_tensor(box.free, dtype=dtype, device=cuda_device)
    op = StructuredHexOperatorD(9, 9, 9, keT, free)
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(
        free.numel()), dtype=dtype, device=cuda_device)
    before = element_mv.element_matvec_soa.launches
    got = op.apply_constrained(x)
    assert element_mv.element_matvec_soa.launches == before + 1
    xeT = op._gather_stencil(x * free)
    want = op._scatter_stencil(
        element_mv.element_matvec_soa_reference(keT, xeT)) * free + \
        x * (1.0 - free)
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())
    assert torch.equal(got, op.apply_constrained(x))


@pytest.mark.cuda
def test_box_solve_card_matches_cpu(cuda_device):
    v0 = torch.as_tensor(np.random.default_rng(7).standard_normal(
        3 * 4 ** 3), dtype=torch.float32)
    element_mv.element_matvec_soa.launches_by_e.clear()
    gpu = bt.solve(9, cuda_device, v0=v0)
    by_e = dict(element_mv.element_matvec_soa.launches_by_e)
    cpu = bt.solve(9, "cpu", v0=v0)
    assert set(by_e) == {9 ** 3, 3 ** 3}
    # per PCG call: A and 2 fine products in M per iteration (+1 first),
    # 20 coarse ones in the Chebyshev solve; 15 in the power iteration
    calls = sum(gpu.chunks_per_pass) + gpu.cg_iters
    assert by_e[9 ** 3] == 3 * calls
    assert by_e[3 ** 3] == 20 * calls + 15
    assert gpu.relres <= 1e-8 and cpu.relres <= 1e-8
    assert bt.node_major_relres(bt.make_box(9), gpu.x) <= 1e-8
    assert abs(gpu.cg_iters - cpu.cg_iters) <= 2 + 0.1 * cpu.cg_iters
    x, xc = gpu.x.cpu().numpy(), cpu.x.numpy()
    assert np.abs(x - xc).max() <= 1e-6 * np.abs(xc).max()
