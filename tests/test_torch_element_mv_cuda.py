"""K2 on the card: the CUDA SoA element matvec against its plain PyTorch
version on the same inputs.  The file imports nothing of JAX, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_element_mv_cuda.py

Every test skips, inside the test, where ``torch.cuda.is_available()`` is
false: the kernel has no CPU mode.  Tolerances: float32 within
1e-4 x max|plain| (the bar the port holds every float32 kernel to);
float64 within 1e-12 x max|plain| (the same 24-term sums in another
order).  Two launches are bit-equal (no atomics).
"""

import numpy as np
import pytest
import torch

from frontistr_tpu_torch.assembly.structured import (StructuredHexOperator,
                                                     soa_from_blocks)
from frontistr_tpu_torch.ops import element_mv

TOL = {torch.float32: 1e-4, torch.float64: 1e-12}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the K2 kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(E: int, dtype, device, seed: int = 0):
    rng = np.random.default_rng(seed)
    keT = torch.as_tensor(rng.standard_normal((24, 24, E)), dtype=dtype,
                          device=device)
    xeT = torch.as_tensor(rng.standard_normal((24, E)), dtype=dtype,
                          device=device)
    return keT, xeT


@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 127, 129, 100003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_on_card(cuda_device, dtype, E):
    keT, xeT = _inputs(E, dtype, cuda_device)
    before = element_mv.element_matvec_soa.launches
    got = element_mv.element_matvec_soa(keT, xeT)
    again = element_mv.element_matvec_soa(keT, xeT)
    want = element_mv.element_matvec_soa_reference(keT, xeT)
    torch.cuda.synchronize()
    assert element_mv.element_matvec_soa.launches == before + 2
    assert got.shape == (24, E) and got.dtype == dtype
    assert torch.equal(got, again)
    assert float((got - want).abs().max()) <= \
        TOL[dtype] * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_structured_matvec_on_card_matches_cpu(cuda_device, dtype):
    """The stencil operator (gather, K2, scatter) on the card against the
    same operator on the CPU, on a non-cubic box."""
    nx, ny, nz = 5, 3, 4
    rng = np.random.default_rng(1)
    ke = torch.as_tensor(rng.standard_normal((nx * ny * nz, 24, 24)),
                         dtype=dtype)
    n_dof = 3 * (nx + 1) * (ny + 1) * (nz + 1)
    free = torch.as_tensor((rng.random(n_dof) > 0.2), dtype=dtype)
    x = torch.as_tensor(rng.standard_normal(n_dof), dtype=dtype)
    cpu = StructuredHexOperator(nx, ny, nz, soa_from_blocks(ke), free)
    gpu = StructuredHexOperator(nx, ny, nz, soa_from_blocks(ke.cuda()),
                                free.cuda())
    want = cpu.apply_constrained(x)
    got = gpu.apply_constrained(x.cuda()).cpu()
    assert float((got - want).abs().max()) <= \
        TOL[dtype] * float(want.abs().max())


@pytest.mark.cuda
def test_kernel_rejects_bad_input(cuda_device):
    keT, xeT = _inputs(33, torch.float64, cuda_device, seed=2)
    before = element_mv.element_matvec_soa.launches
    with pytest.raises(TypeError):
        element_mv.element_matvec_soa(keT.half(), xeT.half())
    with pytest.raises(ValueError):
        element_mv.element_matvec_soa(keT, xeT.float())
    with pytest.raises(ValueError):
        element_mv.element_matvec_soa(keT[:, :, :32], xeT)
    with pytest.raises(ValueError):
        element_mv.element_matvec_soa(keT.transpose(0, 1), xeT)
    with pytest.raises(ValueError):
        element_mv.element_matvec_soa(keT, xeT.cpu())
    assert element_mv.element_matvec_soa.launches == before
