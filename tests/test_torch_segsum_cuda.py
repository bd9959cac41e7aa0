"""K1 on the card: the CUDA segment-sum kernel against its plain PyTorch
version on the same inputs.  The file imports nothing of JAX, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_segsum_cuda.py

Every test skips, inside the test, where ``torch.cuda.is_available()`` is
false: the kernel has no CPU mode.  Tolerances: float32 within
1e-4 x max|plain| (the bar of tests/test_segsum_pallas.py); float64
within 1e-12 x max|plain| (the same sums in another order).  Two
launches are bit-equal (no atomics).
"""

import numpy as np
import pytest
import torch

from frontistr_tpu_torch.assembly import bell
from frontistr_tpu_torch.assembly import segsum as sm
from frontistr_tpu_torch.meshgen import box_tet4

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
@pytest.mark.parametrize("case", ["random", "empty_slots", "long_segment"])
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
    want = sm.segsum_reference(plan, kes, [4, 4], 3)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype)


@pytest.mark.cuda
def test_kernel_rejects_bad_input(cuda_device):
    plan, ke = _nodal_case("random", 7, torch.float64, cuda_device)
    with pytest.raises(TypeError):
        sm.segsum(plan, [ke.to(torch.float16)], [1], 3)
    with pytest.raises(ValueError):
        sm.segsum(plan, [ke.transpose(1, 2)], [1], 3)
    with pytest.raises(ValueError):
        sm.segsum(plan, [ke.cpu()], [1], 3)
