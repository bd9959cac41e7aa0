"""K1's nd = 6 entry on the card (shells and 611 beams): the element
kernel against its plain version on cluster profiles of element width
m = 12 (611), 18 (731), 24 (741) and 54 (743), float32 and float64,
launched twice and bit-equal; and small shell and beam STATIC decks
through ``run_directory`` on the card against the same decks on the CPU.
The file imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_shell_cuda.py

Every test skips, inside the test, where ``torch.cuda.is_available()`` is
false: the kernel has no CPU mode.  Tolerances: float32 within
1e-4 x max|plain|, float64 within 1e-12 x max|plain| (the bar of
tests/test_torch_segsum_cuda.py); the card's f64 displacements within
1e-10 of the CPU's, its CG count equal.
"""

import numpy as np
import pytest
import torch

from frontistr_tpu_torch.assembly import bell
from frontistr_tpu_torch.assembly import segsum as sm
from frontistr_tpu_torch.meshgen import plate_shell

from _torch_shell_decks import beam_line, deck, warped_plate

TOL = {torch.float32: 1e-4, torch.float64: 1e-12}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the K1 kernel has no CPU mode)")
    return torch.device("cuda")


def _mesh(m):
    if m == 12:
        return beam_line(611, ne=300)
    return plate_shell({18: 30, 24: 40, 54: 20}[m],
                       etype={18: 731, 24: 741, 54: 743}[m])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [12, 18, 24, 54])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nd6_kernel_matches_plain_on_card(cuda_device, m, dtype):
    mesh = _mesh(m)
    conn = mesh.blocks[0].conn
    nn = conn.shape[1]
    prof = bell.build_cluster_profile([conn], mesh.n_node, 6)
    plan = prof.plan(cuda_device)
    ke = torch.as_tensor(np.random.default_rng(m).standard_normal(
        (len(conn), m, m)), dtype=dtype, device=cuda_device)
    want = sm.segsum_reference(plan, [ke], [nn], 6)
    n0 = sm.segsum.launches
    got = sm.segsum(plan, [ke], [nn], 6)
    again = sm.segsum(plan, [ke], [nn], 6)
    assert sm.segsum.launches == n0 + 2
    assert got.shape == want.shape == (36, prof.n_slots)
    assert float((got - want).abs().max()) <= \
        TOL[dtype] * float(want.abs().max())
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("etype", [731, 741, 611])
def test_small_static_card_matches_cpu(cuda_device, tmp_path, monkeypatch,
                                       etype):
    """A warped plate under pressure and a beam under a tip load, f64
    policy, on the card and the CPU: u within 1e-10 relative, CG equal,
    and the card's run launched K1 at nd = 6."""
    from frontistr_tpu_torch.io.neu import write_static_workdir
    from frontistr_tpu_torch.run import run_directory
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", "f64")
    if etype == 611:
        # the 611 deck of tests/test_beam.py, four elements (a 20-element
        # line at RESID 1e-8 took 81 CG on the card and 83 on the CPU:
        # its axial and bending stiffnesses are decades apart, and the
        # two devices' rounding moves the crossing of RESID)
        mesh, groups = beam_line(611), ("FIX", "TIP")
        cnt = deck(bc=" FIX, 1, 6, 0.0\n",
                   loads="!CLOAD\n TIP, 3, -1.0\n TIP, 4, 2.0\n",
                   resid="1.0e-12")
    else:
        mesh, groups = warped_plate(12, etype), ("EDGE",)
        cnt = deck(loads="!DLOAD\n ALL, P0, 0.01\n ALL, BX, 0.001\n")
    out = {}
    for dev in ("cpu", "cuda"):
        wd = str(tmp_path / dev)
        write_static_workdir(wd, mesh, cnt, ngroups=groups)
        n0 = sm.segsum.launches
        out[dev] = run_directory(wd, device=dev)["static"]
        if dev == "cuda":
            assert sm.segsum.launches > n0
    a, b = out["cuda"], out["cpu"]
    assert a.iters == b.iters
    assert np.abs(a.u - b.u).max() <= 1e-10 * np.abs(b.u).max()
