"""The slice of the u-p flow element, the band Cholesky and the mesh
checks on the card: K1's nd = 4 element entry against its plain version
on random matrices with no symmetry at the flow path's scalar-ELL plan
and at a cluster plan, float32 and float64, launched twice and
bit-equal; a small lid-driven cavity through ``run_directory`` on the
card against the CPU; the band factor and solve on the card against the
CPU, and a band EIGEN deck.  The file imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_flow_cuda.py

Every test skips, inside the test, where ``torch.cuda.is_available()`` is
false: the kernel has no CPU mode.  Tolerances: float32 within
1e-4 x max|plain|, float64 within 1e-12 x max|plain|; the card's fields
within 1e-8 of the CPU's (the BiCGSTAB answers differ by the solver's
tolerance, not by rounding alone), the band's within 1e-10.
"""

import numpy as np
import pytest
import torch

from frontistr_tpu_torch.assembly import bell, ell
from frontistr_tpu_torch.assembly import segsum as sm
from frontistr_tpu_torch.io.neu import write_static_workdir
from frontistr_tpu_torch.meshgen import box_hex8
from frontistr_tpu_torch.run import run_directory
from frontistr_tpu_torch.solver import band

from _torch_flow_decks import WALLS, cavity_cnt, flow_mesh

TOL = {torch.float32: 1e-4, torch.float64: 1e-12}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the K1 kernel has no CPU mode)")
    return torch.device("cuda")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.cuda
@pytest.mark.parametrize("profile", ["ell", "cluster"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nd4_kernel_matches_plain_on_card(cuda_device, profile, dtype):
    mesh = flow_mesh(8)
    conn = np.asarray(mesh.blocks[0].conn, np.int64)
    prof = (ell.build_profile if profile == "ell" else
            bell.build_cluster_profile)([conn], mesh.n_node, 4)
    plan = prof.plan(cuda_device)
    ke = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (len(conn), 16, 16)), dtype=dtype, device=cuda_device)
    want = sm.segsum_reference(plan, [ke], [4], 4)
    n0 = sm.segsum.launches
    got = sm.segsum(plan, [ke], [4], 4)
    again = sm.segsum(plan, [ke], [4], 4)
    assert sm.segsum.launches == n0 + 2
    assert got.shape == want.shape == (16, prof.n_slots)
    err = float((got - want).abs().max())
    assert err <= TOL[dtype] * float(want.abs().max())
    assert torch.equal(got, again)


def _cavity(path, n=4):
    wd = str(path)
    write_static_workdir(wd, flow_mesh(n), cavity_cnt(mu=0.01, dt=0.25),
                         ngroups=WALLS)
    return wd


@pytest.mark.cuda
def test_cavity_card_matches_cpu(cuda_device, tmp_path):
    wd = _cavity(tmp_path / "wd")
    n0, p0 = sm.segsum.launches, sm.segsum_planes.launches
    a = run_directory(wd, device="cuda")["flow"]
    k1, planes = sm.segsum.launches - n0, sm.segsum_planes.launches - p0
    b = run_directory(wd, device="cpu")["flow"]
    assert k1 == planes == a.steps == 2
    for x, y in ((a.v, b.v), (a.strain, b.strain), (a.stress, b.stress)):
        assert _rel(x, y) <= 1e-8
    for ha, hb in zip(a.history, b.history):
        assert len(ha["bicgstab"]) == len(hb["bicgstab"])
        for p, q in zip(ha["bicgstab"], hb["bicgstab"]):
            assert abs(p - q) <= 2


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [8, 32])
def test_band_factor_card_matches_cpu(cuda_device, nb):
    mesh = box_hex8(4, 3, 3)
    conn = mesh.blocks[0].conn.astype(np.int64)
    rng = np.random.default_rng(nb)
    a = rng.standard_normal((len(conn), 24, 24))
    kes = a @ a.transpose(0, 2, 1) + 24 * np.eye(24)
    dofs = (conn[:, :, None] * 3 + np.arange(3)).reshape(-1, 24)
    n = mesh.n_node * 3
    free = np.ones(n)
    free[:12] = 0.0
    rhs = rng.standard_normal(n)
    x = []
    for dev in (cuda_device, torch.device("cpu")):
        fac = band.BandCholesky([torch.as_tensor(kes, device=dev)], [dofs],
                                n, free, [conn], mesh.n_node, nb=nb,
                                scale=0.5, diag_add=np.full(n, 2.0))
        x.append(fac.solve(torch.as_tensor(rhs, device=dev)).cpu().numpy())
        if dev.type == "cuda":
            # the captured sweeps: a second right-hand side, then the
            # first again, bit-equal to the first solve and to eager
            other = fac.solve(torch.as_tensor(rhs[::-1].copy(), device=dev))
            again = fac.solve(torch.as_tensor(rhs, device=dev)).cpu().numpy()
            bp = torch.zeros(fac.nblk * fac.nb, dtype=torch.float64,
                             device=dev)
            bp[fac.perm] = torch.as_tensor(rhs, device=dev)
            eager = band._solve(fac.Lrow, fac.Linv, bp)[fac.perm]
            assert np.array_equal(again, x[0])
            assert np.array_equal(eager.cpu().numpy(), x[0])
            assert not np.array_equal(other.cpu().numpy(), x[0])
    assert _rel(x[0], x[1]) <= 1e-10


@pytest.mark.cuda
def test_band_eigen_card_matches_cpu(cuda_device, tmp_path, monkeypatch):
    monkeypatch.setenv("FRONTISTR_TPU_DIRECT", "band")
    mesh = box_hex8(4, 2, 2, lx=400.0, ly=100.0, lz=70.0)
    cnt = ("!VERSION\n 3\n!SOLUTION, TYPE=EIGEN\n!EIGEN\n 3, 1.0e-8, 60\n"
           "!BOUNDARY\n X0, 1, 3, 0.0\n!MATERIAL, NAME=M1\n!ELASTIC\n"
           " 210000.0, 0.3\n!DENSITY\n 7.85e-9\n"
           "!SOLVER, METHOD=DIRECT, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
           " 1.0e-10, 1.0, 0.0\n!END\n")
    wd = str(tmp_path / "wd")
    write_static_workdir(wd, mesh, cnt)
    a = run_directory(wd, device="cuda")["eigen"]
    b = run_directory(wd, device="cpu")["eigen"]
    assert a.iters == b.iters and a.factor["band"] == b.factor["band"]
    assert _rel(a.eigenvalues, b.eigenvalues) <= 1e-10
