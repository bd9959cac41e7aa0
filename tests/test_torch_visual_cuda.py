"""The pictures and the input formats on the card: the PVR render's voxel
grid and float image on the card against the CPU (the same host splat,
the sweeps and the composite in float64 on each), and a small ABAQUS deck
refined on load through ``run_directory`` with ``!WRITE, VISUAL`` (PVR)
on the card against the CPU.  The file imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_visual_cuda.py

Every test skips, inside the test, where ``torch.cuda.is_available()`` is
false.  Tolerances: the grid and the image within 1e-12 (of the largest);
the displacements within 1e-8 of the largest; the BMPs within one level
a byte, at most 0.1% of the pixels further apart.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from frontistr_tpu_torch.meshgen import box_hex8, box_tet4
from frontistr_tpu_torch.run import run_directory
from frontistr_tpu_torch.vis import psf, pvr

from _torch_vis_decks import CNT, FAR_SHARE, VISUAL, abaqus_workdir


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_pvr_card_matches_cpu(cuda_device):
    mesh = box_hex8(6, 5, 4)
    rng = np.random.default_rng(2)
    coords = mesh.coords + 0.02 * rng.standard_normal(mesh.coords.shape)
    vals = np.sin(3.0 * coords[:, 0]) + coords[:, 2] ** 2
    g, m, _, _ = pvr.voxelize(coords, vals, res=48, device=cuda_device)
    gc, mc, _, _ = pvr.voxelize(coords, vals, res=48, device="cpu")
    assert g.is_cuda and g.dtype == torch.float64
    assert float((g.cpu() - gc).abs().max()) <= 1e-12 * float(gc.abs().max())
    assert torch.equal(m.cpu(), mc)
    img = pvr.render_image(coords, vals, 200, 150, res=48, n_steps=120,
                           device=cuda_device)
    ref = pvr.render_image(coords, vals, 200, 150, res=48, n_steps=120,
                           device="cpu")
    assert img.is_cuda and img.shape == (150, 200, 3)
    assert float((img.cpu() - ref).abs().max()) <= 1e-12


@pytest.mark.cuda
def test_refined_abaqus_picture_card_matches_cpu(cuda_device, tmp_path):
    cnt = CNT.format(sol="STATIC", extra=VISUAL.format(
        freq="", method="PVR", more=""))
    wd = abaqus_workdir(str(tmp_path / "card"), box_tet4(4, 3, 3), cnt,
                        refine=1)
    wc = str(tmp_path / "cpu")
    shutil.copytree(wd, wc)
    a, b = run_directory(wd, device="cuda"), run_directory(wc, device="cpu")
    assert a["mesh"].n_elem == b["mesh"].n_elem == 8 * 6 * 36
    u, uc = a["static"].u, b["static"].u
    assert np.abs(u - uc).max() <= 1e-8 * np.abs(uc).max()
    a, b = os.path.join(wd, "result.bmp"), os.path.join(wc, "result.bmp")
    assert psf.bmp_stats(a)["shape"] == (96, 96)
    d = psf.bmp_diff(a, b)
    assert d["far"] <= FAR_SHARE * d["pixels"], d
