"""The deck's solver menu and !RESTART on the card, against the same
decks on the CPU: linear STATIC by BiCGSTAB, GMRES and GPBiCG on a
shuffled tet4 box (K1 summing the scalar-ELL blocks once), NLSTATIC with
PRECOND=10 (multicolor block SSOR), and an NLSTATIC plastic run
interrupted after its first substep and resumed.  The file imports
nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_solvers_cuda.py

Every test skips, inside the test, where ``torch.cuda.is_available()`` is
false.  Bars: u within 1e-8 of max|u|, Newton counts equal, Krylov
counts within 1; the resumed run bit-equal to the uninterrupted one on
the card.
"""

import os

import numpy as np
import pytest
import torch

from frontistr_tpu_torch.assembly import segsum as sm
from frontistr_tpu_torch.meshgen import box_hex8, box_tet4
from frontistr_tpu_torch.run import run_directory

from _torch_decks import deck, write_deck

CNT = ("!VERSION\n 3\n!SOLUTION, TYPE={sol}\n!BOUNDARY\n X0, 1, 3, 0.0\n"
       "!CLOAD\n X1, 3, -100.0\n!MATERIAL, NAME=M1\n!ELASTIC\n"
       " 210000.0, 0.3\n!STEP, SUBSTEPS=1\n BOUNDARY, 1\n LOAD, 1\n"
       "!SOLVER, METHOD={method}, PRECOND={precond}, ITERLOG=NO, "
       "TIMELOG=NO\n 10000, 1\n 1.0e-8, 1.0, 0.0\n!END\n")
MISES = "!PLASTIC, YIELD=MISES, HARDEN=LINEAR\n 250.0, 1000.0\n"


@pytest.fixture
def cuda_env(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", "f64")
    monkeypatch.setenv("FRONTISTR_TPU_REORDER", "1")
    return monkeypatch


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.isfinite(a).all()
    assert np.abs(a - b).max() <= 1e-8 * np.abs(b).max()


def _both(tmp_path, mesh, cnt):
    outs = []
    for dev in ("cuda", "cpu"):
        wd = write_deck(tmp_path / dev, mesh, cnt)
        before = sm.segsum.launches
        outs.append((run_directory(wd, device=dev)["static"],
                     sm.segsum.launches - before))
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["BICGSTAB", "GMRES", "GPBICG"])
def test_methods_card_vs_cpu(tmp_path, cuda_env, method):
    (card, k1), (cpu, k1_cpu) = _both(
        tmp_path, box_tet4(8, 6, 5),
        CNT.format(sol="STATIC", method=method, precond=1))
    assert k1 == 1 and k1_cpu == 0
    _close(card.u, cpu.u)
    assert abs(card.iters - cpu.iters) <= 1 and card.policy == "f64"


@pytest.mark.cuda
def test_ssor_nlstatic_card_vs_cpu(tmp_path, cuda_env):
    (card, k1), (cpu, _) = _both(
        tmp_path, box_tet4(8, 6, 5),
        CNT.format(sol="NLSTATIC", method="CG", precond=10))
    assert card.iters == cpu.iters >= 2 and k1 == card.iters
    for a, b in zip(card.newton.history, cpu.newton.history):
        assert abs(a["cg_iters"] - b["cg_iters"]) <= 1
        assert a["relres"] <= 1e-8
    _close(card.u, cpu.u)


def _set_deck(wd, cnt):
    with open(os.path.join(wd, "case.cnt"), "w") as fh:
        fh.write(cnt)


@pytest.mark.cuda
def test_restart_round_trip_card(tmp_path, cuda_env):
    """The plastic deck (yielding in substep 2) run whole, and
    interrupted after substep 1 (half the pressure in half the step
    time) then resumed, on the card; the CPU's resumed run beside."""
    full = deck(loads="!DLOAD\n TOP, P2, 120.0\n", plastic=MISES, sub=2)
    half = deck(loads="!DLOAD\n TOP, P2, 60.0\n", plastic=MISES,
                sub=2).replace("!STEP, SUBSTEPS=2\n",
                               "!STEP, SUBSTEPS=2\n 0.5, 0.5\n")
    mesh = box_hex8(6, 5, 4)
    once = run_directory(write_deck(tmp_path / "once", mesh, full),
                         device="cuda")["static"]
    res = {}
    for dev in ("cuda", "cpu"):
        wd = write_deck(tmp_path / f"r_{dev}", mesh, half.replace(
            "!END\n", "!RESTART, FREQUENCY=1\n!END\n"))
        run_directory(wd, device=dev)
        _set_deck(wd, full.replace("!END\n",
                                   "!RESTART, FREQUENCY=-1\n!END\n"))
        res[dev] = run_directory(wd, device=dev)["static"]
    assert np.array_equal(res["cuda"].u, once.u)
    assert np.array_equal(res["cuda"].elem_stress, once.elem_stress)
    _close(res["cuda"].u, res["cpu"].u)
    assert res["cuda"].iters == res["cpu"].iters >= 2
