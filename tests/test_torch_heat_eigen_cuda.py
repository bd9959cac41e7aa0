"""The heat, eigen, frequency-response and STATICEIGEN slices on the
card: small decks through ``run_directory`` on the card and on the CPU
(which ``test_torch_heat.py`` and ``test_torch_eigen.py`` hold to the
JAX package), STATICEIGEN's K1 launches held to K1's plain version, and
a heat transient run twice on the card.  The file imports nothing of
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_heat_eigen_cuda.py

Every test skips, inside the test, where ``torch.cuda.is_available()``
is false.  Bars: temperatures, eigenvalues and frequency-response
amplitudes within 1e-10 of the largest, static displacements within
1e-8 (the bar of the plastic slice's card tests);
fixed-point, Lanczos and Newton iterations equal; CG counts within one
per solve; a heat transient run twice on the card bit-equal (the
capacity and film sums go through the incidence in a fixed order).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from frontistr_tpu_torch.analysis import static as stmod
from frontistr_tpu_torch.analysis import nonlinear as nl
from frontistr_tpu_torch.assembly import segsum as sm
from frontistr_tpu_torch.meshgen import box_hex8, box_tet4
from frontistr_tpu_torch.run import run_directory

from _torch_decks import heat_deck, heat_mesh, write_deck, write_heat_deck

EIGEN = ("!VERSION\n 3\n!SOLUTION, TYPE={sol}\n!EIGEN\n 5, 1.0e-8, 60\n"
         "!BOUNDARY\n X0, 1, 3, 0.0\n{loads}!MATERIAL, NAME=M1\n!ELASTIC\n"
         " 210000.0, 0.3\n!DENSITY\n 7.85e-9\n{step}"
         "!SOLVER, METHOD=CG, PRECOND=1, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
         " 1.0e-10, 1.0, 0.0\n!WRITE, RESULT\n!END\n")
FREQ = ("!VERSION\n 3\n!SOLUTION, TYPE=DYNAMIC\n!DYNAMIC\n 11, 2\n"
        " {f0!r}, {f1!r}, 30, 1.0\n 0.5, 0.25\n 1, 1, 3.0, 2.0e-6\n"
        "!EIGENREAD\n eigen.log\n 1, 5\n!BOUNDARY\n X0, 1, 3, 0.0\n"
        "!FLOAD, LOAD CASE=1\n X1, 3, 1.0\n!MATERIAL, NAME=M1\n!ELASTIC\n"
        " 210000.0, 0.3\n!DENSITY\n 7.85e-9\n!SOLVER, METHOD=CG, PRECOND=1,"
        " ITERLOG=NO, TIMELOG=NO\n 10000, 1\n 1.0e-10, 1.0, 0.0\n!END\n")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _both(tmp_path, write):
    """run_directory of the deck ``write(path)`` writes, on the card and
    on the CPU."""
    outs = []
    for dev in ("cuda", "cpu"):
        outs.append(run_directory(write(tmp_path / dev), device=dev))
    return outs


def _cg_close(a, b):
    return len(a) == len(b) and all(abs(x - y) <= 1 for x, y in zip(a, b))


HEAT_RUNS = [("hex8", True, True), ("tet10", False, False),
             ("quad", True, False), ("tri", False, False),
             ("iface", True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,transient,weld", HEAT_RUNS)
def test_heat_card_matches_cpu(tmp_path, cuda_device, kind, transient,
                               weld):
    mesh = heat_mesh(kind)
    cnt = heat_deck(mesh, transient=transient, weld=weld)
    g, c = _both(tmp_path, lambda p: write_heat_deck(p, mesh, cnt))
    hg, hc = g["heat"], c["heat"]
    assert (hg.steps, hg.iters) == (hc.steps, hc.iters)
    assert [h["fp"] for h in hg.history] == [h["fp"] for h in hc.history]
    assert _cg_close([x for h in hg.history for x in h["cg"]],
                     [x for h in hc.history for x in h["cg"]])
    assert _rel(hg.T, hc.T) <= 1e-10


@pytest.mark.cuda
def test_heat_transient_bit_equal_twice(tmp_path, cuda_device):
    mesh = heat_mesh("hex8")
    cnt = heat_deck(mesh, transient=True, weld=True)
    T = [run_directory(write_heat_deck(tmp_path / str(k), mesh, cnt),
                       device="cuda")["heat"].T for k in range(2)]
    assert np.array_equal(T[0], T[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mk", [box_tet4, box_hex8])
def test_eigen_card_matches_cpu(tmp_path, cuda_device, mk):
    mesh = mk(4, 2, 2, lx=4.0, ly=1.0, lz=0.6)
    cnt = EIGEN.format(sol="EIGEN", loads="", step="")
    g, c = _both(tmp_path, lambda p: write_deck(p, mesh, cnt))
    eg, ec = g["eigen"], c["eigen"]
    assert eg.iters == ec.iters
    assert _rel(eg.eigenvalues, ec.eigenvalues) <= 1e-10
    assert _cg_close([h["cg"] for h in eg.history],
                     [h["cg"] for h in ec.history])


@pytest.mark.cuda
def test_frequency_response_card_matches_cpu(tmp_path, cuda_device):
    mesh = box_hex8(4, 2, 2, lx=4.0, ly=1.0, lz=0.6)
    wd = write_deck(tmp_path / "eigen", mesh,
                    EIGEN.format(sol="EIGEN", loads="", step=""))
    fq = run_directory(wd, device="cpu")["eigen"].freq
    shutil.copy(os.path.join(wd, "0.log"), os.path.join(wd, "eigen.log"))
    with open(os.path.join(wd, "case.cnt"), "w") as f:
        f.write(FREQ.format(f0=0.5 * fq[0], f1=1.5 * fq[2]))
    wc = str(tmp_path / "cpu")
    shutil.copytree(wd, wc)
    g = run_directory(wd, device="cuda")["freq"]
    c = run_directory(wc, device="cpu")["freq"]
    for f in ("disp_amp_max", "vel_amp_max", "acc_amp_max", "disp_re",
              "disp_im"):
        assert _rel(getattr(g, f), getattr(c, f)) <= 1e-10


@pytest.mark.cuda
def test_static_eigen_card_matches_cpu_and_k1(tmp_path, cuda_device,
                                              monkeypatch):
    """STATICEIGEN on tet4: K1's element entry launched once per Newton
    iteration on the card, and held to its plain version at the run's
    cluster plan with the converged tangent."""
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", "f64")
    mesh = box_tet4(4, 2, 2, lx=4.0, ly=1.0, lz=0.6)
    cnt = EIGEN.format(sol="STATICEIGEN", loads="!CLOAD\n X1, 3, -20.0\n",
                       step="!STEP, SUBSTEPS=2, CONVERG=1.0e-8\n")
    sm.segsum.launches = 0
    g = run_directory(write_deck(tmp_path / "cuda", mesh, cnt),
                      device="cuda")
    launches = sm.segsum.launches
    c = run_directory(write_deck(tmp_path / "cpu", mesh, cnt), device="cpu")
    nw = g["static"].newton
    assert launches == nw.total_iters > 0
    assert [h["iter"] for h in nw.history] == \
        [h["iter"] for h in c["static"].newton.history]
    assert _rel(g["static"].u, c["static"].u) <= 1e-8
    assert g["eigen"].iters == c["eigen"].iters
    assert _rel(g["eigen"].eigenvalues, c["eigen"].eigenvalues) <= 1e-10
    model = g["model"]
    u = torch.as_tensor(np.asarray(g["static"].u).reshape(-1),
                        device="cuda")
    kes = []
    for b in model.blocks:
        p = nl.BlockPrograms(model, b)
        u_e = nl._element_values(u, p, model.n_node, model.ndof)
        s, _ = p.update(u_e * 0.0, u_e, nl.init_block_state(b, p.table,
                                                            "cuda"))
        kes.append(p.tangent(u_e, u_e * 0.0, s))
    plan = stmod.cluster_setup(model, {}).cprof.plan("cuda")
    nns = [b.conn.shape[1] for b in model.blocks]
    got = sm.segsum(plan, kes, nns, 3)
    want = sm.segsum_reference(plan, kes, nns, 3)
    assert float((got - want).abs().max()) <= \
        1e-12 * float(want.abs().max())


@pytest.mark.cuda
def test_heat_readresult_card_matches_cpu(tmp_path, cuda_device,
                                          monkeypatch):
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", "f64")
    mesh = heat_mesh("hex8")
    static = ("!VERSION\n 3\n!SOLUTION, TYPE=STATIC\n!BOUNDARY\n"
              " X0, 1, 3, 0.0\n!TEMPERATURE, READRESULT=1, SSTEP=1\n"
              "!REFTEMP\n 20.0\n!MATERIAL, NAME=M1\n!ELASTIC\n"
              " 210000.0, 0.3\n!EXPANSION_COEFF\n 1.2e-5\n"
              "!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
              " 1.0e-10, 1.0, 0.0\n!END\n")

    def write(p):
        wd = write_heat_deck(p, mesh, heat_deck(mesh, transient=False,
                                                write="!WRITE, RESULT\n"))
        run_directory(wd, device="cpu")
        with open(os.path.join(wd, "case.cnt"), "w") as f:
            f.write(static)
        with open(os.path.join(wd, "hecmw_ctrl.dat"), "a") as f:
            f.write("!RESULT, NAME=fstrTEMP, IO=IN\n mesh.res\n")
        return wd
    g, c = _both(tmp_path, write)
    assert _rel(g["static"].u, c["static"].u) <= 1e-8
