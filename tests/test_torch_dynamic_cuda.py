"""The dynamics slice on the card: small explicit and implicit decks
through ``run_directory`` on the card and on the CPU, and the explicit
step loop under ``torch.cuda.set_sync_debug_mode("error")``, which
raises on any operation that waits for the device inside it.  The file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_dynamic_cuda.py

Every test skips, inside the test, where ``torch.cuda.is_available()``
is false.  Bars: u, v, a within 1e-12 of each field's largest magnitude
(the card's reductions sum in other orders; the implicit deck solves to
RESID 1e-14, so a CG count one apart stays below the bar), Newton
iterations per step equal, CG counts within one.
"""

import numpy as np
import pytest
import torch

from frontistr_tpu_torch.analysis import dynamic as dyn
from frontistr_tpu_torch.meshgen import box_hex8, box_tet4
from frontistr_tpu_torch.run import run_directory

from _torch_decks import dyn_deck, tet10_box, write_deck

RAMP = [(0.0, 0.0), (4.0e-8, 1.0), (1.0e-7, 1.0)]
EXPLICIT = ("!CLOAD, AMP=RAMP\n X1, 3, -1.0\n!VELOCITY, TYPE=INITIAL\n"
            " X1, 1, 1, 0.5\n!VELOCITY, AMP=RAMP\n Z1, 3, 3, -0.5\n"
            "!ACCELERATION\n Z0, 1, 1, 2.0e6\n")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _no_sync_loop(monkeypatch):
    """Make the step loop (from the step clock's start to its read-out)
    raise on any host synchronisation."""
    real = dyn._StepClock

    class Strict(real):
        def __init__(self, *a):
            super().__init__(*a)
            torch.cuda.set_sync_debug_mode("error")

        def block_ms(self):
            torch.cuda.set_sync_debug_mode(0)
            return super().block_ms()
    monkeypatch.setattr(dyn, "_StepClock", Strict)


def _both(tmp_path, mesh, cnt, monkeypatch=None):
    out = []
    for dev in ("cuda", "cpu"):
        wd = write_deck(tmp_path / dev, mesh, cnt,
                        amplitudes={"RAMP": RAMP})
        if monkeypatch is not None and dev == "cuda":
            with monkeypatch.context() as mp:
                _no_sync_loop(mp)
                out.append(run_directory(wd, device=dev)["dynamic"])
        else:
            out.append(run_directory(wd, device=dev)["dynamic"])
    return out


def _rel(a, b):
    assert a.shape == b.shape and np.isfinite(a).all()
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.cuda
@pytest.mark.parametrize("etype", [341, 342, 361])
def test_explicit_loop_has_no_host_sync(tmp_path, monkeypatch, cuda_device,
                                        etype):
    """Initial and prescribed velocity, prescribed acceleration, a load
    under an amplitude and a monitor node: the card's step loop runs
    under sync-debug mode "error" and agrees with the CPU run."""
    mesh = {341: lambda: box_tet4(4, 3, 3), 342: lambda: tet10_box(2, 2, 1),
            361: lambda: box_hex8(4, 3, 3)}[etype]()
    monit = int(mesh.node_ids[mesh.node_groups["X1"][-1]])
    g, c = _both(tmp_path, mesh, dyn_deck(11, n_step=30, dt=2e-9,
                                          loads=EXPLICIT, monit=monit,
                                          every=3), monkeypatch)
    assert g.arm == c.arm == "explicit"
    for f in ("u", "vel", "acc"):
        assert _rel(getattr(g, f), getattr(c, f)) <= 1e-12, f
    for k in ("disp", "velo", "acce"):
        assert _rel(g.monitors[k], c.monitors[k]) <= 1e-12, k


@pytest.mark.cuda
@pytest.mark.parametrize("typ", ["", ", TYPE=NONLINEAR"])
def test_implicit_card_matches_cpu(tmp_path, cuda_device, typ):
    """Newmark with Rayleigh damping on hex8: the linear step train (IC)
    and the Newton loop (B-bar, finite strain)."""
    g, c = _both(tmp_path, box_hex8(4, 3, 3), dyn_deck(
        1, n_step=4, dt=1.0e-7, ray_m=1.0e4, ray_k=1.0e-8, typ=typ,
        resid="1.0e-14", loads="!CLOAD, AMP=RAMP\n X1, 3, -2000.0\n"))
    assert g.arm == c.arm == ("newton" if typ else "linear")
    for f in ("u", "vel", "acc"):
        assert _rel(getattr(g, f), getattr(c, f)) <= 1e-12, f
    assert [h["newton"] for h in g.history] == \
        [h["newton"] for h in c.history]
    cg = [[x for h in r.history for x in h["cg"]] for r in (g, c)]
    assert len(cg[0]) == len(cg[1])
    assert all(abs(a - b) <= 1 for a, b in zip(*cg))
