"""!RESTART in the Newton driver and the two checkpoint formats, held to
the JAX package on the CPU.

- ``io/restart.py``: an ``.npz`` either package writes loads in the
  other, nested dicts, lists, None and empty containers included.
- ``io/hecmw_restart.py``: the reference's blob stream written by the
  port equals the JAX package's byte for byte, and each reads the
  other's.
- NLSTATIC on a hex8 B-bar box under a follower pressure, Mises
  plasticity yielding in the second substep: a run interrupted after
  substep 1 (the step time and the load halved, so its one substep is
  the full run's first, bit for bit) writes a checkpoint
  (FREQUENCY=1); the full deck resumed from it (FREQUENCY=-1) gives the
  uninterrupted run's u and committed plastic states bit for bit, and
  the JAX package's resumed run within 1e-8, with equal Newton counts;
  in the ``.npz`` and in the blob format
  (FRONTISTR_TPU_RESTART_FORMAT=hecmw).

Implicit dynamics and transient heat: tests/test_torch_restart_dyn.py.
"""

import os
import shutil

import numpy as np
import pytest

import frontistr_tpu.run as jrun
from frontistr_tpu.io import hecmw_restart as jhr
from frontistr_tpu.io import restart as jrs
from frontistr_tpu_torch.io import hecmw_restart as hr
from frontistr_tpu_torch.io import restart as rs
from frontistr_tpu_torch.meshgen import box_hex8
from frontistr_tpu_torch.run import run_directory

from _torch_decks import deck, write_deck

MISES = "!PLASTIC, YIELD=MISES, HARDEN=LINEAR\n 250.0, 1000.0\n"
HALF_STEP = ("!STEP, SUBSTEPS=2\n", "!STEP, SUBSTEPS=2\n 0.5, 0.5\n")


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", "f64")
    monkeypatch.setenv("FRONTISTR_TPU_REORDER", "1")
    return monkeypatch


def _payload():
    rng = np.random.default_rng(4)
    return dict(u=rng.standard_normal(12), t=np.asarray(0.5),
                step_count=np.asarray(3),
                states=[dict(stress=rng.standard_normal((2, 8, 6)),
                             yielded=rng.random((2, 8)) > 0.5), {}],
                cm=dict(lam=rng.standard_normal(4), rel_prev=None,
                        slag_released=np.zeros(4, np.int8)), extra=[])


def _same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif a is None:
        assert b is None
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_interchange(tmp_path, writer):
    p = str(tmp_path / "ck.npz")
    save, load = (rs.save_restart, jrs.load_restart) if writer == "port" \
        else (jrs.save_restart, rs.load_restart)
    save(p, _payload())
    _same(_payload(), load(p))
    with np.load(p) as z:
        keys = set(z.files)
    q = str(tmp_path / "ref.npz")
    jrs.save_restart(q, _payload())
    with np.load(q) as z:
        assert keys == set(z.files)


def test_blob_bytes_equal(tmp_path):
    """The blob stream of a plastic state (strain, stress, plastic
    strain and yield flags by gauss point): the same bytes from both
    writers, and each reader returns the other's state."""
    rng = np.random.default_rng(5)
    mesh = box_hex8(2, 1, 1)
    st = [dict(strain=rng.standard_normal((2, 8, 6)),
               stress=rng.standard_normal((2, 8, 6)),
               pstrain=np.abs(rng.standard_normal((2, 8))),
               yielded=rng.random((2, 8)) > 0.5)]
    u, q = rng.standard_normal(36), rng.standard_normal(36)
    kw = dict(step_count=3, ctime=0.75, dtime=0.25, steptime=0.75)
    pa, pb = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    hr.export_solid_state(pa, u, q, st, mesh.blocks, **kw)
    jhr.export_solid_state(pb, u, q, st, mesh.blocks, **kw)
    with open(pa, "rb") as fa, open(pb, "rb") as fb:
        assert fa.read() == fb.read()
    zero = [{k: np.zeros_like(v) for k, v in st[0].items()}]
    for path, imp in ((pa, jhr.import_solid_state),
                      (pb, hr.import_solid_state)):
        u2, t2, sc2, st2 = imp(path, zero, mesh.blocks)
        assert np.array_equal(u2, u) and (t2, sc2) == (0.75, 3)
        for k in st[0]:
            assert np.array_equal(np.asarray(st2[0][k]), st[0][k])


def _plastic_workdir(path, cnt):
    return write_deck(path, box_hex8(4, 3, 3), cnt)


def _set_deck(wd, cnt):
    with open(os.path.join(wd, "case.cnt"), "w") as fh:
        fh.write(cnt)


def _host(states):
    return [{k: np.asarray(v) for k, v in s.items()} for s in states]


def _resume(wd, full, half, run):
    """The interrupted run (half the load in half the step time, a
    checkpoint after its one substep), then the full deck resumed from
    it (a checkpoint after its one substep, the second of the step);
    returns the resumed run's output."""
    _set_deck(wd, half.replace("!END\n", "!RESTART, FREQUENCY=1\n!END\n"))
    run(wd)
    assert os.path.exists(os.path.join(wd, "restart.npz"))
    _set_deck(wd, full.replace("!END\n", "!RESTART, FREQUENCY=-1\n!END\n"))
    return run(wd)


def _checkpoint(wd, fmt):
    p = os.path.join(wd, "restart.npz")
    return rs.load_restart(p) if fmt == "npz" else hr.read_fstr_restart(p)


@pytest.mark.parametrize("fmt", ["npz", "hecmw"])
def test_nlstatic_resume_matches_uninterrupted(tmp_path, env, fmt):
    """The uninterrupted run writes a checkpoint every substep; its last
    (u and every gauss point's committed state) equals, bit for bit,
    the one the resumed run writes after the same substep."""
    if fmt == "hecmw":
        env.setenv("FRONTISTR_TPU_RESTART_FORMAT", "hecmw")
    full = deck(loads="!DLOAD\n TOP, P2, 120.0\n", plastic=MISES, sub=2)
    half = deck(loads="!DLOAD\n TOP, P2, 60.0\n", plastic=MISES,
                sub=2).replace(*HALF_STEP)
    wd = _plastic_workdir(tmp_path / "port",
                          full.replace("!END\n",
                                       "!RESTART, FREQUENCY=1\n!END\n"))
    wj = str(tmp_path / "jax")
    shutil.copytree(wd, wj)
    once = run_directory(wd, device="cpu")["static"]
    ck_once = _checkpoint(wd, fmt)
    got = _resume(wd, full, half,
                  lambda d: run_directory(d, device="cpu"))["static"]
    want = _resume(wj, full, half, jrun.run_directory)["static"]
    ck_got = _checkpoint(wd, fmt)
    if fmt == "npz":
        st = ck_got["states"][0]
        assert st["yielded"].any() and st["pstrain"].max() > 0
    else:
        assert any("istatus" in g for g in ck_got["gauss"])
    # resumed = uninterrupted, bit for bit, in the port
    assert np.array_equal(got.u, once.u)
    assert np.array_equal(got.elem_stress, once.elem_stress)
    _same(ck_got, ck_once)
    assert got.newton.substeps == 1 and once.newton.substeps == 2
    last = [h for h in once.newton.history if h["substep"] == 2]
    assert len(got.newton.history) == len(last) == got.iters
    # the JAX package's resumed run
    uj = np.asarray(want.u)
    assert np.abs(got.u - uj).max() <= 1e-8 * np.abs(uj).max()
    sj = np.asarray(want.elem_stress)
    assert np.abs(got.elem_stress - sj).max() <= 1e-8 * np.abs(sj).max()
    assert got.iters == int(want.iters) >= 2
