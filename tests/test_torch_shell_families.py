"""Shells beyond linear STATIC, the port against the JAX package on the
CPU, on the shell cantilever strip of ``tests/test_shell_dynamics.py``
(MITC4, 2 x 0.25, t 0.1, E 1e6, rho 1, clamped at x = 0): NLSTATIC in two
substeps (the constant tangent and qf = ke u of the Newton driver),
implicit Newmark DYNAMIC, EIGEN (eigenvalues within 1e-8, mass-normalised
vectors up to sign; zero rotary inertia, the rotations kept in K),
STATICEIGEN and the frequency response; the explicit refusal of 6-dof models with the JAX package's
message; and a !RESTART round trip of the NLSTATIC deck (interrupted
after substep 1, resumed: the uninterrupted u bit for bit, the JAX
package's resumed run within 1e-8)."""

import shutil

import numpy as np
import pytest

from frontistr_tpu_torch.run import run_directory

from _torch_shell_decks import deck, rel, run_both, strip

BC = " X0, 1, 6, 0.0\n"
GROUPS = ("X0", "X1")
DYN = ("!DYNAMIC\n {eqa}, 1\n 0.0, 0.01, 20, 5.0e-4\n 0.5, 0.25\n"
       " 1, 1, 0.0, 0.0\n 10, 0, 1\n")


@pytest.fixture(autouse=True)
def f64(monkeypatch):
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", "f64")


def test_nlstatic_two_substeps(tmp_path):
    cnt = deck("NLSTATIC", BC, "!CLOAD\n X1, 3, -0.05\n X1, 1, 0.2\n",
               "!STEP, SUBSTEPS=2\n", resid="1.0e-10")
    op, oj, wd, wj = run_both(tmp_path, strip(), cnt, ngroups=GROUPS)
    a, b = op["static"], oj["static"]
    assert a.iters == b.iters == 2
    assert rel(a.u, b.u) <= 1e-8
    assert rel(a.nodal_stress, b.nodal_stress) <= 1e-8
    assert rel(a.elem_stress, b.elem_stress) <= 1e-8


def test_implicit_dynamics(tmp_path):
    # RESID 1e-14: the accelerations carry the solve's error times
    # 1/(beta dt^2) = 1.6e7
    cnt = deck("DYNAMIC", BC, "!CLOAD\n X1, 3, -5.0\n", DYN.format(eqa=1),
               resid="1.0e-14")
    op, oj, _, _ = run_both(tmp_path, strip(), cnt, ngroups=GROUPS)
    a, b = op["dynamic"], oj["dynamic"]
    assert a.u.shape == b.u.shape and a.u.shape[1] == 6
    for k in ("u", "vel", "acc"):
        assert rel(getattr(a, k), getattr(b, k)) <= 1e-8, k
    assert a.u[:, 2].min() < 0.0


def test_explicit_refused_with_jax_message(tmp_path):
    cnt = deck("DYNAMIC", BC, "!CLOAD\n X1, 3, -5.0\n", DYN.format(eqa=11))
    msg = "explicit dynamics needs rotary inertia"
    with pytest.raises(NotImplementedError, match=msg):
        run_both(tmp_path, strip(), cnt, ngroups=GROUPS)
    with pytest.raises(NotImplementedError, match=msg):
        run_directory(str(tmp_path / "port"), device="cpu")


def _modes(a, b):
    assert rel(a.eigenvalues, b.eigenvalues) <= 1e-8
    for k in range(a.eigenvectors.shape[1]):
        x, y = a.eigenvectors[:, k], b.eigenvectors[:, k]
        s = np.sign(x @ y)
        assert np.abs(x - s * y).max() <= 1e-6 * np.abs(y).max()


def test_eigen(tmp_path):
    cnt = deck("EIGEN", BC, extra="!EIGEN\n 3, 1.0e-8, 60\n",
               resid="1.0e-10")
    op, oj, _, _ = run_both(tmp_path, strip(), cnt, ngroups=GROUPS)
    a, b = op["eigen"], oj["eigen"]
    assert a.iters == b.iters
    _modes(a, b)
    # the first bending frequency of the strip, as the JAX test reads it
    f1 = (1.875 ** 2 / (2 * np.pi)) * np.sqrt(1e6 * 0.1 ** 3 / 12 / 0.1
                                              / 2.0 ** 4)
    assert abs(a.freq[0] - f1) / f1 < 0.1


def test_staticeigen(tmp_path):
    cnt = deck("STATICEIGEN", BC, "!CLOAD\n X1, 1, 0.5\n",
               "!EIGEN\n 3, 1.0e-8, 60\n", resid="1.0e-10")
    op, oj, _, _ = run_both(tmp_path, strip(), cnt, ngroups=GROUPS)
    assert rel(op["static"].u, oj["static"].u) <= 1e-8
    _modes(op["eigen"], oj["eigen"])


def test_restart_round_trip(tmp_path):
    full = deck("NLSTATIC", BC, "!CLOAD\n X1, 3, -0.05\n",
                "!STEP, SUBSTEPS=2\n", resid="1.0e-10")
    first = deck("NLSTATIC", BC, "!CLOAD\n X1, 3, -0.025\n",
                 "!STEP, SUBSTEPS=2\n 0.5, 0.5\n!RESTART, FREQUENCY=1\n",
                 resid="1.0e-10")
    resume = full.replace("!STEP", "!RESTART, FREQUENCY=-1\n!STEP")
    _, _, wd, wj = run_both(tmp_path / "cut", strip(), first,
                            ngroups=GROUPS)
    # the uninterrupted run of the port, on the same shuffled mesh
    wf = str(tmp_path / "full")
    shutil.copytree(wd, wf, ignore=shutil.ignore_patterns("restart*"))
    with open(wf + "/case.cnt", "w") as fh:
        fh.write(full)
    op0 = {"static": run_directory(wf, device="cpu")["static"]}
    got = {}
    for name, path in (("port", wd), ("jax", wj)):
        with open(path + "/case.cnt", "w") as fh:
            fh.write(resume)
    import frontistr_tpu.run as jrun
    got["jax"] = jrun.run_directory(wj)["static"]
    got["port"] = run_directory(wd, device="cpu")["static"]
    assert np.array_equal(got["port"].u, op0["static"].u)
    assert rel(got["port"].u, got["jax"].u) <= 1e-8
    assert got["port"].iters == got["jax"].iters


def test_frequency_response(tmp_path):
    """The frequency response of the strip (!FLOAD at the free end, in
    LOAD CASE 1 and 2, Rayleigh damping) from the same modes in both
    packages: displacements and amplitude maxima within 1e-10."""
    from frontistr_tpu.analysis import eigen as jeigen
    from frontistr_tpu.analysis import freq as jfreq
    from frontistr_tpu.assembly.model import build_struct_model as jbuild
    from frontistr_tpu.io.ctrlio import read_cnt as jcnt
    from frontistr_tpu.io.meshio import read_mesh as jread
    from frontistr_tpu_torch.analysis import freq
    from frontistr_tpu_torch.convert import model_from_numpy
    from frontistr_tpu_torch.io.neu import write_static_workdir
    cnt = deck("EIGEN", BC, extra="!EIGEN\n 3, 1.0e-8, 60\n"
               "!FLOAD, LOAD CASE=1\n X1, 3, 1.0\n!FLOAD, LOAD CASE=2\n"
               " X1, 2, 0.5\n", resid="1.0e-10")
    wd = str(tmp_path)
    write_static_workdir(wd, strip(), cnt, ngroups=GROUPS)
    jm = jbuild(jread(wd + "/mesh.msh"), jcnt(wd + "/case.cnt"))
    tm = model_from_numpy(jm, device="cpu")
    eig = jeigen.run_eigen(jm)
    f0, f1 = 0.5 * eig.freq[0], 1.5 * eig.freq[2]
    kw = dict(n_freq=31, ray_alpha=3.0, ray_beta=2e-6, eigen_result=eig)
    rj = jfreq.run_frequency(jm, f0, f1, **kw)
    rt = freq.run_frequency(tm, f0, f1, **kw)
    for a, b in ((rt.disp_re, rj.disp_re), (rt.disp_im, rj.disp_im),
                 (rt.disp_amp_max, rj.disp_amp_max),
                 (rt.acc_amp_max, rj.acc_amp_max)):
        assert rel(a, b) <= 1e-10
    assert np.abs(rj.disp_im).max() > 0
