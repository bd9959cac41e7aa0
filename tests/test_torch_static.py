"""The whole linear-static tet slice: one box deck through
``frontistr_tpu.run.run_directory`` and through the port's CLI on the
CPU, in both solve policies.

The node numbering is shuffled and FRONTISTR_TPU_REORDER=1 forces the
RCM reorder; FRONTISTR_TPU_AMG_MIN is lowered so the AMG arm runs at this
size.  The AMG power iterations of the port are fed the JAX package's
start vectors (torch cannot draw jax.random's bits).  Bars:
displacements within 1e-8 of max|u|; the 0.log Global Summary equal at
print precision; float64-policy iteration counts equal; mixed-policy
counts within 2 (the float32 inner CG sums in another order).  The deck
with a singular level-1 AMG block, where the port's block inverse
departs from the JAX package's on purpose, is in
``test_torch_static_amg.py``.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import frontistr_tpu.run as jrun
from frontistr_tpu.io import logio as jlogio
from frontistr_tpu_torch import ordering
from frontistr_tpu_torch.__main__ import main
from frontistr_tpu_torch.io.neu import write_static_workdir
from frontistr_tpu_torch.meshgen import box_tet4
from frontistr_tpu_torch.run import run_directory
from frontistr_tpu_torch.solver import amg

from _torch_vis_decks import VISUAL, assert_pictures_close, run_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CNT = ("!VERSION\n 3\n!SOLUTION, TYPE=STATIC\n!BOUNDARY\n X0, 1, 3, 0.0\n"
       "!CLOAD\n X1, 3, -1.0\n!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n"
       "!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
       " 1.0e-8, 1.0, 0.0\n!END\n")


def _workdir(path, n=(6, 5, 4), cnt=CNT):
    mesh = box_tet4(*n)
    order = np.random.default_rng(3).permutation(mesh.n_node)
    write_static_workdir(str(path), ordering.permute_mesh(mesh, order), cnt)
    return str(path)


def _jax_start_vectors(n0, n1, dtype, device, generator=None):
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    k0, k1 = jax.random.split(jax.random.PRNGKey(11))
    return (torch.as_tensor(np.array(jax.random.normal(k0, (n0,), jd)),
                            device=device),
            torch.as_tensor(np.array(jax.random.normal(k1, (n1,), jd)),
                            device=device))


@pytest.mark.parametrize("policy", ["f64", "mixed"])
def test_static_slice_matches_jax(tmp_path, monkeypatch, capsys, policy):
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", policy)
    monkeypatch.setenv("FRONTISTR_TPU_AMG_MIN", "100")
    monkeypatch.setenv("FRONTISTR_TPU_REORDER", "1")
    monkeypatch.setenv("FRONTISTR_TPU_COMPILE_CACHE", "0")
    monkeypatch.setattr(amg, "start_vectors", _jax_start_vectors)
    wd = _workdir(tmp_path / "port")
    wj = str(tmp_path / "jax")
    shutil.copytree(wd, wj)
    jres = jrun.run_directory(wj)["static"]
    assert main(["--device", "cpu", wd]) == 0
    assert f"policy={policy}" in capsys.readouterr().out
    res = run_directory(wd, device="cpu")["static"]
    uj = np.asarray(jres.u)
    assert res.u.shape == uj.shape and np.isfinite(res.u).all()
    assert np.abs(res.u - uj).max() <= 1e-8 * np.abs(uj).max()
    assert res.relres <= 1e-8
    if policy == "f64":
        assert res.iters == int(jres.iters)
    else:
        assert abs(res.iters - int(jres.iters)) <= 2
    got = jlogio.parse_log_summaries(os.path.join(wd, "0.log"))
    want = jlogio.parse_log_summaries(os.path.join(wj, "0.log"))
    assert got and got == want


def test_port_cli_leaves_jax_unloaded(tmp_path):
    wd = _workdir(tmp_path / "wd", n=(3, 2, 2))
    code = ("import sys\n"
            "from frontistr_tpu_torch.__main__ import main\n"
            f"assert main(['--device', 'cpu', {wd!r}]) == 0\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "print('NO_JAX')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "NO_JAX" in out.stdout
    assert "Global Summary" in open(os.path.join(wd, "0.log")).read()


def test_cli_cuda_without_card_is_an_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    wd = _workdir(tmp_path / "wd", n=(2, 2, 2))
    with pytest.raises(SystemExit) as e:
        main(["--device", "cuda", wd])
    assert e.value.code != 0
    assert not os.path.exists(os.path.join(wd, "0.log"))


@pytest.mark.parametrize("card", ["!SOLUTION, TYPE=NLSTATIC",
                                  "!SOLUTION, TYPE=EIGEN"])
def test_unported_requests_raise(tmp_path, monkeypatch, card):
    cnt = CNT.replace("!SOLUTION, TYPE=STATIC", card) if "SOLUTION" in card \
        else CNT.replace("!END\n", card + "\n!END\n")
    if "NLSTATIC" in card:
        # the Newton driver runs NLSTATIC and every Krylov method (as CG,
        # tests/test_torch_nonlinear.py) and !WRITE, VISUAL
        # (test_write_visual_nlstatic_matches_jax); several devices run
        # (tests/test_torch_shard_*.py): here the sharded Newton driver
        # in a group of one equals the single run, and its !RESTART is
        # refused by name
        monkeypatch.setenv("FRONTISTR_TPU_CACHE_DIR", "0")
        wd = _workdir(tmp_path / "wd", n=(2, 2, 2), cnt=cnt)
        want = run_directory(wd, device="cpu")["static"]
        monkeypatch.setenv("FRONTISTR_TPU_SHARDS", "1")
        got = run_directory(wd, device="cpu")["static"]
        np.testing.assert_allclose(got.u, want.u, rtol=0,
                                   atol=1e-8 * np.abs(want.u).max())
        assert got.iters == want.iters
        rs = cnt.replace("!END\n", "!RESTART, FREQUENCY=1\n!END\n")
        wd = _workdir(tmp_path / "rs", n=(2, 2, 2), cnt=rs)
        with pytest.raises(NotImplementedError, match="RESTART under"):
            run_directory(wd, device="cpu")
        return
    elif "EIGEN" in card:
        # Lanczos runs EIGEN; a card it lacks still raises
        cnt = cnt.replace("!END\n", "!SPRING\n 1, 3, 10.0\n!END\n")
    wd = _workdir(tmp_path / "wd", n=(2, 2, 2), cnt=cnt)
    with pytest.raises(NotImplementedError):
        run_directory(wd, device="cpu")


def test_write_visual_nlstatic_matches_jax(tmp_path, monkeypatch, capsys):
    """``!WRITE, VISUAL`` after NLSTATIC, which the runner used to refuse:
    the PSR picture of the JAX runner (``_torch_vis_decks``' bar: one
    level a byte, 0.1% of the pixels further apart)."""
    monkeypatch.setenv("FRONTISTR_TPU_COMPILE_CACHE", "0")
    cnt = CNT.replace("TYPE=STATIC", "TYPE=NLSTATIC").replace(
        "!END\n", VISUAL.format(freq="", method="PSR", more="") + "!END\n")
    wd = _workdir(tmp_path / "wd", n=(3, 2, 2), cnt=cnt)
    ot, oj, wj = run_pair(wd)
    assert "visualizer skipped" not in capsys.readouterr().out
    assert ot["static"].newton is not None
    assert_pictures_close(os.path.join(wd, "result.bmp"),
                          os.path.join(wj, "result.bmp"))


@pytest.mark.parametrize("binary", [False, True])
def test_write_result_matches_jax(tmp_path, monkeypatch, binary):
    """``!WRITE, RESULT``, which the runner used to refuse: the
    ``<!RESULT name>.0.1`` file (text, or binary with ``TYPE=BINARY``) of
    the STATIC deck holds the JAX package's labels, ids and values (to
    1e-8 of each component's largest value; REACTION_FORCE included)."""
    from frontistr_tpu.io.resfile import read_result_any as jread
    from frontistr_tpu_torch.io.resfile import read_result_any
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", "f64")
    monkeypatch.setenv("FRONTISTR_TPU_REORDER", "1")
    wd = _workdir(tmp_path / "port", n=(4, 3, 3),
                  cnt=CNT.replace("!END\n", "!WRITE, RESULT\n!END\n"))
    if binary:
        p = os.path.join(wd, "hecmw_ctrl.dat")
        with open(p) as f:
            txt = f.read()
        with open(p, "w") as f:
            f.write(txt.replace("IO=OUT", "IO=OUT, TYPE=BINARY"))
    wj = str(tmp_path / "jax")
    shutil.copytree(wd, wj)
    jrun.run_directory(wj)
    run_directory(wd, device="cpu")
    got = read_result_any(os.path.join(wd, "mesh.res.0.1"))
    want = jread(os.path.join(wj, "mesh.res.0.1"))
    assert np.array_equal(got["node_ids"], want["node_ids"])
    assert np.array_equal(got["elem_ids"], want["elem_ids"])
    for part in ("node_comps", "elem_comps"):
        assert [n for n, _ in got[part]] == [n for n, _ in want[part]]
        for (_, a), (_, b) in zip(got[part], want[part]):
            assert np.abs(a - b).max() <= 1e-8 * np.abs(b).max()


def test_solve_policy_by_analysis(monkeypatch):
    """The default policy on a CUDA device (no card needed: only the
    device's type is read): mixed for linear STATIC, float64 for
    NLSTATIC; float64 on the CPU; FRONTISTR_TPU_PRECISION overrides
    both."""
    from frontistr_tpu_torch.analysis.static import solve_policy
    monkeypatch.delenv("FRONTISTR_TPU_PRECISION", raising=False)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert solve_policy(cuda) == solve_policy(cuda, "STATIC") == "mixed"
    assert solve_policy(cuda, "NLSTATIC") == "f64"
    assert solve_policy(cpu, "STATIC") == solve_policy(cpu, "NLSTATIC") \
        == "f64"
    for pol in ("f64", "mixed"):
        monkeypatch.setenv("FRONTISTR_TPU_PRECISION", pol)
        assert {solve_policy(d, a) for d in (cuda, cpu)
                for a in ("STATIC", "NLSTATIC")} == {pol}
