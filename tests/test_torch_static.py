"""The whole linear-static tet slice: one box deck through
``frontistr_tpu.run.run_directory`` and through the port's CLI on the
CPU, in both solve policies.

The node numbering is shuffled and FRONTISTR_TPU_REORDER=1 forces the
RCM reorder; FRONTISTR_TPU_AMG_MIN is lowered so the AMG arm runs at this
size.  The AMG power iterations of the port are fed the JAX package's
start vectors (torch cannot draw jax.random's bits).  Bars:
displacements within 1e-8 of max|u|; the 0.log Global Summary equal at
print precision; float64-policy iteration counts equal; mixed-policy
counts within 2 (the float32 inner CG sums in another order).  A second
deck holds a singular level-1 AMG block, where the port's block inverse
departs from the JAX package's on purpose.
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


def _floored_block_inv(D, nd):
    """The port's level-1 block inverse (``amg._block_inv``: zero diagonal
    set to 1, float64 eigendecomposition, eigenvalues floored at 100
    eps(dtype) of the block's largest), written for the JAX package."""
    D64 = D.astype(jnp.float64)
    idx = jnp.arange(D.shape[-1])
    dd = D64[:, idx, idx]
    D64 = D64.at[:, idx, idx].add(jnp.where(dd == 0.0, 1.0, 0.0))
    lam, V = jnp.linalg.eigh(0.5 * (D64 + jnp.swapaxes(D64, 1, 2)))
    top = lam[:, -1:]
    floor = jnp.where(top > 0, top * (100.0 * jnp.finfo(D.dtype).eps), 1.0)
    lam = jnp.maximum(lam, floor)
    return jnp.einsum("aij,aj,akj->aik", V, 1.0 / lam, V).astype(D.dtype)


@pytest.fixture
def fresh_jax_traces():
    """The JAX package keeps its jitted solves traced: drop the traces
    around a test that swaps one of the functions they call."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("jax_inverse", ["own", "floored"])
def test_mixed_amg_singular_block_matches_jax(tmp_path, monkeypatch,
                                              fresh_jax_traces, jax_inverse):
    """box_tet4(30, 30, 2), shuffled then RCM-ordered: one level-1 AMG
    block is singular up to rounding (the test checks that its smallest
    eigenvalue is below the floor).  The JAX package's mixed policy
    inverts that block as it stands in float32 and stalls (4 passes of
    300 iterations end above 1e-8).  With the port's floored inverse put
    in its place it converges, and the port matches it: iterations within
    2, displacements within 1e-8 of max|u|, the Global Summary equal at
    print precision."""
    from frontistr_tpu.solver import amg as jamg
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", "mixed")
    monkeypatch.setenv("FRONTISTR_TPU_AMG_MIN", "100")
    monkeypatch.setenv("FRONTISTR_TPU_REORDER", "1")
    monkeypatch.setenv("FRONTISTR_TPU_COMPILE_CACHE", "0")
    monkeypatch.setattr(amg, "start_vectors", _jax_start_vectors)
    wj = _workdir(tmp_path / "jax", n=(30, 30, 2),
                  cnt=CNT.replace(" 10000, 1\n", " 300, 1\n"))
    if jax_inverse == "own":
        jres = jrun.run_directory(wj)["static"]
        assert not float(jres.relres) <= 1e-8
        return
    monkeypatch.setattr(jamg, "_block_inv", _floored_block_inv)
    jres = jrun.run_directory(wj)["static"]
    blocks = []
    block_inv = amg._block_inv
    monkeypatch.setattr(amg, "_block_inv",
                        lambda D: blocks.append(D) or block_inv(D))
    wd = str(tmp_path / "port")
    shutil.copytree(wj, wd)
    os.remove(os.path.join(wd, "0.log"))
    res = run_directory(wd, device="cpu")["static"]
    lam = torch.linalg.eigvalsh(blocks[0].double())
    assert (lam[:, 0] <= 100 * torch.finfo(torch.float32).eps
            * lam[:, -1]).any()
    uj = np.asarray(jres.u)
    assert float(jres.relres) <= 1e-8 and res.relres <= 1e-8
    assert abs(res.iters - int(jres.iters)) <= 2
    assert np.abs(res.u - uj).max() <= 1e-8 * np.abs(uj).max()
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
                                  "!SOLUTION, TYPE=EIGEN",
                                  "!WRITE, RESULT"])
def test_unported_requests_raise(tmp_path, card):
    cnt = CNT.replace("!SOLUTION, TYPE=STATIC", card) if "SOLUTION" in card \
        else CNT.replace("!END\n", card + "\n!END\n")
    wd = _workdir(tmp_path / "wd", n=(2, 2, 2), cnt=cnt)
    with pytest.raises(NotImplementedError):
        run_directory(wd, device="cpu")
