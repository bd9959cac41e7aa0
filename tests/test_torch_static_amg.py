"""The linear-static tet slice's AMG deck with a singular level-1 block
(ROADMAP fault 1), split from ``test_torch_static.py`` (whose deck
helpers it uses) so that ``--dist loadfile`` spreads the slice over two
workers: the JAX package's mixed policy stalls on the block as it
stands; with the port's floored inverse put in its place it converges
and the port matches it (iterations within 2, displacements within 1e-8
of max|u|, the Global Summary equal at print precision).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import frontistr_tpu.run as jrun
from frontistr_tpu.io import logio as jlogio
from frontistr_tpu_torch.run import run_directory
from frontistr_tpu_torch.solver import amg

from test_torch_static import CNT, _jax_start_vectors, _workdir


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
