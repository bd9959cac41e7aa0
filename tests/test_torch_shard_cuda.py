"""The sharded solves on the card: two ranks sharing one card (gloo, the
tensors staged through the host) and a group of one, against the
single-device card run of the same decks (which the CPU files hold to
the JAX package).  K1 runs on every rank.  The file imports nothing of
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_shard_cuda.py

Every test skips, inside the test, where ``torch.cuda.is_available()``
is false.  Bars: f64 answers within 1e-8 of the single-device run,
Newton iterations equal, CG counts within 2 a solve.
"""

import numpy as np
import pytest
import torch

from _torch_shard_tasks import rel, run, summary
from frontistr_tpu_torch import ordering
from frontistr_tpu_torch.io.neu import write_static_workdir
from frontistr_tpu_torch.meshgen import box_tet4
from frontistr_tpu_torch.parallel import dist

ENV = {"FRONTISTR_TPU_CACHE_DIR": "0", "FRONTISTR_TPU_PRECISION": "f64",
       "FRONTISTR_TPU_PRECOND": "amg"}
CNT = ("!VERSION\n 3\n!SOLUTION, TYPE={sol}\n!BOUNDARY\n X0, 1, 3, 0.0\n"
       "!CLOAD\n X1, 3, -1.0\n!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n"
       "!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
       " 1.0e-10, 1.0, 0.0\n!END\n")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _workdir(path, sol):
    mesh = box_tet4(8, 6, 5)
    order = np.random.default_rng(3).permutation(mesh.n_node)
    write_static_workdir(str(path), ordering.permute_mesh(mesh, order),
                         CNT.format(sol=sol))
    return str(path)


def _one(wd, monkeypatch):
    from frontistr_tpu_torch.run import run_directory
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    return summary(run_directory(wd, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("sol", ["STATIC", "NLSTATIC"])
def test_two_ranks_share_the_card(tmp_path, monkeypatch, sol):
    """Two ranks on one card (gloo): every rank launches K1 and both
    hold the single-device card answer."""
    _need_card()
    wd = _workdir(tmp_path / "wd", sol)
    want = _one(wd, monkeypatch)
    with dist.RankPool(2, "cuda") as pool:
        got = pool.run(run, wd, ENV)
    for g in got:
        assert g["k1"] >= 1
        np.testing.assert_array_equal(g["u"], got[0]["u"])
    assert rel(got[0]["u"], want["u"]) <= 1e-8
    assert abs(got[0]["iters"] - want["iters"]) <= (0 if sol == "NLSTATIC"
                                                    else 2)


@pytest.mark.cuda
def test_group_of_one_on_the_card(tmp_path, monkeypatch):
    """FRONTISTR_TPU_SHARDS=1 on the card: the sharded Newton driver in a
    group of one, K1 launched, the single-device answer."""
    _need_card()
    from frontistr_tpu_torch.assembly import segsum
    from frontistr_tpu_torch.run import run_directory
    wd = _workdir(tmp_path / "wd", "NLSTATIC")
    want = _one(wd, monkeypatch)
    monkeypatch.setenv("FRONTISTR_TPU_SHARDS", "1")
    k0 = segsum.segsum.launches
    got = summary(run_directory(wd, device="cuda"))
    assert segsum.segsum.launches > k0
    assert rel(got["u"], want["u"]) <= 1e-8
    assert got["iters"] == want["iters"]
