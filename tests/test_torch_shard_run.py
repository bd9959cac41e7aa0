"""The user surface of several devices on the CPU: FRONTISTR_TPU_SHARDS
on ``run_directory`` and ``python -m frontistr_tpu_torch`` (spawned
ranks, gloo), two processes joined by FRONTISTR_TPU_COORDINATOR on
localhost, and a partitioned HECMW-DIST work directory under sharding:
each the same answer as one process, rank 0 alone writing the run's
files, every rank its FSTR.dbg.<rank>."""

import os
import shutil
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

from _torch_shard_tasks import (hung_reduce, one_run, rel, slow_reduce,
                                summary)
from _torch_vis_decks import write_ctrl
from frontistr_tpu_torch import ordering
from frontistr_tpu_torch.__main__ import main
from frontistr_tpu_torch.io.neu import write_static_workdir
from frontistr_tpu_torch.meshgen import box_tet4
from frontistr_tpu_torch.parallel import dist, partition
from frontistr_tpu_torch.run import run_directory

ENV = {"FRONTISTR_TPU_CACHE_DIR": "0", "FRONTISTR_TPU_PRECISION": "f64"}
CNT = ("!VERSION\n 3\n!SOLUTION, TYPE={sol}\n!BOUNDARY\n X0, 1, 3, 0.0\n"
       "!CLOAD\n X1, 3, -1.0\n!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n"
       "!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
       " 1.0e-10, 1.0, 0.0\n!WRITE, RESULT\n!END\n")


@pytest.fixture
def env(monkeypatch):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    return monkeypatch


def _workdir(path, sol="NLSTATIC", mesh=None):
    mesh = box_tet4(4, 3, 3) if mesh is None else mesh
    order = np.random.default_rng(3).permutation(mesh.n_node)
    write_static_workdir(str(path), ordering.permute_mesh(mesh, order),
                         CNT.format(sol=sol))
    with open(os.path.join(str(path), "hecmw_ctrl.dat"), "a") as f:
        f.write("!RESULT, NAME=fstrRES, IO=OUT\n result\n")
    return str(path)


def _by_id(got):
    return got["u"].reshape(-1, 3)[np.argsort(got["node_ids"])]


def _files(wd):
    return sorted(f for f in os.listdir(wd) if not f.startswith("FSTR.dbg"))


@pytest.mark.parametrize("sol", ["STATIC", "NLSTATIC"])
def test_shards_run_directory_matches(tmp_path, env, sol):
    """FRONTISTR_TPU_SHARDS=2 on ``run_directory``: two spawned ranks,
    rank 0's output returned, its files the single run's files."""
    wd = _workdir(tmp_path / "wd", sol)
    one = one_run(wd)
    env.setenv("FRONTISTR_TPU_SHARDS", "2")
    got = summary(run_directory(wd, device="cpu"))
    assert rel(got["u"], one["u"]) <= 1e-8
    assert abs(got["iters"] - one["iters"]) <= 2
    assert _files(wd) == _files(wd + "_one")
    assert {"FSTR.dbg.0", "FSTR.dbg.1"} <= set(os.listdir(wd))
    assert not [f for f in os.listdir(wd) if f.startswith(".fstr_store")]


def test_shards_cli_matches(tmp_path, env, capsys):
    """``python -m frontistr_tpu_torch`` under FRONTISTR_TPU_SHARDS=3: the
    ranks print their backend; the 0.log equals the single run's
    within the log's digits."""
    import frontistr_tpu.io.logio as jlogio
    wd = _workdir(tmp_path / "wd")
    one_run(wd)
    env.setenv("FRONTISTR_TPU_SHARDS", "3")
    assert main(["--device", "cpu", wd]) == 0
    out = capsys.readouterr().out
    assert "### FRONTISTR_TPU_SHARDS=3: starting 3 ranks on cpu" in out
    assert "### newton: policy=f64" in out
    got = jlogio.parse_log_summaries(os.path.join(wd, "0.log"))
    want = jlogio.parse_log_summaries(os.path.join(wd + "_one", "0.log"))
    assert got.keys() == want.keys() and got
    for sec in want:
        for k, (a, b) in want[sec].items():
            ga, gb = got[sec][k]
            assert abs(ga - a) <= 1e-6 * max(abs(a), 1e-30) + 1e-12
            assert abs(gb - b) <= 1e-6 * max(abs(b), 1e-30) + 1e-12


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_coordinator_joins_two_processes(tmp_path, env):
    """FRONTISTR_TPU_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID: two CLI
    processes on localhost join one gloo group (nothing spawned) and give
    the single process's answer; only rank 0 writes the run's files."""
    wd = _workdir(tmp_path / "wd")
    one = one_run(wd)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    procs = []
    for r in range(2):
        e = dict(os.environ, FRONTISTR_TPU_COORDINATOR=f"127.0.0.1:{port}",
                 FRONTISTR_TPU_NUM_PROCESSES="2",
                 FRONTISTR_TPU_PROCESS_ID=str(r),
                 PYTHONPATH=repo + os.pathsep +
                 os.environ.get("PYTHONPATH", ""))
        e.pop("FRONTISTR_TPU_SHARDS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "frontistr_tpu_torch", "--device", "cpu",
             wd], env=e, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "### rank 0/2: backend gloo, device cpu" in outs[0]
    assert "### rank 1/2: backend gloo, device cpu" in outs[1]
    from frontistr_tpu_torch.io.resfile import read_result_any
    res = read_result_any(os.path.join(wd, "result.0.1"))
    ref = read_result_any(os.path.join(wd + "_one", "result.0.1"))
    np.testing.assert_array_equal(res["node_ids"], ref["node_ids"])
    assert rel(res["node_comps"][0][1], ref["node_comps"][0][1]) <= 1e-8
    assert {"FSTR.dbg.0", "FSTR.dbg.1"} <= set(os.listdir(wd))
    assert _files(wd) == _files(wd + "_one")
    assert one["iters"] > 0


def test_partitioned_workdir_under_shards(tmp_path, env):
    """A HECMW-DIST work directory of 2 RCB ranks under
    FRONTISTR_TPU_SHARDS=2: ordered by (rank, RCM), the same answer as
    the unpartitioned mesh, and rank 0 writes every rank's result file."""
    mesh = box_tet4(4, 3, 3)
    ref = _workdir(tmp_path / "ref", "STATIC", mesh)
    want = _by_id(one_run(ref))
    wd = tmp_path / "wd"
    wd.mkdir()
    partition.partition_to_files(mesh, 2, str(wd / "mesh.dist"), "RCB")
    shutil.copy(os.path.join(ref, "case.cnt"), wd / "case.cnt")
    write_ctrl(str(wd), "mesh.dist", "HECMW-DIST", result=True)
    env.setenv("FRONTISTR_TPU_SHARDS", "2")
    out = run_directory(str(wd), device="cpu")
    assert out["partition"]["n_ranks"] == 2
    got = _by_id(summary(out))
    assert rel(got, want) <= 1e-8
    assert os.path.exists(wd / "result.0.1")
    assert os.path.exists(wd / "result.1.1")


def test_pool_tasks_have_no_deadline_but_collectives_do():
    """A task that outlasts the collective timeout with no collective
    waiting ends with its answer; a collective that one rank alone
    enters times out, and the pool re-raises and stops its ranks."""
    pool = dist.RankPool(2, "cpu")
    try:
        assert pool.run(slow_reduce, 8.0, 5.0) == [2.0, 2.0]
        with pytest.raises(RuntimeError):
            pool.run(hung_reduce, 5.0)
        assert pool._procs is None
    finally:
        pool.close(kill=True)


@pytest.mark.parametrize("hosts,want", [
    (("a", "b"), [(0, 1), (0, 1)]),
    (("a", "a"), [(0, 2), (1, 2)])])
def test_coordinator_host_layout_picks_the_backend(monkeypatch, hosts, want):
    """The coordinator's ranks learn who shares their host over the
    join's store: two hosts of one card each choose NCCL, two ranks on
    one card gloo."""
    import torch.distributed as tdist
    store = tdist.HashStore()
    got = [None, None]

    def join(r):
        got[r] = dist.host_layout(store, r, 2, hosts[r])
    ts = [threading.Thread(target=join, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert got == want
    monkeypatch.setattr(dist.torch.cuda, "device_count", lambda: 1)
    backend = "nccl" if hosts[0] != hosts[1] else "gloo"
    assert [dist.choose_backend("cuda", n) for _, n in got] == [backend] * 2
