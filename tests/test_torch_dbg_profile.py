"""``FSTR.dbg.0`` and ``FRONTISTR_TPU_PROFILE`` of the port's runner:
the debug log equal to the JAX runner's with the clock and the seconds
masked, for a HECMW-ENTIRE and an ABAQUS deck; the profiler's Chrome
trace written on the CPU; FRONTISTR_TPU_SHARDS (two spawned ranks,
each its FSTR.dbg.<rank>) and a FRONTISTR_TPU_COORDINATOR without a
process count (one process) give the single run's answer.
"""

import json
import os
import re

import numpy as np
import pytest

from frontistr_tpu_torch.io.neu import write_static_workdir
from frontistr_tpu_torch.meshgen import box_tet4
from frontistr_tpu_torch.run import run_directory

from _torch_vis_decks import CNT, abaqus_workdir, run_pair


def _masked(path):
    """The debug log with each line's clock and every '(x.xx s)' masked."""
    text = open(path).read()
    text = re.sub(r"^ \d\d:\d\d:\d\d ", " hh:mm:ss ", text, flags=re.M)
    return re.sub(r"\(\d+\.\d\d s\)", "(s)", text)


@pytest.mark.parametrize("mtype", ["HECMW-ENTIRE", "ABAQUS"])
def test_dbg_file_matches_jax(tmp_path, monkeypatch, mtype):
    monkeypatch.setenv("FRONTISTR_TPU_COMPILE_CACHE", "0")
    wd = str(tmp_path / "wd")
    cnt = CNT.format(sol="STATIC", extra="")
    if mtype == "ABAQUS":
        abaqus_workdir(wd, box_tet4(2, 2, 2), cnt)
    else:
        write_static_workdir(wd, box_tet4(2, 2, 2), cnt)
    _, _, wj = run_pair(wd)
    got = _masked(os.path.join(wd, "FSTR.dbg.0"))
    assert got == _masked(os.path.join(wj, "FSTR.dbg.0"))
    assert got.splitlines() == [
        " hh:mm:ss FSTR debug log opened",
        f" hh:mm:ss mesh read: 27 nodes, 48 elements, type={mtype}",
        " hh:mm:ss setup done (s); solution type STATIC",
        " hh:mm:ss analysis completed (s)"]


def test_profile_writes_a_trace(tmp_path, monkeypatch, capsys):
    prof = tmp_path / "prof"
    monkeypatch.setenv("FRONTISTR_TPU_PROFILE", str(prof))
    wd = str(tmp_path / "wd")
    write_static_workdir(wd, box_tet4(2, 2, 2),
                         CNT.format(sol="STATIC", extra=""))
    out = run_directory(wd, device="cpu")
    assert np.isfinite(out["static"].u).all()
    assert f"### torch profiler trace written to {prof}" in \
        capsys.readouterr().out
    trace = json.load(open(prof / "trace.json"))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


@pytest.mark.parametrize("name", ["FRONTISTR_TPU_SHARDS",
                                  "FRONTISTR_TPU_COORDINATOR"])
def test_several_devices_still_raise(tmp_path, monkeypatch, name):
    """Several devices, which the port used to refuse: SHARDS=2 runs two
    ranks, each writing its FSTR.dbg.<rank>; a coordinator address
    without FRONTISTR_TPU_NUM_PROCESSES joins nothing.  Both give the
    single run's displacement."""
    monkeypatch.setenv("FRONTISTR_TPU_CACHE_DIR", "0")
    wd = str(tmp_path / "wd")
    write_static_workdir(wd, box_tet4(2, 2, 2),
                         CNT.format(sol="STATIC", extra=""))
    want = run_directory(wd, device="cpu")["static"].u
    os.remove(os.path.join(wd, "FSTR.dbg.0"))
    monkeypatch.setenv(name, "localhost:1234" if "COORD" in name else "2")
    got = run_directory(wd, device="cpu")["static"].u
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-8 * np.abs(want).max())
    dbgs = sorted(f for f in os.listdir(wd) if f.startswith("FSTR.dbg"))
    assert dbgs == (["FSTR.dbg.0", "FSTR.dbg.1"] if "SHARDS" in name
                    else ["FSTR.dbg.0"])
