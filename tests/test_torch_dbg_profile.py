"""``FSTR.dbg.0`` and ``FRONTISTR_TPU_PROFILE`` of the port's runner:
the debug log equal to the JAX runner's with the clock and the seconds
masked, for a HECMW-ENTIRE and an ABAQUS deck; the profiler's Chrome
trace written on the CPU; FRONTISTR_TPU_SHARDS and
FRONTISTR_TPU_COORDINATOR (several devices) still refused by name.
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
    monkeypatch.setenv(name, "localhost:1234" if "COORD" in name else "2")
    wd = str(tmp_path / "wd")
    write_static_workdir(wd, box_tet4(2, 2, 2),
                         CNT.format(sol="STATIC", extra=""))
    with pytest.raises(NotImplementedError, match=name):
        run_directory(wd, device="cpu")
