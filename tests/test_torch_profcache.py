"""The persistent profile cache of the port (``assembly/profcache.py``
and its hooks in ``assembly/ell.py`` and ``bell.py``): the JAX package's
four cases of ``tests/test_profcache.py`` on the port, the keys beside
the JAX package's, and a STATIC deck through ``run_directory`` whose
warm-cache ``.res`` is byte-equal to the cold run's.  A profile loaded
from the cache is held bit-equal to the one built (every field, the
dtypes included)."""

import glob
import os

import numpy as np

from frontistr_tpu.assembly import profcache as jprofcache
from frontistr_tpu_torch.assembly import bell, ell, profcache
from frontistr_tpu_torch.assembly.model import build_struct_model
from frontistr_tpu_torch.io.ctrlio import read_cnt
from frontistr_tpu_torch.io.neu import write_static_workdir
from frontistr_tpu_torch.meshgen import box_tet4
from frontistr_tpu_torch.run import run_directory

CNT = """!VERSION
 3
!SOLUTION, TYPE=STATIC
!BOUNDARY
 X0, 1, 3, 0.0
!CLOAD
 X1, 3, -1.0
!MATERIAL, NAME=M1
!ELASTIC
 210000., 0.3
!SOLVER,METHOD=CG
 2000, 1
 1.0e-10, 1.0, 0.0
!WRITE, RESULT
!END
"""


def _model(tmp_path):
    p = tmp_path / "case.cnt"
    p.write_text(CNT)
    return build_struct_model(box_tet4(4, 4, 4), read_cnt(str(p)),
                              device="cpu")


def _clear():
    ell._PROFILE_CACHE.clear()
    bell._CPROFILE_CACHE.clear()


def _same(a, b, fields):
    for k in fields:
        x, y = getattr(a, k), getattr(b, k)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert x == y, k


ELL_FIELDS = ("n_node", "ndof", "W", "cols", "diag_slot", "perm",
              "seg_sorted", "pair_counts")
BELL_FIELDS = ("n_node", "ndof", "G", "C", "Wc", "ccols", "diag_wc", "perm",
               "seg_sorted", "scal_src", "pair_counts")


def test_profile_disk_roundtrip(monkeypatch, tmp_path):
    cache = tmp_path / "cache"
    monkeypatch.setenv("FRONTISTR_TPU_CACHE_DIR", str(cache))
    model = _model(tmp_path)
    _clear()
    p0 = ell.profile_from_model(model)
    c0 = bell.cluster_profile_from_model(model, scalar=p0)
    files = os.listdir(cache)
    assert len([f for f in files if f.endswith(".npz")]) == 2, files
    # cold in-memory cache -> loads from disk, bit-identical maps
    _clear()
    p1 = ell.profile_from_model(model)
    c1 = bell.cluster_profile_from_model(model, scalar=p1)
    assert p1 is not p0 and c1 is not c0
    _same(p0, p1, ELL_FIELDS)
    _same(c0, c1, BELL_FIELDS)
    _clear()


def test_profile_cache_key_discriminates(monkeypatch, tmp_path):
    """Different connectivity, kind or package never hit one entry."""
    monkeypatch.setenv("FRONTISTR_TPU_CACHE_DIR", str(tmp_path))
    c1 = [np.asarray([[0, 1, 2, 3]])]
    c2 = [np.asarray([[0, 1, 2, 4]])]
    keys = {profcache.conn_key(c1, 5, 3, tag="torch-ell"),
            profcache.conn_key(c2, 5, 3, tag="torch-ell"),
            profcache.conn_key(c1, 5, 3, tag="torch-bell"),
            profcache.conn_key(c1, 6, 3, tag="torch-ell"),
            profcache.conn_key(c1, 5, 2, tag="torch-ell"),
            jprofcache.conn_key(c1, 5, 3, tag="ell"),
            jprofcache.conn_key(c1, 5, 3, tag="bell")}
    assert len(keys) == 7
    # the same arguments hash as the JAX package's (one key function)
    assert profcache.conn_key(c1, 5, 3, tag="ell") == \
        jprofcache.conn_key(c1, 5, 3, tag="ell")


def test_profile_cache_disabled(monkeypatch, tmp_path):
    monkeypatch.setenv("FRONTISTR_TPU_CACHE_DIR", "0")
    model = _model(tmp_path)
    _clear()
    ell.profile_from_model(model)
    assert sorted(os.listdir(tmp_path)) == ["case.cnt"]
    monkeypatch.setenv("FRONTISTR_TPU_CACHE_DIR", "")
    assert profcache.cache_dir() is None
    monkeypatch.delenv("FRONTISTR_TPU_CACHE_DIR")
    assert profcache.cache_dir() == os.path.expanduser(
        "~/.cache/frontistr_tpu_torch")
    _clear()


def test_profile_cache_corrupt_entry_rebuilds(monkeypatch, tmp_path):
    cache = tmp_path / "cache"
    monkeypatch.setenv("FRONTISTR_TPU_CACHE_DIR", str(cache))
    model = _model(tmp_path)
    _clear()
    p0 = ell.profile_from_model(model)
    (entry,) = [f for f in os.listdir(cache) if f.endswith(".npz")]
    with open(cache / entry, "wb") as fh:
        fh.write(b"garbage")
    _clear()
    p1 = ell.profile_from_model(model)
    _same(p0, p1, ELL_FIELDS)
    # the rebuilt entry was written back and loads again
    _clear()
    assert profcache.load(entry[:-4]) is not None
    _same(p0, ell.profile_from_model(model), ELL_FIELDS)
    _clear()


def test_warm_cache_run_writes_the_same_res(monkeypatch, tmp_path):
    """The same STATIC deck run cold (profiles built and saved) and warm
    (profiles from the cache, memory cleared): byte-equal ``.res``."""
    monkeypatch.setenv("FRONTISTR_TPU_CACHE_DIR", str(tmp_path / "cache"))
    mesh = box_tet4(5, 4, 3)
    outs = []
    for run in ("cold", "warm"):
        wd = tmp_path / run
        write_static_workdir(str(wd), mesh, CNT)
        _clear()
        run_directory(str(wd), device="cpu")
        (res,) = glob.glob(str(wd / "mesh.res*"))
        outs.append(open(res, "rb").read())
    assert len(os.listdir(tmp_path / "cache")) == 2
    assert outs[0] == outs[1]
    _clear()
