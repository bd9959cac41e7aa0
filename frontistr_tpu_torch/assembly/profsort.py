"""ctypes bridge to the native profile-sort primitives
(native/profsort.cpp): radix unique-with-inverse and stable argsort
over the int64 pair keys that dominate the symbolic ELL / cluster-ELL
profile build (~31M keys at 1M-dof tet).  Falls back to numpy when no
compiler is available."""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libprofsort.so")
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        src = os.path.join(_NATIVE_DIR, "profsort.cpp")
        if not os.path.exists(src):
            return None
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR, "libprofsort.so"],
                           check=True, capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.ps_argsort.argtypes = [i64p, ctypes.c_int64, i32p]
    lib.ps_argsort.restype = None
    lib.ps_unique_inverse.argtypes = [i64p, ctypes.c_int64, i64p, i32p]
    lib.ps_unique_inverse.restype = ctypes.c_int64
    _lib = lib
    return _lib


def stable_argsort(key: np.ndarray) -> np.ndarray:
    """Stable ascending argsort of non-negative int64 keys (int32 out)."""
    key = np.ascontiguousarray(key, np.int64)
    lib = _load()
    if lib is None or key.size == 0 or (key.size and key.min() < 0):
        return np.argsort(key, kind="stable").astype(np.int32)
    perm = np.empty(key.size, np.int32)
    lib.ps_argsort(key.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                   key.size,
                   perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return perm


def unique_inverse(key: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(sorted unique values, int32 inverse) of non-negative int64 keys."""
    key = np.ascontiguousarray(key, np.int64)
    lib = _load()
    if lib is None or key.size == 0 or (key.size and key.min() < 0):
        u, inv = np.unique(key, return_inverse=True)
        return u, inv.astype(np.int32)
    uniq = np.empty(key.size, np.int64)
    inv = np.empty(key.size, np.int32)
    U = lib.ps_unique_inverse(
        key.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), key.size,
        uniq.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        inv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return uniq[:U].copy(), inv


def unique_sorted(key: np.ndarray) -> np.ndarray:
    return unique_inverse(key)[0]
