"""ctypes bridge to the native meshscan tokenizer (native/meshscan.cpp).

Builds the shared library on first use (g++ is in the image; pybind11 is
not, so the binding is a plain C ABI + ctypes).  Falls back silently when
no compiler is available — meshio then parses everything in Python.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libmeshscan.so")
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        src = os.path.join(_NATIVE_DIR, "meshscan.cpp")
        if not os.path.exists(src):
            return None
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.msh_scan.restype = ctypes.c_void_p
    lib.msh_scan.argtypes = [ctypes.c_char_p]
    lib.msh_free.argtypes = [ctypes.c_void_p]
    lib.msh_n_nodes.restype = ctypes.c_int64
    lib.msh_n_nodes.argtypes = [ctypes.c_void_p]
    lib.msh_node_ids.restype = ctypes.POINTER(ctypes.c_int64)
    lib.msh_node_ids.argtypes = [ctypes.c_void_p]
    lib.msh_coords.restype = ctypes.POINTER(ctypes.c_double)
    lib.msh_coords.argtypes = [ctypes.c_void_p]
    lib.msh_n_blocks.restype = ctypes.c_int
    lib.msh_n_blocks.argtypes = [ctypes.c_void_p]
    for nm in ("msh_block_etype", "msh_block_nn"):
        getattr(lib, nm).restype = ctypes.c_int
        getattr(lib, nm).argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.msh_block_nelem.restype = ctypes.c_int64
    lib.msh_block_nelem.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for nm in ("msh_block_ids", "msh_block_conn"):
        getattr(lib, nm).restype = ctypes.POINTER(ctypes.c_int64)
        getattr(lib, nm).argtypes = [ctypes.c_void_p, ctypes.c_int]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def scan(path: str) -> Optional[dict]:
    """Fast scan of !NODE/!ELEMENT cards.

    Returns dict(node_ids (n,), coords (n,3), blocks=[(etype, ids, conn)])
    with conn carrying 1-based global node IDS (not indices), or None when
    the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    h = lib.msh_scan(path.encode())
    if not h:
        return None
    try:
        n = lib.msh_n_nodes(h)
        node_ids = np.ctypeslib.as_array(lib.msh_node_ids(h),
                                         shape=(n,)).copy()
        coords = np.ctypeslib.as_array(lib.msh_coords(h),
                                       shape=(n, 3)).copy()
        blocks = []
        for b in range(lib.msh_n_blocks(h)):
            et = lib.msh_block_etype(h, b)
            nn = lib.msh_block_nn(h, b)
            ne = lib.msh_block_nelem(h, b)
            ids = np.ctypeslib.as_array(lib.msh_block_ids(h, b),
                                        shape=(ne,)).copy()
            conn = np.ctypeslib.as_array(lib.msh_block_conn(h, b),
                                         shape=(ne, nn)).copy()
            blocks.append((et, ids, conn))
        return dict(node_ids=node_ids, coords=coords, blocks=blocks)
    finally:
        lib.msh_free(h)
