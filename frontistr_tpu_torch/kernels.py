"""Build and load the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source, ``csrc/<name>.cu``, with a plain C
entry point.  At first use it is compiled with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared`` (from ``$CUDA_HOME``, default
``/usr/local/cuda``) into ``build/kernels/`` of the checkout, named by
the source's hash so an edited source rebuilds, and loaded with ctypes.
``build`` compiles several sources at once, one ``nvcc`` process each.
Nothing here runs at import time: the CPU tests import every module on
machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Sequence, Tuple

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
KERNELS = ("segsum", "element_mv", "gather")      # csrc/<name>.cu
_TIMEOUT_S = 600

_LIBS: Dict[str, ctypes.CDLL] = {}      # loaded libraries, by kernel name


def source(name: str) -> str:
    return os.path.join(_PKG_DIR, "csrc", f"{name}.cu")


def library_path(name: str) -> str:
    """Where ``build`` puts the kernel's library (by the hash of its
    source and of the shared headers ``csrc/*.cuh``)."""
    csrc = os.path.join(_PKG_DIR, "csrc")
    digest = hashlib.sha1()
    for path in [source(name)] + sorted(
            os.path.join(csrc, f) for f in os.listdir(csrc)
            if f.endswith(".cuh")):
        with open(path, "rb") as fh:
            digest.update(fh.read())
    return os.path.join(_BUILD_DIR,
                        f"libfstr_{name}_{digest.hexdigest()[:12]}.so")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return path


def build(names: Sequence[str] = KERNELS,
          verbose: bool = False) -> Dict[str, str]:
    """Compile the named kernels that are not built yet, all at once (one
    ``nvcc`` each); returns their library paths by name.  ``verbose``
    prints each compiler's output (``-Xptxas -v``: registers, spills)."""
    paths = {name: library_path(name) for name in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if not todo:
        return paths
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs: Dict[str, Tuple[subprocess.Popen, str]] = {}
    errors = []
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", tmp, source(name)]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp)
        for name, (proc, tmp) in procs.items():
            out, _ = proc.communicate(timeout=_TIMEOUT_S)
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {name} "
                              f"({proc.returncode}):\n{out}")
                continue
            if verbose:
                print(f"nvcc {name}:\n{out}")
            os.replace(tmp, paths[name])
    finally:
        for proc, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The kernel's library, built and loaded at first use.
    ``signatures`` maps each C function to ``(argtypes, restype)``."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build([name])[name])
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return lib
