"""User plug points: the uelastic/umat/uload surface of the port (torch
port of ``frontistr_tpu/user.py``).

The reference ships empty Fortran stubs the user recompiles into the
binary (fistr1/src/lib/user/{umat,uload}.f90: uMatlMatrix / uUpdate /
uloading).  Here the plug point is a registry of Python callables on
torch tensors, applied batched over the (element, gauss point) axes:

    import frontistr_tpu_torch.user as fuser

    @fuser.register_umat("MYMAT")
    def my_material(matl, strain, stress, fstat, dtime, ttime):
        # matl (k,) the !USER_MATERIAL constants; strain/stress (..., 6)
        # at every gauss point; fstat (..., nstatus)
        D = ...            # (..., 6, 6) tangent
        sig = ...          # (..., 6) updated stress
        return D, sig, fstat

    @fuser.register_uload
    def my_load(coords, t):
        return f           # (n_node, ndof) additional external force

The port's registry is its own: a module written for the port imports
``frontistr_tpu_torch.user``.  A run loads the module named by
FRONTISTR_TPU_USER_MODULE (a .py path) before the analysis, so decks
with '!USER_MATERIAL' run without touching the package.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Callable, Dict, Optional

import numpy as np

_UMAT: Dict[str, Callable] = {}
_ULOAD: list = []


def register_umat(name: str = "DEFAULT"):
    """Decorator: the material update of !USER_MATERIAL blocks whose
    material is ``name``.

    fn(matl, strain, stress, fstat, dtime, ttime) -> (D, stress, fstat),
    strain/stress (..., 6), fstat (..., nstatus), D (..., 6, 6), batched
    over the leading (element, gauss point) axes."""
    def deco(fn):
        _UMAT[name.upper()] = fn
        return fn
    return deco


def register_uload(fn):
    """Register an additional external-load hook (uloading):
    fn(coords (n_node, dim), t) -> (n_node, ndof) force."""
    _ULOAD.append(fn)
    return fn


def get_umat(name: str = "DEFAULT") -> Optional[Callable]:
    return _UMAT.get((name or "DEFAULT").upper(), _UMAT.get("DEFAULT"))


def uload_total(coords, ndof, t=0.0):
    """Sum of the registered uload forces as a numpy array, or None."""
    out = None
    for fn in _ULOAD:
        f = fn(coords, t)
        f = f.cpu().numpy() if hasattr(f, "cpu") else np.asarray(f)
        out = f if out is None else out + f
    return out


def has_uload() -> bool:
    """Whether a uload is registered."""
    return bool(_ULOAD)


def clear():
    _UMAT.clear()
    del _ULOAD[:]


def load_user_module(path: Optional[str] = None):
    """Import the user's plug-in module (FRONTISTR_TPU_USER_MODULE)."""
    path = path or os.environ.get("FRONTISTR_TPU_USER_MODULE")
    if not path:
        return None
    spec = importlib.util.spec_from_file_location(
        "frontistr_tpu_torch_user", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
