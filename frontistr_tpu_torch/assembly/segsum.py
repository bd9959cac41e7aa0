"""Sorted segment-sum assembly: the K1 kernel wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``frontistr_tpu/assembly/segsum_pallas.py``
(``_kernel`` / ``make_segsum`` / ``make_planes_segsum``).  Given element
matrices of one or more element blocks and a profile's ``perm`` /
``seg_sorted`` (raw pair entries in slot order), it returns the
``(nd*nd, n_slots)`` slot planes

    out[i*nd + j, s] = sum over entries p with slot s of ke_p[i, j]

where raw pair entries run in pair order (a, b, e), e fastest, per block
(``ell.build_profile`` / ``bell.build_cluster_profile``).  Empty slots
are 0.

``segsum`` is the wrapper: a CPU tensor takes the plain version
(``segsum_reference``: ``index_add_`` of the gathered entries by
``seg_sorted``), a CUDA tensor launches the hand-written kernel
``csrc/segsum.cu`` or raises.  The kernel is CUDA C++ built with
``nvcc`` for ``sm_90a`` at first use into ``build/kernels`` and bound
through a plain C interface with ctypes.  It is bound by device-memory
bytes; see the source for what it reads and writes and how its design
(one thread per slot, perm gather and plane relayout fused, no atomics)
keeps them few and deterministic.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Sequence

import numpy as np
import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "segsum.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
_MAX_BLOCKS = 8            # kMaxBlocks in csrc/segsum.cu


@dataclasses.dataclass
class SegsumPlan:
    """A profile's segment-sum maps on one device."""
    perm: torch.Tensor        # (P,) int32: slot order -> raw pair entry
    seg_sorted: torch.Tensor  # (P,) int32 destination slots, ascending
    slot_ptr: torch.Tensor    # (n_slots+1,) int32 CSR pointer
    n_slots: int
    pair_counts: tuple        # raw entries per element block


def make_plan(perm: np.ndarray, seg_sorted: np.ndarray, n_slots: int,
              pair_counts, device) -> SegsumPlan:
    """Host: the CSR pointer over ``seg_sorted`` (segment s is
    ``[slot_ptr[s], slot_ptr[s+1])``), then every map onto ``device``."""
    P = int(perm.size)
    if P >= 2 ** 31 or sum(pair_counts) != P:
        raise ValueError(f"bad profile: P={P}, pair_counts={pair_counts}")
    slot_ptr = np.searchsorted(seg_sorted, np.arange(n_slots + 1),
                               side="left").astype(np.int32)
    dev = torch.device(device)
    return SegsumPlan(
        perm=torch.as_tensor(np.ascontiguousarray(perm, np.int32),
                             device=dev),
        seg_sorted=torch.as_tensor(np.ascontiguousarray(seg_sorted,
                                                        np.int32),
                                   device=dev),
        slot_ptr=torch.as_tensor(slot_ptr, device=dev),
        n_slots=int(n_slots), pair_counts=tuple(int(c) for c in pair_counts))


def cached_plan(profile, device) -> SegsumPlan:
    """Plan of an ELL or cluster profile on ``device``, kept on the
    profile (one per device)."""
    plans = profile.__dict__.setdefault("_plans", {})
    key = str(torch.device(device))
    if key not in plans:
        plans[key] = make_plan(profile.perm, profile.seg_sorted,
                               profile.n_slots, profile.pair_counts, device)
    return plans[key]


def entry_planes(kes: Sequence[torch.Tensor], nns: Sequence[int],
                 nd: int) -> torch.Tensor:
    """(nd*nd, P) entries in raw pair order (a, b, e), e fastest."""
    planes = []
    for ke, nn in zip(kes, nns):
        E = ke.shape[0]
        kr = ke.reshape(E, nn, nd, nn, nd)
        planes.append(kr.permute(2, 4, 1, 3, 0).reshape(nd * nd,
                                                        nn * nn * E))
    return torch.cat(planes, dim=1)


def segsum_reference(plan: SegsumPlan, kes: Sequence[torch.Tensor],
                     nns: Sequence[int], nd: int) -> torch.Tensor:
    """Plain PyTorch version (any device): gather the entry planes into
    slot order, then ``index_add_`` them by ``seg_sorted``."""
    ent = entry_planes(kes, nns, nd)
    out = torch.zeros((nd * nd, plan.n_slots), dtype=ent.dtype,
                      device=ent.device)
    out.index_add_(1, plan.seg_sorted.long(), ent[:, plan.perm.long()])
    return out


def segsum(plan: SegsumPlan, kes: Sequence[torch.Tensor],
           nns: Sequence[int], nd: int) -> torch.Tensor:
    """(nd*nd, n_slots) slot planes.  CPU tensors: the plain version;
    CUDA tensors: the K1 kernel (``csrc/segsum.cu``), or an exception."""
    dtype = _check(plan, kes, nns, nd)
    dev = kes[0].device
    if dev.type == "cpu":
        return segsum_reference(plan, kes, nns, nd)
    if dev.type != "cuda":
        raise ValueError(f"segsum: unsupported device {dev}")
    return _launch(plan, kes, nns, nd, dtype)


segsum.launches = 0     # K1 kernel launches (plain-version calls excluded)


def _check(plan: SegsumPlan, kes, nns, nd: int) -> torch.dtype:
    dev = kes[0].device
    dtype = kes[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"segsum: dtype {dtype} (float32/float64 only)")
    if nd != 3:
        raise ValueError(f"segsum: nd={nd} (3-D solids, nd=3, only)")
    if not 1 <= len(kes) <= _MAX_BLOCKS or len(kes) != len(nns):
        raise ValueError(f"segsum: {len(kes)} element blocks "
                         f"(1..{_MAX_BLOCKS} supported)")
    if len(plan.pair_counts) != len(kes):
        raise ValueError("segsum: plan and element blocks disagree")
    for ke, nn, cnt in zip(kes, nns, plan.pair_counts):
        m = nn * nd
        if ke.device != dev or ke.dtype != dtype:
            raise ValueError("segsum: element blocks on mixed "
                             "devices/dtypes")
        if ke.dim() != 3 or tuple(ke.shape[1:]) != (m, m):
            raise ValueError(f"segsum: ke shape {tuple(ke.shape)}, "
                             f"want (E, {m}, {m})")
        if not ke.is_contiguous():
            raise ValueError("segsum: element matrices not contiguous")
        if ke.shape[0] * nn * nn != cnt:
            raise ValueError("segsum: element count disagrees with plan")
    for name in ("perm", "seg_sorted", "slot_ptr"):
        t = getattr(plan, name)
        if t.device != dev or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"segsum: plan.{name} must be contiguous "
                             f"int32 on {dev}")
    if plan.slot_ptr.numel() != plan.n_slots + 1:
        raise ValueError("segsum: slot_ptr length != n_slots + 1")
    return dtype


def _launch(plan: SegsumPlan, kes, nns, nd: int,
            dtype: torch.dtype) -> torch.Tensor:
    lib = _library()
    dev = kes[0].device
    out = torch.empty((nd * nd, plan.n_slots), dtype=dtype, device=dev)
    nblk = len(kes)
    off = np.zeros(nblk + 1, np.int64)
    off[1:] = np.cumsum(plan.pair_counts)
    ke_ptrs = (ctypes.c_void_p * nblk)(*[k.data_ptr() for k in kes])
    E = (ctypes.c_longlong * nblk)(*[int(k.shape[0]) for k in kes])
    nn = (ctypes.c_int * nblk)(*[int(n) for n in nns])
    pair_off = (ctypes.c_longlong * (nblk + 1))(*[int(v) for v in off])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fstr_segsum(int(dtype == torch.float64), nd,
                             plan.slot_ptr.data_ptr(), plan.perm.data_ptr(),
                             plan.n_slots, ke_ptrs, pair_off, E, nn, nblk,
                             out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"segsum kernel launch failed (code {rc})")
    segsum.launches += 1
    return out


_LIB = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("segsum: nvcc not found (set CUDA_HOME)")
    return path


def build(verbose: bool = False) -> str:
    """Compile ``csrc/segsum.cu`` for sm_90a into ``build/kernels``
    (named by the source's hash, so an edited source rebuilds); returns
    the library path."""
    with open(_SRC, "rb") as fh:
        tag = hashlib.sha1(fh.read()).hexdigest()[:12]
    lib = os.path.join(_BUILD_DIR, f"libfstr_segsum_{tag}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", tmp, _SRC]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        if verbose:
            print(res.stdout + res.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        vp = ctypes.c_void_p
        lib.fstr_segsum.argtypes = [
            ctypes.c_int, ctypes.c_int, vp, vp, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, vp, vp]
        lib.fstr_segsum.restype = ctypes.c_int
        _LIB = lib
    return _LIB
