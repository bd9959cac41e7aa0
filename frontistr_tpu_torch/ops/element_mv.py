"""SoA element matvec: the K2 kernel wrapper and its plain PyTorch
version.

Replaces the TPU kernel ``frontistr_tpu/ops/pallas_mv.py``
(``_kernel`` / ``element_matvec_soa``).  With the element axis last,

    fe[i, e] = sum_j keT[i, j, e] * xeT[j, e]

for keT (24, 24, E), xeT (24, E) and fe (24, E), float32 or float64: the
element products of the structured hex8 operator
(``assembly/structured.py``).

``element_matvec_soa`` is the wrapper: a CPU tensor takes the plain
version (``element_matvec_soa_reference``), a CUDA tensor launches the
hand-written kernel ``csrc/element_mv.cu`` or raises.  The kernel is
CUDA C++ built at first use by ``frontistr_tpu_torch.kernels`` and bound
through a plain C interface with ctypes.  It is bound by device-memory
bytes (keT is read once; see the source for how one thread per element
keeps every load coalesced).  keT is not padded: the TPU's ``pad_soa``
and ``PAD_E`` have no counterpart, and the kernel takes any E.
"""

from __future__ import annotations

import ctypes

import torch

from frontistr_tpu_torch import kernels

M = 24          # hex8: 8 nodes x 3 dofs (kM in csrc/element_mv.cu)


def element_matvec_soa_reference(keT: torch.Tensor,
                                 xeT: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (any device)."""
    return (keT * xeT[None]).sum(1)


def element_matvec_soa(keT: torch.Tensor, xeT: torch.Tensor) -> torch.Tensor:
    """(24, E) element forces.  CPU tensors: the plain version; CUDA
    tensors: the K2 kernel (``csrc/element_mv.cu``), or an exception."""
    _check(keT, xeT)
    if keT.device.type == "cpu":
        return element_matvec_soa_reference(keT, xeT)
    if keT.device.type != "cuda":
        raise ValueError(f"element_matvec_soa: unsupported device "
                         f"{keT.device}")
    return _launch(keT, xeT)


element_matvec_soa.launches = 0     # K2 launches (plain calls excluded)
element_matvec_soa.launches_by_e = {}   # the same launches by element count


def _check(keT: torch.Tensor, xeT: torch.Tensor) -> None:
    if keT.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"element_matvec_soa: dtype {keT.dtype} "
                        "(float32/float64 only)")
    if xeT.dtype != keT.dtype or xeT.device != keT.device:
        raise ValueError("element_matvec_soa: keT and xeT on mixed "
                         "devices/dtypes")
    if keT.dim() != 3 or tuple(keT.shape[:2]) != (M, M):
        raise ValueError(f"element_matvec_soa: keT shape "
                         f"{tuple(keT.shape)}, want ({M}, {M}, E)")
    if tuple(xeT.shape) != (M, keT.shape[2]):
        raise ValueError(f"element_matvec_soa: xeT shape "
                         f"{tuple(xeT.shape)}, want ({M}, {keT.shape[2]})")
    if not (keT.is_contiguous() and xeT.is_contiguous()):
        raise ValueError("element_matvec_soa: keT and xeT must be "
                         "contiguous")


_SIGNATURES = {"fstr_element_mv": (
    [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int)}


def _launch(keT: torch.Tensor, xeT: torch.Tensor) -> torch.Tensor:
    lib = kernels.load("element_mv", _SIGNATURES)
    dev = keT.device
    E = int(keT.shape[2])
    fe = torch.empty((M, E), dtype=keT.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fstr_element_mv(int(keT.dtype == torch.float64), M,
                                 keT.data_ptr(), xeT.data_ptr(), E,
                                 fe.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"element_mv kernel launch failed (code {rc})")
    element_matvec_soa.launches += 1
    element_matvec_soa.launches_by_e[E] = \
        element_matvec_soa.launches_by_e.get(E, 0) + 1
    return fe
