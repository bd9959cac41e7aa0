"""Device and precision policy of the port.

FrontISTR is a double-precision code: tensors default to float64 and
drop to float32 only where the JAX package casts (the f32 inner CG of
the mixed-precision solve).  TF32 is switched off for every float32
matrix product and convolution — the counterpart of the JAX package's
``Precision.HIGHEST`` (``assembly/bell.py``, ``assembly/femop.py``,
``fem/solid.py``): TF32 keeps ~3 decimal digits and would stall the
mixed-precision refinement the way bf16 does on a TPU.
"""

from __future__ import annotations

import time

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve(device) -> torch.device:
    """``torch.device`` for a name or device; a CUDA request without a
    usable card raises (the port never moves to the CPU silently)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but "
                           "torch.cuda.is_available() is false")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU); phase
    timers call it so a host clock measures the work, not the enqueue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Phase:
    """Context manager adding a phase's wall time, the device's queued
    work included, to ``timings[name]`` (seconds)."""

    def __init__(self, timings: dict, name: str, device: torch.device):
        self.timings, self.name, self.device = timings, name, device

    def __enter__(self):
        synchronize(self.device)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        synchronize(self.device)
        self.timings[self.name] = self.timings.get(self.name, 0.0) + \
            time.perf_counter() - self.t0
