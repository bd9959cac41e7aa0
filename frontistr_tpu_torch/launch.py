"""The lean launch path that every kernel wrapper of the port shares.

A kernel's input checks read only the tensors' shapes, strides, dtypes
and devices and the wrapper's int arguments, so a call validates once
per such key.  ``cached`` looks the key up in a cache the wrapper owns
(a module's dict, or a plan's) and on a miss runs the wrapper's
``make``, which checks the inputs (and raises) and returns what the
launch needs: the C function, the device index and whatever the key
fixes, or None for the plain path on the CPU.  A tensor of a seen shape
with other strides, dtype or device makes a new key, so it is checked
anew and refused.

``launch`` calls the C entry with PyTorch's current stream on the
device, read as a raw handle without building a ``torch.cuda.Stream``
(what PyTorch's generated launchers call), so capture into a CUDA graph
and side streams keep working.  No device context is entered: every C
entry makes the tensor's device current only when it is not, and
restores it (``csrc/on_device.cuh``).  Outputs are allocated with
``torch.empty_like`` or ``new_empty`` of an input, not
``torch.empty(..., device=)``.
"""

from __future__ import annotations

import torch

MAX_KEYS = 256         # per cache; a full cache is cleared
_MISS = object()


def cached(cache: dict, make, *tensors, extra=()):
    """``make(*tensors, *extra)``, run once per key of the tensors'
    shapes, strides, dtypes and devices and of ``extra``."""
    key = (make, extra,
           *[(t.shape, t.stride(), t.dtype, t.device) for t in tensors])
    got = cache.get(key, _MISS)
    if got is _MISS:
        got = make(*tensors, *extra)
        if len(cache) >= MAX_KEYS:
            cache.clear()
        cache[key] = got
    return got


def launch(fn, dev: int, *args) -> None:
    """``fn(*args, stream, dev)``; raises if it does not return 0 (its
    launch's ``cudaGetLastError``)."""
    rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev), dev)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed (code {rc})")
