"""Gathers on the card: the K3-K6 kernel wrappers and their plain
PyTorch versions.

They replace the four TPU kernels of ``scripts/microbench_pallas_gather.py``
(``k1``, ``k2``, ``k4``, ``k5``), a probe of the TPU's in-VMEM gather,
and compute what those kernels compute, float32 values and int32
indices:

- ``gather_rows`` (K3): ``out[s, l] = x[i[s, l], l]``;
- ``gather_cols`` (K4): ``out[s, l] = x[s, i[s, l]]``;
- ``window_gather`` (K5) and ``window_gather_tiled`` (K6), on 128 lanes
  and a window of ``WINV*8`` rows: with ``v = iq[s, l] // 8`` and
  ``p = ip[s, l]``, ``out[s, l] = w[8*v + iq[s, p] % 8, p]`` where
  ``0 <= v < WINV``, else 0.  K6 cuts the rows into tiles of
  ``tile_rows``; tile ``t`` reads window block ``t % nwin`` of ``w``.
  K5 is K6 with one window block and one tile: both launch the same
  kernel, a warp to a row of output.

Indices follow ``jnp.take_along_axis``: ``-n <= k < 0`` counts from the
end, anything outside ``[-n, n)`` gathers NaN.  ``//`` and ``%`` are the
floor operations.

Each wrapper takes the plain version for CPU tensors and launches its
kernel (``csrc/gather.cu``, built at first use by
``frontistr_tpu_torch.kernels``) for CUDA tensors, or raises.  The
kernels have no arithmetic: gathered values are copied, so kernel and
plain version agree bit for bit.  An empty output launches nothing.
K5/K6 read ``iq`` and ``ip`` in 16-byte vectors, so on the card they
also raise for index tensors whose data is not 16-byte aligned (a view
that starts inside a group of four).

The launch path.  At the script's shapes K3-K5 take 1.4-1.6 us on the
device (from a CUDA graph), so an eager call costs what the host takes
to issue it.  On an H100 host the wrappers' first design took 28-36 us
of host time a call (medians of 4,000 calls), of which ``torch.empty``
with a ``device`` argument 6-8 us, ``torch.cuda.current_stream(dev)``
for its handle 3.6-5.2 us, the ctypes call with the launch 4.5-5.9 us
(the launch itself 3-3.5 us, the host-side floor of any launch), the
input and shape checks 3.2-4.2 us, the ``torch.cuda.device`` context
2.3-3.4 us and the ``int(...)`` list 0.5-0.7 us.  So every call now
takes the lean launch path of ``frontistr_tpu_torch.launch``, which K1
shares:

- validates once per plan: ``_plan`` keys the checks by what they read
  (the tensors' shapes, strides, dtypes and devices, and K6's ints), so
  a call of a seen key skips them, and a tensor of a seen shape with
  other strides, dtype or device is checked anew and refused;
- allocates with ``torch.empty_like`` of the (contiguous) indices;
- reads PyTorch's current stream as a raw handle, so capture into a
  CUDA graph and side streams keep working;
- enters no device context: the C entry makes the tensor's device
  current only when it is not, and restores it;
- hands ctypes the ``data_ptr()`` ints and the plan's sizes, with the
  argument types set once at load, and raises if the launch's
  ``cudaGetLastError`` is not 0.

That leaves 10-13 us a call, of which the launch through ctypes is
about 5 us, the allocation about 2 us and the plan lookup 1.5-2 us
(PERF.md has the measurements and the comparison with
``torch.gather``).
"""

from __future__ import annotations

import ctypes

import torch

from frontistr_tpu_torch import kernels, launch

LANES = 128          # K5/K6 lanes (kLanes in csrc/gather.cu)
MAX_ROWS_K3 = 64     # source rows K3 takes
MAX_WIDTH_K4 = 12288  # source width K4 takes
MAX_WIN_ROWS = 64    # window rows K5/K6 take

_NAN = float("nan")


def _take(src: torch.Tensor, k: torch.Tensor, dim: int) -> torch.Tensor:
    """``take_along_axis`` with its index rule: wrap [-n, 0), NaN
    outside [-n, n)."""
    n = src.shape[dim]
    k = k.long()
    k = torch.where(k < 0, k + n, k)
    ok = (k >= 0) & (k < n)
    got = torch.gather(src, dim, torch.where(ok, k, torch.zeros_like(k)))
    return torch.where(ok, got, torch.full_like(got, _NAN))


def gather_rows_reference(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return _take(x, i, 0)


def gather_cols_reference(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return _take(x, i, 1)


def window_gather_tiled_reference(w: torch.Tensor, iq: torch.Tensor,
                                  ip: torch.Tensor, tile_rows: int,
                                  win_rows: int) -> torch.Tensor:
    S = iq.shape[0]
    nwin = w.shape[0] // win_rows
    tile = torch.arange(S, device=iq.device) // tile_rows
    base = (tile % nwin) * win_rows                       # (S,)
    iql = iq.long()
    v = torch.div(iql, 8, rounding_mode="floor")
    p = ip.long()
    p = torch.where(p < 0, p + LANES, p)
    p_ok = (p >= 0) & (p < LANES)
    pc = torch.where(p_ok, p, torch.zeros_like(p))
    sub = torch.remainder(torch.gather(iql, 1, pc), 8)
    row = base[:, None] + 8 * v + sub
    in_win = (v >= 0) & (v < win_rows // 8)
    got = w[torch.where(in_win & p_ok, row, torch.zeros_like(row)), pc]
    got = torch.where(p_ok, got, torch.full_like(got, _NAN))
    return torch.where(in_win, got, torch.zeros_like(got))


def window_gather_reference(w: torch.Tensor, iq: torch.Tensor,
                            ip: torch.Tensor) -> torch.Tensor:
    return window_gather_tiled_reference(w, iq, ip, max(iq.shape[0], 1),
                                         w.shape[0])


def gather_rows(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """K3: ``out[s, l] = x[i[s, l], l]``; x (R, L), i (S, L), R <= 64."""
    plan = _plan(_plan_rows, x, i)
    if plan is None:
        return gather_rows_reference(x, i)
    fn, dev, R, L, S = plan
    out = torch.empty_like(i, dtype=torch.float32)
    if out.numel():
        launch.launch(fn, dev, x.data_ptr(), R, L, i.data_ptr(), S,
                      out.data_ptr())
        gather_rows.launches += 1
    return out


def gather_cols(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """K4: ``out[s, l] = x[s, i[s, l]]``; x (R, W), i (R, L),
    W <= 12288."""
    plan = _plan(_plan_cols, x, i)
    if plan is None:
        return gather_cols_reference(x, i)
    fn, dev, R, W, L = plan
    out = torch.empty_like(i, dtype=torch.float32)
    if out.numel():
        launch.launch(fn, dev, x.data_ptr(), R, W, i.data_ptr(), L,
                      out.data_ptr())
        gather_cols.launches += 1
    return out


def window_gather(w: torch.Tensor, iq: torch.Tensor,
                  ip: torch.Tensor) -> torch.Tensor:
    """K5: the windowed gather over one window w (WINV*8, 128), WINV <= 8,
    iq/ip (S, 128)."""
    plan = _plan(_plan_window, w, iq, ip)
    if plan is None:
        return window_gather_reference(w, iq, ip)
    fn, dev, win_rows, S = plan
    out = torch.empty_like(iq, dtype=torch.float32)
    if out.numel():
        piq, pip = _aligned("window_gather", iq, ip)
        launch.launch(fn, dev, w.data_ptr(), win_rows, piq, pip, S,
                      out.data_ptr())
        window_gather.launches += 1
    return out


def window_gather_tiled(w: torch.Tensor, iq: torch.Tensor, ip: torch.Tensor,
                        tile_rows: int = 256,
                        win_rows: int = 64) -> torch.Tensor:
    """K6: tiles of ``tile_rows`` rows (the last may be ragged), tile t
    on window block ``t % nwin`` of w (nwin*win_rows, 128)."""
    plan = _plan(_plan_tiled, w, iq, ip, extra=(tile_rows, win_rows))
    if plan is None:
        return window_gather_tiled_reference(w, iq, ip, tile_rows, win_rows)
    fn, dev, nwin, S = plan
    out = torch.empty_like(iq, dtype=torch.float32)
    if out.numel():
        piq, pip = _aligned("window_gather_tiled", iq, ip)
        launch.launch(fn, dev, w.data_ptr(), win_rows, nwin, piq, pip, S,
                      tile_rows, out.data_ptr())
        window_gather_tiled.launches += 1
    return out


gather_rows.launches = 0            # kernel launches (plain calls excluded)
gather_cols.launches = 0
window_gather.launches = 0
window_gather_tiled.launches = 0


# The launch path (``frontistr_tpu_torch.launch``): each wrapper's
# ``_plan_*`` checks the inputs (and raises) and returns the C function,
# the device index and the sizes, or None for the plain path on the CPU;
# it runs once per key of the tensors' shapes, strides, dtypes and
# devices (and K6's ints).
_PLANS: dict = {}


def _plan(make, *tensors, extra=()):
    return launch.cached(_PLANS, make, *tensors, extra=extra)


def _cuda_plan(fn: str, x: torch.Tensor, *sizes):
    if x.device.type == "cpu":
        return None
    return (getattr(kernels.load("gather", _SIGNATURES), fn),
            x.device.index) + sizes


def _plan_rows(x, i):
    _check("gather_rows", x, i)
    if not (1 <= x.shape[0] <= MAX_ROWS_K3 and i.shape[1] == x.shape[1]):
        raise ValueError(f"gather_rows: x {tuple(x.shape)}, i "
                         f"{tuple(i.shape)} (1 <= R <= {MAX_ROWS_K3}, "
                         "same columns)")
    return _cuda_plan("fstr_gather_rows", x, x.shape[0], x.shape[1],
                      i.shape[0])


def _plan_cols(x, i):
    _check("gather_cols", x, i)
    if not (1 <= x.shape[1] <= MAX_WIDTH_K4 and i.shape[0] == x.shape[0]):
        raise ValueError(f"gather_cols: x {tuple(x.shape)}, i "
                         f"{tuple(i.shape)} (1 <= W <= {MAX_WIDTH_K4}, "
                         "same rows)")
    return _cuda_plan("fstr_gather_cols", x, x.shape[0], x.shape[1],
                      i.shape[1])


def _plan_window(w, iq, ip):
    _check_window("window_gather", w, iq, ip, w.shape[0])
    return _cuda_plan("fstr_window_gather", w, w.shape[0], iq.shape[0])


def _plan_tiled(w, iq, ip, tile_rows, win_rows):
    _check_window("window_gather_tiled", w, iq, ip, win_rows)
    if tile_rows < 1 or w.shape[0] % win_rows:
        raise ValueError(f"window_gather_tiled: tile_rows={tile_rows}, w "
                         f"rows {w.shape[0]} not a multiple of {win_rows}")
    return _cuda_plan("fstr_window_gather_tiled", w,
                      w.shape[0] // win_rows, iq.shape[0])


def _aligned(name: str, iq: torch.Tensor, ip: torch.Tensor) -> tuple:
    """The index pointers, which the K5/K6 kernel reads in 16-byte
    vectors; raises if either is not 16-byte aligned."""
    piq, pip = iq.data_ptr(), ip.data_ptr()
    if (piq | pip) & 15:
        raise ValueError(f"{name}: iq and ip data must be 16-byte aligned")
    return piq, pip


def _check(name: str, x: torch.Tensor, *idx: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: values {x.dtype} (float32 only)")
    for i in idx:
        if i.dtype != torch.int32:
            raise TypeError(f"{name}: indices {i.dtype} (int32 only)")
        if i.device != x.device:
            raise ValueError(f"{name}: values on {x.device}, indices on "
                             f"{i.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if any(t.dim() != 2 for t in (x,) + idx):
        raise ValueError(f"{name}: 2-D tensors only")
    if not all(t.is_contiguous() for t in (x,) + idx):
        raise ValueError(f"{name}: tensors must be contiguous")


def _check_window(name: str, w, iq, ip, win_rows: int) -> None:
    _check(name, w, iq, ip)
    if not (8 <= win_rows <= MAX_WIN_ROWS and win_rows % 8 == 0):
        raise ValueError(f"{name}: window of {win_rows} rows (a multiple "
                         f"of 8 up to {MAX_WIN_ROWS})")
    if w.shape[1] != LANES or iq.shape[1] != LANES \
            or ip.shape != iq.shape:
        raise ValueError(f"{name}: w {tuple(w.shape)}, iq "
                         f"{tuple(iq.shape)}, ip {tuple(ip.shape)} "
                         f"({LANES} lanes, iq and ip alike)")


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# each ends in (stream, device index)
_SIGNATURES = {
    "fstr_gather_rows": ([_P, _I, _I, _P, _I, _P, _P, _I], _I),
    "fstr_gather_cols": ([_P, _I, _I, _P, _I, _P, _P, _I], _I),
    "fstr_window_gather": ([_P, _I, _P, _P, _L, _P, _P, _I], _I),
    "fstr_window_gather_tiled": ([_P, _I, _I, _P, _P, _L, _I, _P, _P, _I],
                                 _I),
}

