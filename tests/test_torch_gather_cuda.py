"""K3-K6 on the card: the CUDA gathers against their plain PyTorch
versions on the same inputs.  The file imports nothing of JAX, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_gather_cuda.py

Every test skips, inside the test, where ``torch.cuda.is_available()`` is
false: the kernels have no CPU mode.  A gather copies values, so the
kernel and the plain version must be bit-equal (NaN outputs included),
and so must two launches.
"""

import numpy as np
import pytest
import torch

from frontistr_tpu_torch.microbench import gather as mb
from frontistr_tpu_torch.ops import gather as g


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the K3-K6 kernels have no CPU mode)")
    return torch.device("cuda")


def _bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _i32(a, dev):
    return torch.as_tensor(np.asarray(a, np.int32), device=dev)


def _f32(rng, shape, dev):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                           device=dev)


def _cases(dev):
    """(name, wrapper, plain version, args, kwargs): the script's shapes,
    ragged shapes, and indices out of range / out of the window."""
    rng = np.random.default_rng(7)
    data = mb.inputs(dev)
    out = [("K3 G1", g.gather_rows, g.gather_rows_reference, data["G1"],
            {}),
           ("K4 G2", g.gather_cols, g.gather_cols_reference, data["G2"],
            {}),
           ("K4 G3", g.gather_cols, g.gather_cols_reference, data["G3"],
            {}),
           ("K5 G4", g.window_gather, g.window_gather_reference, data["G4"],
            {}),
           ("K6 G5", g.window_gather_tiled, g.window_gather_tiled_reference,
            data["G5"], dict(tile_rows=256, win_rows=64))]
    out.append(("K3 ragged", g.gather_rows, g.gather_rows_reference,
                (_f32(rng, (37, 1000), dev),
                 _i32(rng.integers(-45, 45, (53, 1000)), dev)), {}))
    out.append(("K4 ragged", g.gather_cols, g.gather_cols_reference,
                (_f32(rng, (5, 12288), dev),
                 _i32(rng.integers(-13000, 13000, (5, 777)), dev)), {}))
    for S, winv in ((1, 8), (21, 3)):
        out.append((f"K5 S={S} winv={winv}", g.window_gather,
                    g.window_gather_reference,
                    (_f32(rng, (winv * 8, 128), dev),
                     _i32(rng.integers(-30, winv * 8 + 30, (S, 128)), dev),
                     _i32(rng.integers(-140, 140, (S, 128)), dev)), {}))
    for S in (256, 768, 700, 1):       # 1 and 3 tiles; a ragged last tile
        out.append((f"K6 S={S}", g.window_gather_tiled,
                    g.window_gather_tiled_reference,
                    (_f32(rng, (256, 128), dev),
                     _i32(rng.integers(-20, 84, (S, 128)), dev),
                     _i32(rng.integers(-130, 130, (S, 128)), dev)),
                    dict(tile_rows=256, win_rows=64)))
    return out


@pytest.mark.cuda
def test_kernels_bit_equal_plain(cuda_device):
    for name, kern, plain, args, kw in _cases(cuda_device):
        got = kern(*args, **kw)
        again = kern(*args, **kw)
        want = plain(*args, *kw.values())
        torch.cuda.synchronize()
        assert _bit_equal(got, want), name
        assert _bit_equal(got, again), name


@pytest.mark.cuda
def test_window_kernel_bit_equal_plain(cuda_device):
    """K5 and K6, one kernel, on the microbenchmark's ``window_checks``:
    tile_rows 1, 37 and 256; 1, 3 and 4 window blocks of 8 and 64 rows;
    999 rows (no multiple of the rows a block takes) and 70,001 (the
    grid-stride path); ip that wraps and ip out of range; iq in every
    vreg of the window and out of it on both sides."""
    for name, kern, plain, args, kw in mb.window_checks(cuda_device):
        n0 = kern.launches
        got = kern(*args, **kw)
        again = kern(*args, **kw)
        want = plain(*args, *kw.values())
        torch.cuda.synchronize()
        assert _bit_equal(got, want), name
        assert _bit_equal(got, again), name
        assert kern.launches - n0 == 2, name
        assert torch.isnan(want).any() and (want == 0).any(), name


@pytest.mark.cuda
@pytest.mark.parametrize("kern", [g.window_gather, g.window_gather_tiled])
def test_window_misaligned_indices_raise(cuda_device, kern):
    """The window kernel reads iq and ip in 16-byte vectors: an index
    view whose data starts inside a group of four raises and launches
    nothing."""
    w = torch.zeros(64, 128, device=cuda_device)
    flat = torch.zeros(9 * 128, dtype=torch.int32, device=cuda_device)
    good = flat[:8 * 128].view(8, 128)
    bad = flat[1:8 * 128 + 1].view(8, 128)
    kern(w, good, good)
    n0 = kern.launches
    for iq, ip in ((bad, good), (good, bad)):
        with pytest.raises(ValueError):
            kern(w, iq, ip)
    assert kern.launches == n0


@pytest.mark.cuda
def test_out_of_window_gives_zero(cuda_device):
    rng = np.random.default_rng(3)
    w = _f32(rng, (64, 128), cuda_device) + 10.0
    iq = _i32(rng.integers(64, 200, (8, 128)), cuda_device)
    ip = _i32(rng.integers(0, 128, (8, 128)), cuda_device)
    assert int((g.window_gather(w, iq, ip) != 0).sum()) == 0
    assert int((g.window_gather(w, -iq, ip) != 0).sum()) == 0


@pytest.mark.cuda
def test_launches_counted(cuda_device):
    cases = _cases(cuda_device)
    kerns = {c[1] for c in cases}
    before = {k: k.launches for k in kerns}
    for name, kern, plain, args, kw in cases:
        kern(*args, **kw)
        plain(*args, *kw.values())
    counts = {k: k.launches - before[k] for k in kerns}
    want = {}
    for c in cases:
        want[c[1]] = want.get(c[1], 0) + 1
    assert counts == want


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype_x", "dtype_i", "device", "shape"])
def test_bad_inputs_raise(cuda_device, bad):
    x = torch.zeros(8, 128, device=cuda_device)
    i = torch.zeros(8, 128, dtype=torch.int32, device=cuda_device)
    if bad == "dtype_x":
        x = x.double()
    elif bad == "dtype_i":
        i = i.long()
    elif bad == "device":
        i = i.cpu()
    else:
        x = torch.zeros(60, 128, device=cuda_device)
    n0 = g.window_gather.launches
    with pytest.raises((TypeError, ValueError)):
        g.window_gather(x, i, i)
    assert g.window_gather.launches == n0


def _widened(dev):
    """(name, wrapper, plain version, args): K3 at R = 1 and 64, S = 0 and
    L no multiple of the 256-thread block; K4 at W = 12288 and 1 and L no
    multiple of the block."""
    rng = np.random.default_rng(11)
    out = []
    for R, L, S in ((1, 1000, 3), (64, 1000, 5), (8, 300, 0), (64, 1, 7)):
        out.append((f"K3 R={R} L={L} S={S}", g.gather_rows,
                    g.gather_rows_reference,
                    (_f32(rng, (R, L), dev),
                     _i32(rng.integers(-R - 3, R + 3, (S, L)), dev))))
    for W, L in ((12288, 1000), (1, 300), (12288, 1)):
        out.append((f"K4 W={W} L={L}", g.gather_cols,
                    g.gather_cols_reference,
                    (_f32(rng, (3, W), dev),
                     _i32(rng.integers(-W - 3, W + 3, (3, L)), dev))))
    return out


@pytest.mark.cuda
def test_widened_shapes_bit_equal(cuda_device):
    """An empty output launches nothing and counts no launch."""
    for name, kern, plain, args in _widened(cuda_device):
        n0 = kern.launches
        got = kern(*args)
        again = kern(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        assert _bit_equal(got, want), name
        assert _bit_equal(got, again), name
        assert kern.launches - n0 == (2 if want.numel() else 0), name


@pytest.mark.cuda
def test_graph_replay_equals_eager(cuda_device):
    """A launch captured in a CUDA graph reads its inputs at replay."""
    data = mb.inputs(cuda_device)
    for kern, plain, args in (
            (g.gather_rows, g.gather_rows_reference, data["G1"]),
            (g.gather_cols, g.gather_cols_reference, data["G3"]),
            (g.window_gather, g.window_gather_reference, data["G4"]),
            (g.window_gather_tiled, g.window_gather_tiled_reference,
             data["G5"])):
        x = args[0]
        kern(*args)                      # plan and build outside the capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = kern(*args)
        x.mul_(-2.0).add_(1.0)
        graph.replay()
        eager = kern(*args)
        torch.cuda.synchronize()
        extra = (256, 64) if kern is g.window_gather_tiled else ()
        assert _bit_equal(captured, eager), kern.__name__
        assert _bit_equal(eager, plain(*args, *extra)), kern.__name__


@pytest.mark.cuda
def test_side_stream_ordered_after_write(cuda_device):
    """A launch on a side stream is queued on that stream (PyTorch's
    current one), after a delayed write to its input there."""
    rng = np.random.default_rng(13)
    for kern, plain, shape, hi in ((g.gather_rows, g.gather_rows_reference,
                                    (64, 4096), 64),
                                   (g.gather_cols, g.gather_cols_reference,
                                    (64, 4096), 4096)):
        x = _f32(rng, shape, cuda_device)
        i = _i32(rng.integers(0, hi, shape), cuda_device)
        fresh = _f32(rng, shape, cuda_device)
        kern(x, i)
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            torch.cuda._sleep(50_000_000)    # tens of ms before the write
            x.copy_(fresh)
            got = kern(x, i)
        side.synchronize()
        assert _bit_equal(got, plain(fresh, i)), kern.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("kern", [g.gather_rows, g.gather_cols])
def test_cached_plan_still_raises(cuda_device, kern):
    """After a good call, tensors of the same shapes but other strides
    are checked anew and raise, launching nothing."""
    x = torch.zeros(8, 128, device=cuda_device)
    i = torch.zeros(8, 128, dtype=torch.int32, device=cuda_device)
    kern(x, i)
    n0 = kern.launches
    with pytest.raises(ValueError):
        kern(torch.zeros(128, 8, device=cuda_device).t(), i)
    with pytest.raises(ValueError):
        kern(x, torch.zeros(128, 8, dtype=torch.int32,
                            device=cuda_device).t())
    assert kern.launches == n0
