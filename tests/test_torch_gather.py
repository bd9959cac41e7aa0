"""K3-K6: the port's plain gathers against the TPU kernels of
``scripts/microbench_pallas_gather.py``, run in Pallas interpret mode on
the CPU.

The script's kernels are closures inside its ``main()``, so the test
runs ``main()`` with ``jax.jit`` made the identity and
``pl.pallas_call`` wrapped: the wrapper forces ``interpret=True``,
records the kernel's name, inputs and output, and then raises, which the
script's ``bench()`` catches and reports as FAIL, so every kernel runs
once.  The recorded inputs go through the port's plain versions and the
outputs must be bit-equal (a gather copies values: no tolerance).  The
second half holds the plain versions to the script's kernel bodies on
random inputs with indices out of the window and out of range.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from frontistr_tpu_torch.microbench import gather as mb
from frontistr_tpu_torch.ops import gather as g

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Recorded(Exception):
    pass


@pytest.fixture(scope="module")
def script_runs():
    """{kernel name: [(inputs, output), ...]} of one ``main()`` run."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import microbench_pallas_gather as script
    finally:
        sys.path.pop(0)
    runs = {}
    real_call = pl.pallas_call

    def recording_call(kernel, **kw):
        kw["interpret"] = True
        fn = real_call(kernel, **kw)

        def call(*args):
            out = fn(*args)
            runs.setdefault(kernel.__name__, []).append(
                ([np.asarray(a) for a in args], np.asarray(out)))
            raise _Recorded(kernel.__name__)
        return call

    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "jit", lambda f=None, **kw: f)
    mp.setattr(pl, "pallas_call", recording_call)
    try:
        script.main()
    finally:
        mp.undo()
    return runs


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _t(a):
    return torch.as_tensor(np.array(a))


def test_script_runs_every_kernel(script_runs):
    assert {k: len(v) for k, v in script_runs.items()} == \
        {"k1": 1, "k2": 2, "k4": 1, "k5": 1}


@pytest.mark.parametrize("name,idx", [("k1", 0), ("k2", 0), ("k2", 1),
                                      ("k4", 0), ("k5", 0)])
def test_plain_equals_tpu_kernel(script_runs, name, idx):
    args, want = script_runs[name][idx]
    t = [_t(a) for a in args]
    got = {"k1": lambda: g.gather_rows(*t),
           "k2": lambda: g.gather_cols(*t),
           "k4": lambda: g.window_gather(*t),
           "k5": lambda: g.window_gather_tiled(*t, tile_rows=256,
                                               win_rows=64)}[name]()
    assert got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_microbench_inputs_are_the_scripts(script_runs):
    """The microbenchmark draws the script's inputs in the script's
    order (G5's are the K6 run's)."""
    data = mb.inputs("cpu")
    pairs = [("G1", "k1", 0), ("G2", "k2", 0), ("G3", "k2", 1),
             ("G4", "k4", 0), ("G5", "k5", 0)]
    for gid, name, idx in pairs:
        args, _ = script_runs[name][idx]
        for ours, theirs in zip(data[gid], args):
            np.testing.assert_array_equal(ours.numpy(), theirs)


def test_composed_index_formula_is_not_the_comment(script_runs):
    """K5 reads iq at column ip[s, l]: its output differs from the
    comment's w[iq, ip]."""
    (w, iq, ip), out = script_runs["k4"][0]
    naive = w[iq, ip]
    assert not np.array_equal(out, naive)
    p = ip
    row = 8 * (iq // 8) + np.take_along_axis(iq, p, axis=1) % 8
    np.testing.assert_array_equal(out, w[row, p])


# ---- the kernel bodies on random inputs (out-of-window / out of range) --

def _pallas(kern, out_shape, *args, grid=None, in_specs=None,
            out_specs=None):
    kw = dict(out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
              interpret=True)
    if grid is not None:
        kw.update(grid=grid, in_specs=in_specs, out_specs=out_specs)
    return np.asarray(pl.pallas_call(kern, **kw)(*args))


def _k4_body(winv):
    """The script's ``k4`` body (G4) for a window of winv*8 rows."""
    def k4(w_ref, iq_ref, ip_ref, o_ref):
        acc = jnp.zeros(o_ref.shape, jnp.float32)
        for v in range(winv):
            src = w_ref[v * 8:(v + 1) * 8, :]
            src = jnp.tile(src, (o_ref.shape[0] // 8, 1))
            gg = jnp.take_along_axis(src, iq_ref[:] % 8, axis=0)
            gg = jnp.take_along_axis(gg, ip_ref[:], axis=1)
            acc = jnp.where((iq_ref[:] // 8) == v, gg, acc)
        o_ref[:] = acc
    return k4


def _rand_window(rng, S, winv):
    iq = rng.integers(-3 * 8, (winv + 3) * 8, (S, 128)).astype(np.int32)
    ip = rng.integers(-140, 140, (S, 128)).astype(np.int32)
    return iq, ip


@pytest.mark.parametrize("seed", [0, 1])
def test_take_along_axis_out_of_range(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    i0 = rng.integers(-12, 12, (5, 64)).astype(np.int32)
    i1 = rng.integers(-70, 70, (8, 30)).astype(np.int32)
    want0 = np.asarray(jnp.take_along_axis(jnp.asarray(x), i0, axis=0))
    want1 = np.asarray(jnp.take_along_axis(jnp.asarray(x), i1, axis=1))
    np.testing.assert_array_equal(_bits(g.gather_rows(_t(x), _t(i0))),
                                  _bits(want0))
    np.testing.assert_array_equal(_bits(g.gather_cols(_t(x), _t(i1))),
                                  _bits(want1))
    assert np.isnan(want0).any() and np.isnan(want1).any()


@pytest.mark.parametrize("winv,S", [(8, 8), (2, 16), (1, 8)])
def test_window_gather_out_of_window(winv, S):
    rng = np.random.default_rng(winv)
    w = rng.standard_normal((winv * 8, 128)).astype(np.float32)
    iq, ip = _rand_window(rng, S, winv)
    want = _pallas(_k4_body(winv), (S, 128), w, iq, ip)
    got = g.window_gather(_t(w), _t(iq), _t(ip))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    v = iq // 8
    assert (want[(v < 0) | (v >= winv)] == 0).all()
    assert np.isnan(want).any() and (want == 0).any()


@pytest.mark.parametrize("tiles", [1, 3])
def test_window_gather_tiled_ragged_tiles(tiles):
    """The script's K6 grid at 1 and 3 tiles of 32 rows, 2 window blocks
    of 16 rows (tile t on block t % 2)."""
    TO, winv, nwin = 32, 2, 2
    rng = np.random.default_rng(tiles)
    w = rng.standard_normal((nwin * winv * 8, 128)).astype(np.float32)
    iq, ip = _rand_window(rng, tiles * TO, winv)
    want = _pallas(
        _k4_body(winv), (tiles * TO, 128), w, iq, ip, grid=(tiles,),
        in_specs=[pl.BlockSpec((winv * 8, 128), lambda t: (t % nwin, 0)),
                  pl.BlockSpec((TO, 128), lambda t: (t, 0)),
                  pl.BlockSpec((TO, 128), lambda t: (t, 0))],
        out_specs=pl.BlockSpec((TO, 128), lambda t: (t, 0)))
    got = g.window_gather_tiled(_t(w), _t(iq), _t(ip), tile_rows=TO,
                                win_rows=winv * 8)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("TO", [8, 24])
def test_window_gather_tiled_tile_rows(TO):
    """The script's K6 grid at tiles of 8 and 24 rows (tile_rows the
    other cases lack) on 3 window blocks of 16 rows: 5 tiles, so tile t
    reads block t % 3 and blocks 0 and 1 are read twice."""
    tiles, winv, nwin = 5, 2, 3
    rng = np.random.default_rng(TO)
    w = rng.standard_normal((nwin * winv * 8, 128)).astype(np.float32)
    iq, ip = _rand_window(rng, tiles * TO, winv)
    want = _pallas(
        _k4_body(winv), (tiles * TO, 128), w, iq, ip, grid=(tiles,),
        in_specs=[pl.BlockSpec((winv * 8, 128), lambda t: (t % nwin, 0)),
                  pl.BlockSpec((TO, 128), lambda t: (t, 0)),
                  pl.BlockSpec((TO, 128), lambda t: (t, 0))],
        out_specs=pl.BlockSpec((TO, 128), lambda t: (t, 0)))
    got = g.window_gather_tiled(_t(w), _t(iq), _t(ip), tile_rows=TO,
                                win_rows=winv * 8)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.isnan(want).any() and (want == 0).any()


def _row_formula(w, q, p, s, tile_rows, win_rows):
    """Row s of K5/K6 by the formula of ``csrc/gather.cu``'s note,
    restated in numpy: window block (s // tile_rows) % nwin, 0 outside
    the window, NaN for ip outside [-128, 128)."""
    nwin = w.shape[0] // win_rows
    wt = w[(s // tile_rows) % nwin * win_rows:][:win_rows]
    v = q // 8
    p = np.where(p < 0, p + 128, p)
    p_ok = (p >= 0) & (p < 128)
    pc = np.where(p_ok, p, 0)
    in_win = (v >= 0) & (v < win_rows // 8)
    got = wt[np.where(in_win & p_ok, 8 * v + q[pc] % 8, 0), pc]
    return np.where(in_win, np.where(p_ok, got, np.nan), 0.0) \
        .astype(np.float32)


@pytest.mark.parametrize("which", ["K6 S=999", "K5", "K6 S=70001"])
def test_window_checks_cover_and_match_formula(which):
    """The card's K5/K6 cases (``mb.window_checks``) hold what the card
    tests claim, and the plain versions equal the formula on them (300
    sampled rows of each 70,001-row case).  The script's Pallas body
    takes only multiples of 8 rows a tile, so tile_rows 1 and 37 are
    held to the formula instead."""
    cases = [c for c in mb.window_checks("cpu") if c[0].startswith(which)]
    assert cases
    for name, kern, plain, (w, iq, ip), kw in cases:
        win_rows = kw.get("win_rows", w.shape[0])
        tile_rows = kw.get("tile_rows", iq.shape[0])
        nwin = w.shape[0] // win_rows
        got = kern(w, iq, ip, **kw).numpy()
        w, iq, ip = w.numpy(), iq.numpy(), ip.numpy()
        v = iq // 8
        assert set(range(win_rows // 8)) <= set(np.unique(v)), name
        assert (v < 0).any() and (v >= win_rows // 8).any(), name
        assert ((ip >= -128) & (ip < 0)).any(), name
        assert (ip < -128).any() and (ip >= 128).any(), name
        assert iq.shape[0] % 2 == 1, name        # no multiple of a block
        S = iq.shape[0]
        assert {(s // tile_rows) % nwin for s in range(S)} == \
            set(range(nwin)), name
        rows = list(range(S)) if S < 2000 else \
            list(np.random.default_rng(0).choice(S, 300, replace=False))
        want = np.stack([_row_formula(w, iq[s], ip[s], s, tile_rows,
                                      win_rows) for s in rows])
        np.testing.assert_array_equal(_bits(got[rows]), _bits(want))


def test_window_gather_tiled_last_tile_ragged():
    """A row count that is no multiple of the tile: the plain version
    equals the full-tile result on the rows it has."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((128, 128)).astype(np.float32)
    iq, ip = _rand_window(rng, 96, 8)
    full = g.window_gather_tiled(_t(w), _t(iq), _t(ip), tile_rows=32)
    part = g.window_gather_tiled(_t(w), _t(iq[:70]), _t(ip[:70]),
                                 tile_rows=32)
    np.testing.assert_array_equal(_bits(part), _bits(full[:70]))


@pytest.mark.parametrize("call", [
    lambda: g.gather_rows(torch.zeros(8, 4, dtype=torch.float64),
                          torch.zeros(8, 4, dtype=torch.int32)),
    lambda: g.gather_cols(torch.zeros(8, 4),
                          torch.zeros(8, 4, dtype=torch.int64)),
    lambda: g.gather_rows(torch.zeros(65, 4),
                          torch.zeros(8, 4, dtype=torch.int32)),
    lambda: g.window_gather(torch.zeros(60, 128),
                            torch.zeros(8, 128, dtype=torch.int32),
                            torch.zeros(8, 128, dtype=torch.int32)),
    lambda: g.window_gather_tiled(torch.zeros(64, 128),
                                  torch.zeros(8, 64, dtype=torch.int32),
                                  torch.zeros(8, 64, dtype=torch.int32)),
    lambda: g.gather_cols(torch.zeros(8, 4).t(),
                          torch.zeros(4, 8, dtype=torch.int32)),
])
def test_bad_inputs_raise(call):
    with pytest.raises((TypeError, ValueError)):
        call()


def test_cpu_calls_count_no_launch():
    before = g.gather_rows.launches
    g.gather_rows(torch.zeros(8, 4), torch.zeros(8, 4, dtype=torch.int32))
    assert g.gather_rows.launches == before


def _good_args(name):
    """A call each wrapper takes on the CPU: (wrapper, args, kwargs)."""
    z = torch.zeros(8, 128, dtype=torch.int32)
    return {"gather_rows": (g.gather_rows, (torch.zeros(8, 128), z), {}),
            "gather_cols": (g.gather_cols, (torch.zeros(8, 128), z), {}),
            "window_gather": (g.window_gather,
                              (torch.zeros(64, 128), z, z), {}),
            "window_gather_tiled": (g.window_gather_tiled,
                                    (torch.zeros(64, 128), z, z),
                                    dict(tile_rows=4))}[name]


@pytest.mark.parametrize("fault,error", [("dtype", TypeError),
                                         ("strides", ValueError),
                                         ("device", ValueError)])
@pytest.mark.parametrize("name", ["gather_rows", "gather_cols",
                                  "window_gather", "window_gather_tiled"])
def test_cached_plan_still_raises(name, fault, error):
    """After good calls have cached their plan, a call with the same
    shapes but another values dtype, non-contiguous values or indices on
    another device is checked anew and raises."""
    fn, args, kw = _good_args(name)
    fn(*args, **kw)
    fn(*args, **kw)
    vals, idx = args[0], args[1]
    if fault == "dtype":
        vals = vals.double()
    elif fault == "strides":
        vals = torch.zeros(vals.shape[::-1]).t()
        assert vals.shape == args[0].shape and not vals.is_contiguous()
    else:
        idx = idx.to("meta")
    with pytest.raises(error):
        fn(vals, idx, *args[2:], **kw)
