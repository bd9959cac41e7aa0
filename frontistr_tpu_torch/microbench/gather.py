"""Gather microbenchmark on the card: the counterpart of
``scripts/microbench_pallas_gather.py``'s ``main()``.

    python -m frontistr_tpu_torch.microbench.gather

The same five rows on the same shapes, with the inputs drawn from
``np.random.default_rng(0)`` in the script's order:

- G1 K3 ``gather_rows``: x (8, 1024), i (8, 1024) in [0, 8);
- G2/G3 K4 ``gather_cols``: sources (8, 128) and (8, 512);
- G4 K5 ``window_gather``: window (64, 128), iq/ip (8, 128);
- G5 K6 ``window_gather_tiled``: 64 tiles of (256, 128), window blocks
  t % 4 of (256, 128).

Each row is timed with CUDA events (mean of the script's 50 launches,
20 for G5, after 3 warm-ups) beside its bytes bound (inputs, indices and
output once at 3.35 TB/s), its plain version's time and, for K3/K4,
``torch.gather``'s (one library call for the same function, timed only:
``library_ms``).  At these sizes the eager time is mostly the host's
cost of issuing a launch, so each row also times the same launches
replayed from one CUDA graph (``graph_ms``, and ``library_graph_ms`` for
``torch.gather``: the work on the device, without that cost), and the
host's wall time per eager call (``host_us``, ``library_host_us``:
HOST_CALLS calls each, synchronised only at the end of each of HOST_ROUNDS
rounds, the wrapper's and ``torch.gather``'s rounds taken in turn so the
host's drift falls on both alike).  Where the device time of a launch
exceeds its issue cost (K6), ``host_us`` is the device's rate.

The replays above find the inputs in the 50 MB L2 from the second launch
on (K6's are 25 MB).  A real caller, an SpMV that streams its indices,
finds them cold, so the K5 and K6 rows also give ``cold_ms``: the mean
device time of the same number of launches, each timed alone by CUDA
events around it, after writing FLUSH_BYTES of scratch, which evicts the
L2.  Their share of the bound is taken on ``cold_ms``.  ``main`` also
times G4 and G5 with every iq moved past the window (the same launches
with no window value: what the index loads, shuffles and stores alone
cost).

It needs a card: without one, or when a launch fails, it exits non-zero
(no row is skipped).  ``window_checks`` gives the cases on which the
card tests and ``chip_smoke.py`` hold K5 and K6 to their plain versions.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from frontistr_tpu_torch.ops import gather as g

HBM_BYTES_S = 3.35e12   # NVIDIA H100 SXM data sheet
WARMUP = 3
HOST_CALLS = 4000
HOST_ROUNDS = 8
FLUSH_BYTES = 256 << 20  # written before each cold launch: 5x the L2
COLD = ("K5", "K6")      # the rows timed cold as well


def inputs(device) -> dict:
    """The script's inputs, drawn in its order from default_rng(0)."""
    rng = np.random.default_rng(0)

    def f32(shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=device)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    out = {}
    out["G1"] = (f32((8, 1024)), i32(rng.integers(0, 8, (8, 1024))))
    out["G2"] = (f32((8, 128)), i32(rng.integers(0, 128, (8, 128))))
    out["G3"] = (f32((8, 512)), i32(rng.integers(0, 512, (8, 512))))
    w = f32((64, 128))
    flat = rng.integers(0, 8 * 1024, (8, 128))
    out["G4"] = (w, i32(flat // 128), i32(flat % 128))
    wb = f32((4 * 64, 128))
    flatb = rng.integers(0, 8 * 1024, (64 * 256, 128))
    out["G5"] = (wb, i32(flatb // 128), i32(flatb % 128))
    return out


# row: (label, kernel id, wrapper, plain version, library call or None)
ROWS = (
    ("G1 taa axis=0 src (8,1024)", "K3", g.gather_rows,
     g.gather_rows_reference, lambda x, i: torch.gather(x, 0, i)),
    ("G2 taa axis=1 src (8,128)", "K4", g.gather_cols,
     g.gather_cols_reference, lambda x, i: torch.gather(x, 1, i)),
    ("G3 taa axis=1 src (8,512)", "K4", g.gather_cols,
     g.gather_cols_reference, lambda x, i: torch.gather(x, 1, i)),
    ("G4 cascade shuffle win=8K out (8,128)", "K5", g.window_gather,
     g.window_gather_reference, None),
    ("G5 cascade tiles 64x(256,128) win 8K", "K6", g.window_gather_tiled,
     lambda w, iq, ip: g.window_gather_tiled_reference(w, iq, ip, 256, 64),
     None),
)


def window_checks(device) -> list:
    """(label, wrapper, plain version, args, kwargs) of K5 and K6 on
    random inputs: K6 at tile_rows 1, 37 and 256, on 1, 3 and 4 window
    blocks of 8 and of 64 rows, over 999 rows (no multiple of any rows
    a block takes); K5 at 13, 999 and 70,001 rows and K6 at 70,001 (more
    rows than the card holds warps at once).  Every window block is
    read; iq reaches every 8-row vreg v of the window and 3 past each
    side; ip wraps from [-128, 0) and leaves [-128, 128) on both
    sides."""
    rng = np.random.default_rng(17)
    dev = torch.device(device)

    def args(S, win_rows, nwin=1):
        w = rng.standard_normal((nwin * win_rows, 128)).astype(np.float32)
        return tuple(torch.as_tensor(a, device=dev) for a in (
            w, rng.integers(-24, win_rows + 24, (S, 128)).astype(np.int32),
            rng.integers(-140, 140, (S, 128)).astype(np.int32)))

    out = []
    for win_rows in (8, 64):
        for nwin in (1, 3, 4):
            for tile_rows in (1, 37, 256):
                kw = dict(tile_rows=tile_rows, win_rows=win_rows)
                out.append((f"K6 S=999 tile_rows={tile_rows} nwin={nwin} "
                            f"win_rows={win_rows}", g.window_gather_tiled,
                            g.window_gather_tiled_reference,
                            args(999, win_rows, nwin), kw))
    for S, win_rows in ((13, 8), (999, 64), (70001, 64)):
        out.append((f"K5 S={S} win_rows={win_rows}", g.window_gather,
                    g.window_gather_reference, args(S, win_rows), {}))
    out.append(("K6 S=70001 tile_rows=256 nwin=4 win_rows=64",
                g.window_gather_tiled, g.window_gather_tiled_reference,
                args(70001, 64, 4), dict(tile_rows=256, win_rows=64)))
    return out


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches (CUDA events), after
    WARMUP untimed launches."""
    for _ in range(WARMUP):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, each after writing
    FLUSH_BYTES of scratch (so it finds the L2 cold), CUDA events around
    each launch alone.  The device is held first while the host queues
    every launch, so no event waits on the host."""
    for _ in range(WARMUP):
        fn()
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32,
                          device="cuda")
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000 * reps)    # about 0.1 ms a launch
    for start, end in events:
        scratch.fill_(1)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time per launch of fn() when reps launches are
    replayed from one captured CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, 5) / reps


def host_us(fns) -> list:
    """Host wall time (us) per eager call of each of ``fns``, over
    HOST_CALLS calls each in HOST_ROUNDS rounds taken in turn, each round
    synchronised only at its end."""
    for fn in fns:
        for _ in range(WARMUP):
            fn()
    torch.cuda.synchronize()
    per = HOST_CALLS // HOST_ROUNDS
    total = [0] * len(fns)
    for _ in range(HOST_ROUNDS):
        for j, fn in enumerate(fns):
            t0 = time.perf_counter_ns()
            for _ in range(per):
                fn()
            torch.cuda.synchronize()
            total[j] += time.perf_counter_ns() - t0
    return [t / (per * HOST_ROUNDS) / 1e3 for t in total]


def run(device="cuda") -> list:
    """Time every row on ``device`` (a card); returns one dict a row."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the gather microbenchmark needs a CUDA card")
    data = inputs(dev)
    rows = []
    for label, kid, kern, plain, library in ROWS:
        gid = label[:2]
        args = data[gid]
        reps = 20 if gid == "G5" else 50
        out = kern(*args)
        nbytes = sum(a.numel() * a.element_size() for a in args) \
            + out.numel() * out.element_size()
        row = {"row": gid, "kernel": kid, "label": label,
               "shape": list(out.shape), "bytes": nbytes,
               "ms": cuda_ms(lambda: kern(*args), reps),
               "graph_ms": graph_ms(lambda: kern(*args), reps),
               "bound_ms": nbytes / HBM_BYTES_S * 1e3,
               "plain_ms": cuda_ms(lambda: plain(*args), reps),
               "library_ms": None, "library_graph_ms": None,
               "library_host_us": None}
        if kid in COLD:
            row["cold_ms"] = cold_ms(lambda: kern(*args), reps)
        if library is None:
            row["host_us"], = host_us([lambda: kern(*args)])
        else:
            x, i64 = args[0], args[1].long()
            row["library_ms"] = cuda_ms(lambda: library(x, i64), reps)
            row["library_graph_ms"] = graph_ms(lambda: library(x, i64), reps)
            row["host_us"], row["library_host_us"] = host_us(
                [lambda: kern(*args), lambda: library(x, i64)])
        rows.append(row)
    return rows


def main(argv=None) -> int:
    rows = run("cuda")
    for r in rows:
        lib = "" if r["library_ms"] is None else \
            (f"  torch.gather {r['library_ms']:9.4f} ms, from a graph "
             f"{r['library_graph_ms'] * 1e3:8.3f} us, host "
             f"{r['library_host_us']:7.3f} us")
        cold = "" if "cold_ms" not in r else \
            (f", cold {r['cold_ms'] * 1e3:8.3f} us "
             f"({r['bound_ms'] / r['cold_ms']:.1%} of the bound)")
        print(f"{r['label']:48s} {r['ms']:9.4f} ms, from a graph "
              f"{r['graph_ms'] * 1e3:8.3f} us{cold}, host "
              f"{r['host_us']:7.3f} us  (bound {r['bound_ms'] * 1e3:8.3f} "
              f"us, {r['bytes']} B; plain {r['plain_ms']:9.4f} ms{lib})")
    data = inputs("cuda")
    for gid, kern, reps in (("G4", g.window_gather, 50),
                            ("G5", g.window_gather_tiled, 20)):
        w, iq, ip = data[gid]
        past = iq + 64      # every v = iq // 8 in [8, 16): no window value
        print(f"   {gid} with every iq past the window: from a graph "
              f"{graph_ms(lambda: kern(w, past, ip), reps) * 1e3:8.3f} us, "
              f"cold {cold_ms(lambda: kern(w, past, ip), reps) * 1e3:8.3f} "
              "us")
    dt = rows[-1]["ms"] / 1e3
    vals = 64 * 256 * 128
    print(f"   -> {vals / dt / 1e9:.2f} G gathered f32/s "
          f"(SpMV needs ~32M: {32e6 * dt / vals * 1e3:.1f} ms)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
