"""K1's element kernel at the Newton cell's shapes.

    python -m frontistr_tpu_torch.microbench.segsum [--n 69] [--reps 10]

Builds the cluster profile of the Newton cell's mesh (``box_tet4(n, n,
n)``, node numbers shuffled with seed 3 and reordered as
``run.run_directory`` does: 31,536,864 pair entries in 41,160,000 slots
at n=69) and random element matrices, then times the element kernel
(``assembly/segsum.py`` ``segsum``, CUDA events, mean of ``reps``
launches after 2) in float64 and float32:

- the host seconds of the plan and of its element schedule, the first
  time in the process and again;
- the kernel and its two passes apart (``torch.profiler``);
- ``index_add_`` of the entries already in slot order;
- the stores alone: the same slot space with no entries, beside one
  memset of the planes.

It needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from frontistr_tpu_torch import ordering
from frontistr_tpu_torch.assembly import bell
from frontistr_tpu_torch.assembly import segsum as sm
from frontistr_tpu_torch.meshgen import box_tet4


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_split(fn, reps: int) -> dict:
    """Device ms per call of each kernel ``fn`` launches (torch.profiler,
    ``reps`` calls after one)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.device_time_total / 1e3 / reps
            for e in prof.key_averages() if e.device_time_total > 0}


def newton_profile(n: int) -> bell.ClusterProfile:
    """The cluster profile ``chip_smoke.py``'s Newton deck assembles."""
    mesh = box_tet4(n, n, n)
    order = np.random.default_rng(3).permutation(mesh.n_node)
    mesh = ordering.maybe_reorder(ordering.permute_mesh(mesh, order),
                                  verbose=False)
    return bell.build_cluster_profile([mesh.blocks[0].conn], mesh.n_node,
                                      3)


def build_seconds(prof, dev) -> dict:
    """Host seconds (to a synchronize) of the plan and of its float64
    element schedule, the first time in the process and again."""
    got = {}
    for turn in ("first", "again"):
        prof.__dict__.pop("_plans", None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = prof.plan(dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sm.element_schedule(plan, [4], 3, 8)
        torch.cuda.synchronize()
        got[turn] = dict(plan_s=t1 - t0, schedule_s=time.perf_counter() - t1)
    return got


def run(n: int, reps: int) -> list:
    dev = torch.device("cuda")
    prof = newton_profile(n)
    print(json.dumps(dict(build=build_seconds(prof, dev))), flush=True)
    plan = prof.plan(dev)
    E = plan.pair_counts[0] // 16
    gen = torch.Generator(device=dev).manual_seed(0)
    ke64 = torch.randn((E, 12, 12), dtype=torch.float64, device=dev,
                       generator=gen)
    rows = []
    for dt in (torch.float64, torch.float32):
        kes = [ke64.to(dt)]
        ent = sm.entry_planes(kes, [4], 3)[:, plan.perm.long()]
        out = torch.zeros((9, plan.n_slots), dtype=dt, device=dev)
        seg = plan.seg_sorted.long()
        library_ms = cuda_ms(lambda: out.index_add_(1, seg, ent), reps)
        del ent
        sc = sm.element_schedule(plan, [4], 3, kes[0].element_size())
        rb = sc.rb_ptr.diff()
        row = dict(dtype=str(dt)[6:], tile_slots=sc.bw << sc.ct_log2,
                   n_tiles=sc.n_tiles, stage_rb=sc.stage_rb,
                   staged_tiles=int((rb <= sc.stage_rb).sum()),
                   ms=cuda_ms(lambda: sm.segsum(plan, kes, [4], 3), reps),
                   passes=kernel_split(lambda: sm.segsum(plan, kes, [4], 3),
                                       reps),
                   library_ms=library_ms)
        del kes
        # the stores alone: a plan of the same slot space with no entries,
        # every slot written 0; beside it one memset of the planes
        empty = sm.make_plan(np.zeros(0, np.int32), np.zeros(0, np.int32),
                             plan.n_slots, (0,), dev, plan.shape)
        zeros = [torch.zeros((0, 12, 12), dtype=dt, device=dev)]
        row.update(no_entries_ms=cuda_ms(
            lambda: sm.segsum(empty, zeros, [4], 3), reps),
            memset_ms=cuda_ms(lambda: out.zero_(), reps))
        del out
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=69)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("microbench.segsum: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    run(args.n, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
