"""The shell cell of ``chip_smoke.py`` (a clamped square MITC4 plate
under a uniform pressure, linear STATIC through ``run_directory``, the
mixed and the f64 policy) at other sizes, thicknesses and tolerances,
on the card: how the block-Jacobi CG count, its time and the true
residual move with span/thickness.

    python -m frontistr_tpu_torch.microbench.shell_plate \\
        [--runs 408:10 408:20 408:50] [--resid 1.0e-8]

Run it from the repository root (it runs ``chip_smoke``'s phase
functions).  Each run ``n:t`` is the plate of n x n elements, a =
1000 mm, thickness t mm; per policy it prints the CG count, the
refinement passes, ms a CG iteration, the phase split, peak memory,
the independent ``index_add_`` true relres, the support reactions
against q a^2 and the centre deflection against the clamped thin-plate
value, then K1's nd = 6 entry at the plate's plan.  A run whose true
relres misses the smoke's 1e-8 gate prints the failure and goes on.
It needs a card; it prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", nargs="+", default=["408:10", "408:20",
                                                  "408:50"])
    ap.add_argument("--resid", default="1.0e-8")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("shell_plate: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    mods = cs.load_mods()
    mods["kernels"].build()
    failed = 0
    for run in args.runs:
        n, t = run.split(":")
        try:
            cell = cs.phase_shell_main_path(
                argparse.Namespace(shell_n=int(n)), mods, t=float(t),
                resid=args.resid)
        except AssertionError as e:
            print(f"shell_plate {run}: gate failed: {e}", flush=True)
            failed += 1
            torch.cuda.empty_cache()
            continue
        cs.phase_k1_nd6_time(mods, cell.pop("model"), cell.pop("kes"),
                             cell)
        del cell
        torch.cuda.empty_cache()
    return 0 if not failed else 2


if __name__ == "__main__":
    sys.exit(main())
