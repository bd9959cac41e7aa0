"""Trace of the Newton driver's linear solves on the card, pass by pass.

    python -m frontistr_tpu_torch.microbench.newton_trace \\
        [--n 69] [--load -1.0] [--policy mixed|f64] [--cap-s 300]

Runs the NLSTATIC deck of ``bench.py:83-88`` (X0 fixed, ``CLOAD X1, 3,
load``, E=210000, nu=0.3, one substep, CG to 1e-8) on a shuffled
``box_tet4(n, n, n)`` through ``run.run_directory`` in the given solve
policy, and prints as they happen: every CG run (iterations, its own
relative residual, seconds), in the mixed policy the true float64
relative residual after every refinement pass, and the Newton residuals
of every iteration.  ``--cap-s`` stops the run after that many seconds
(exit code 3) so that a stalled solve costs a bounded time.  It needs a
card.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time

import numpy as np
import torch

from frontistr_tpu_torch import ordering
from frontistr_tpu_torch.analysis import nonlinear
from frontistr_tpu_torch.io.neu import write_static_workdir
from frontistr_tpu_torch.meshgen import box_tet4
from frontistr_tpu_torch.run import run_directory
from frontistr_tpu_torch.solver import mixed

DECK = ("!VERSION\n 3\n!SOLUTION, TYPE=NLSTATIC\n!BOUNDARY\n X0, 1, 3, 0.0\n"
        "!CLOAD\n X1, 3, {load}\n!MATERIAL, NAME=M1\n!ELASTIC\n"
        " 210000.0, 0.3\n!STEP, SUBSTEPS=1\n BOUNDARY, 1\n LOAD, 1\n"
        "!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
        " 1.0e-8, 1.0, 0.0\n!END\n")


class _Capped(Exception):
    pass


def _traced_pcg(real, tag):
    def pcg(*a, **kw):
        t0 = time.perf_counter()
        res = real(*a, **kw)
        torch.cuda.synchronize()
        print(f"    {tag}: iters={res.iters} relres={res.relres:.3e} "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        return res
    return pcg


def _traced_rel(real):
    def rel(r, bnrm):
        v = real(r, bnrm)
        print(f"      true relres {float(v):.3e}", flush=True)
        return v
    return rel


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=69)
    ap.add_argument("--load", type=float, default=-1.0)
    ap.add_argument("--policy", choices=("mixed", "f64"), default="mixed")
    ap.add_argument("--cap-s", type=int, default=0,
                    help="stop after this many seconds (0: no cap)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("newton_trace: needs a CUDA card", file=sys.stderr)
        return 1
    os.environ["FRONTISTR_TPU_PRECISION"] = args.policy
    os.environ["FRONTISTR_TPU_DEBUG_NEWTON"] = "1"
    mixed.pcg = _traced_pcg(mixed.pcg, "cg f32")
    nonlinear.pcg = _traced_pcg(nonlinear.pcg, "cg f64")
    mixed._rel = _traced_rel(mixed._rel)
    wd = os.path.join("build", "trace", f"newton{args.n}")
    mesh = box_tet4(args.n, args.n, args.n)
    order = np.random.default_rng(3).permutation(mesh.n_node)
    write_static_workdir(wd, ordering.permute_mesh(mesh, order),
                         DECK.format(load=args.load))
    print(f"newton_trace: box_tet4({args.n}) {3 * mesh.n_node} dofs, load "
          f"{args.load}, policy {args.policy}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    def stop(signum, frame):
        raise _Capped()

    if args.cap_s:
        signal.signal(signal.SIGALRM, stop)
        signal.alarm(args.cap_s)
    t0 = time.perf_counter()
    try:
        out = run_directory(wd, device="cuda")
    except _Capped:
        print(f"newton_trace: stopped at the cap of {args.cap_s} s",
              flush=True)
        return 3
    finally:
        signal.alarm(0)
    res = out["static"]
    tm = " ".join(f"{k}={v:.3f}" for k, v in res.timings.items())
    print(f"newton_trace: {time.perf_counter() - t0:.2f} s, "
          f"{res.newton.total_iters} Newton iterations; {tm}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
