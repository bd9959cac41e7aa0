"""The hex20_mpc deck of ``chip_smoke.py`` at several box sizes and loads,
on the card: where Newton converges, and how far the material is
compressed there.

    python -m frontistr_tpu_torch.microbench.hex20_load \\
        [--runs 16:1 24:1 32:1 44:0.5 44:0.75 44:1] [--maxiter 7] \\
        [--cap-s 200] [--neohooke] [--substeps 1]

Run it from the repository root (it builds the deck with
``chip_smoke.py``'s helpers).  Each run ``n:scale`` is the smoke's
hex20_mpc deck (X0 fixed, every X1 node's u_z tied to the node at X1's
middle, a !SPRING of 1e-3 E A / L there, f64 policy, CG with AMG to
1e-8, NIER 10000) on a shuffled hex20 box of n with a total !CLOAD of
``-scale * 5985`` (5,985 is the X1 node count of the box of 44, the
load the cell was specified with), one substep of at most ``--maxiter``
Newton iterations and the driver's cutbacks.  It prints the card's
name and power limit, every CG solve's iterations and relative
residual, every Newton iteration's residuals and, after every
substep, the smallest and largest principal stretch sqrt(eig(F^T F))
over the elements' 27 integration points of ``u + du``.  The
material is linear in the Green-Lagrange strain (St. Venant-
Kirchhoff): in uniaxial compression its first Piola stress falls again
below a stretch of 1/sqrt(3) = 0.577.  ``--neohooke`` gives the block
!HYPERELASTIC, TYPE=NEOHOOKE instead (the same E and nu; its energy
grows without bound as J -> 0), ``--substeps`` the load in that many
substeps.  ``--cap-s`` ends a run after that many seconds.  It needs a
card.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

from frontistr_tpu_torch.analysis import nonlinear
from frontistr_tpu_torch.elements.tables import get_table

CELL_LOAD = 5985.0          # X1's node count on the hex20 box of 44


class _Capped(Exception):
    pass


def stretches(model, u):
    """(min, max) principal stretch over the 27 integration points of
    every hex20 element at the displacement ``u`` (n_node, 3)."""
    blk = model.mesh.blocks[0]
    dN = torch.as_tensor(get_table(362).dN, dtype=torch.float64,
                         device=u.device)                  # (27, 20, 3)
    conn = torch.as_tensor(blk.conn.astype(np.int64), device=u.device)
    X = torch.as_tensor(model.mesh.coords, dtype=torch.float64,
                        device=u.device)
    lo, hi = np.inf, 0.0
    for c in torch.split(conn, 8192):
        Xe, ue = X[c], u.reshape(-1, 3)[c].to(torch.float64)
        J = torch.einsum("eai,paj->epij", Xe, dN)
        G = torch.einsum("eai,paj,epjk->epik", ue, dN, torch.linalg.inv(J))
        F = G + torch.eye(3, dtype=G.dtype, device=G.device)
        # on the host: the batched eigvalsh of cuSOLVER refuses a batch
        # of this many 3 x 3 matrices
        lam = torch.linalg.eigvalsh((F.transpose(-1, -2) @ F).cpu()).sqrt()
        lo, hi = min(lo, float(lam.min())), max(hi, float(lam.max()))
    return lo, hi


def _traced_pcg(real):
    def pcg(*a, **kw):
        res = real(*a, **kw)
        print(f"    cg: iters={res.iters} relres={res.relres:.3e}",
              flush=True)
        return res
    return pcg


def run(cs, mods, n, scale, maxiter, cap_s, neohooke=False, substeps=1):
    mesh = cs.hex20_mesh(mods, (n, n, n))
    x1 = mesh.node_groups["X1"]
    mid = x1[np.argmin(np.linalg.norm(mesh.coords[x1] - [1.0, 0.5, 0.5],
                                      axis=1))]
    mast = cs.tie_face(mods, mesh, master=mid)
    cnt = cs.MPCCNT.format(mast=int(mesh.node_ids[mast]),
                           load=-scale * CELL_LOAD, k=210.0, method="CG",
                           resid="1.0e-8").replace(
        "!STEP, SUBSTEPS=1\n", (cs.HYPER_LAW if neohooke else "")
        + f"!STEP, SUBSTEPS={substeps}, MAXITER={maxiter}\n")
    wd = os.path.join(cs.ROOT, "build", "hex20_load",
                      f"n{n}_s{scale}" + ("_neohooke" if neohooke else ""))
    cs.write_shuffled(wd, mods, mesh, cnt)
    print(f"run n={n} scale={scale}: {3 * mesh.n_node} dofs, total load "
          f"{-scale * CELL_LOAD!r}, {'NEOHOOKE' if neohooke else 'SVK'}, "
          f"{substeps} substep(s)", flush=True)
    real = nonlinear._newton_substep

    def substep(model, programs, states, u, *a, **kw):
        out = real(model, programs, states, u, *a, **kw)
        lo, hi = stretches(model, u + out[1])
        print(f"  substep {kw.get('tag')}: converged={out[0]} "
              f"iterations={out[3]} stretch min={lo!r} max={hi!r}",
              flush=True)
        return out

    def alarm(*_):
        raise _Capped()
    nonlinear._newton_substep = substep
    signal.signal(signal.SIGALRM, alarm)
    signal.alarm(cap_s)
    t0 = time.perf_counter()
    try:
        res = mods["run_directory"](wd, device="cuda")["static"]
        verdict = (f"converged, {res.newton.total_iters} Newton iterations, "
                   f"{res.newton.cutbacks} cutbacks")
    except _Capped:
        verdict = f"capped at {cap_s} s"
    except RuntimeError as e:
        verdict = f"failed: {e}"
    finally:
        signal.alarm(0)
        nonlinear._newton_substep = real
    print(f"  n={n} scale={scale}: {verdict}; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", nargs="+",
                    default=["16:1", "24:1", "32:1", "44:0.5", "44:0.75",
                             "44:1"])
    ap.add_argument("--maxiter", type=int, default=7)
    ap.add_argument("--cap-s", type=int, default=200)
    ap.add_argument("--neohooke", action="store_true")
    ap.add_argument("--substeps", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hex20_load: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    mods = cs.load_mods()
    nonlinear.pcg = _traced_pcg(nonlinear.pcg)
    os.environ["FRONTISTR_TPU_PRECISION"] = "f64"
    os.environ["FRONTISTR_TPU_DEBUG_NEWTON"] = "1"
    for r in args.runs:
        n, scale = r.split(":")
        run(cs, mods, int(n), float(scale), args.maxiter, args.cap_s,
            args.neohooke, args.substeps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
