"""The structured box solve of ``bench.py:195-404`` (``_box_arm``): a
geometric two-grid preconditioned CG on the dof-major stencil operator
of ``box_hex8(n, n, n)`` (n % 3 == 0), refined in f64 to a true relres
of 1e-8.

    python -m frontistr_tpu_torch.microbench.box_twogrid [--n 69]
        [--device cuda]

- X0 fixed, X1 loaded -1 in z per node, E = 210000, nu = 0.3; default
  n = 69: 1,029,000 dofs, 328,509 elements.
- Inner solve: f32 PCG (``solver/cg.pcg``) on
  ``StructuredHexOperatorD`` (K2 on the card) to 1e-3, in chunks of 600
  iterations restarted up to 6 times; the preconditioner is
  ``solver/mg.make_twogrid`` with the coarse box of n/3 (V(1,1),
  omega 0.6, a degree-20 Chebyshev coarse solve on [lmax/100, lmax]).
- ``coarse_lmax``: 15 power iterations on the block-Jacobi
  preconditioned coarse operator, times 1.05; the start vector comes
  from a ``torch.Generator`` seeded 7 unless one is passed.
- Outer: up to 6 refinement passes against the f64 residual of
  ``StructuredHexOperatorConstD`` (one (24, 24) element matrix from
  ``fem/solid.stiffness_linear_iso``), stopping at relres <= 1e-8.

``main()`` prints the CG count per pass, the final relres by both f64
operators (the one-element ``ConstD`` and the node-major
``StructuredHexOperator`` through K2), the phase times, K2's launches
at each element count, the card's name and power limit, and on the card
``split``: where a CG iteration's time goes.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from frontistr_tpu_torch.assembly.structured import (
    StructuredHexOperator, StructuredHexOperatorConstD,
    StructuredHexOperatorD, from_dof_major, soa_from_blocks)
from frontistr_tpu_torch.device import resolve, synchronize
from frontistr_tpu_torch.elements.tables import get_table
from frontistr_tpu_torch.fem import solid
from frontistr_tpu_torch.fem.material import D3, elastic_D
from frontistr_tpu_torch.meshgen import box_hex8
from frontistr_tpu_torch.ops.element_mv import element_matvec_soa
from frontistr_tpu_torch.microbench.dynamic_step import kernel_times
from frontistr_tpu_torch.microbench.segsum import cuda_ms
from frontistr_tpu_torch.solver.cg import pcg
from frontistr_tpu_torch.solver.mg import (chebyshev_apply, make_transfers,
                                           make_twogrid)

YOUNGS, POISSON = 210e3, 0.3
INNER_TOL = 1e-3          # each pass's f32 CG; it floors near eps32 cond
CG_CHUNK = 600
MAX_CHUNKS = 6
MAX_PASSES = 6
RELRES = 1e-8


@dataclasses.dataclass
class Box:
    """One box of the two grids: its size, mesh and dof-major masks."""
    n: int
    mesh: object
    free: np.ndarray           # (3 * n_node,) dof-major
    f: np.ndarray              # (3 * n_node,) dof-major load


def make_box(n: int) -> Box:
    mesh = box_hex8(n, n, n)
    free = np.ones((3, mesh.n_node))
    free[:, mesh.node_groups["X0"]] = 0.0
    f = np.zeros((3, mesh.n_node))
    f[2, mesh.node_groups["X1"]] = -1.0
    return Box(n, mesh, free.reshape(-1), f.reshape(-1))


def assemble_soa(box: Box, dtype, device) -> torch.Tensor:
    """Element matrices of the whole box straight into the SoA layout
    (24, 24, E), in ``dtype``."""
    conn = torch.as_tensor(box.mesh.blocks[0].conn.astype(np.int64),
                           device=device)
    coords = torch.as_tensor(box.mesh.coords, dtype=dtype, device=device)
    D = torch.as_tensor(elastic_D(YOUNGS, POISSON, D3)[None], dtype=dtype,
                        device=device)
    return soa_from_blocks(solid.stiffness_linear(get_table(361),
                                                  coords[conn], D))


def one_element_ke(box: Box, device) -> torch.Tensor:
    """The f64 (24, 24) matrix every element of the uniform box shares."""
    lam = YOUNGS * POISSON / ((1 + POISSON) * (1 - 2 * POISSON))
    mu = YOUNGS / (2 * (1 + POISSON))
    conn = box.mesh.blocks[0].conn[:1].astype(np.int64)
    x = torch.as_tensor(box.mesh.coords[conn], dtype=torch.float64,
                        device=device)
    return solid.stiffness_linear_iso(get_table(361), x, lam, mu)[0]


def coarse_lmax(opc: StructuredHexOperatorD,
                v0: Optional[torch.Tensor] = None,
                iters: int = 15) -> torch.Tensor:
    """1.05 x the largest eigenvalue of the block-Jacobi preconditioned
    coarse operator by power iteration, as a 0-d float32 CPU tensor (so
    the Chebyshev scalars stay float32 on the host)."""
    M = opc.block_jacobi()
    n = opc.free_mask.numel()
    if v0 is None:
        gen = torch.Generator().manual_seed(7)
        v0 = torch.randn(n, generator=gen, dtype=torch.float32)
    v = v0.to(device=opc.keT.device, dtype=torch.float32)
    v = v / torch.linalg.norm(v)
    nrm = torch.ones((), dtype=torch.float32)
    for _ in range(iters):
        w = M(opc.apply_constrained(v))
        nrm = torch.linalg.norm(w)
        v = w / nrm
    return (nrm * 1.05).cpu()


@dataclasses.dataclass
class BoxResult:
    x: torch.Tensor            # (n_dof,) f64 dof-major displacement
    cg_iters: int              # all passes
    cg_per_pass: list          # CG iterations of each refinement pass
    chunks_per_pass: list      # PCG calls (restarts + 1) of each pass
    relres: float              # final true relres (ConstD, f64)
    lmax_c: float
    timings: dict              # s: asm32+lmax, cg_pass_<i>, final_resid
    n_dof: int
    n_elem: int
    n_elem_coarse: int
    ops: dict                  # op, opc (f32 D), restrict, M, lmax_c


def solve(n: int = 69, device="cuda", v0=None,
          fine: Optional[Box] = None) -> BoxResult:
    """The box arm's solve on ``box_hex8(n)``; ``v0`` (a coarse-grid
    vector) replaces the seeded power-iteration start."""
    if n % 3:
        raise ValueError(f"box_twogrid: n={n} is not a multiple of 3")
    dev = resolve(device)
    fine = fine or make_box(n)
    coarse = make_box(n // 3)
    f32, f64 = torch.float32, torch.float64
    free32 = torch.as_tensor(fine.free, dtype=f32, device=dev)
    free64 = torch.as_tensor(fine.free, dtype=f64, device=dev)
    freec32 = torch.as_tensor(coarse.free, dtype=f32, device=dev)
    f = torch.as_tensor(fine.f, dtype=f64, device=dev)
    stamps = {}

    synchronize(dev)
    t0 = time.perf_counter()
    op = StructuredHexOperatorD(n, n, n, assemble_soa(fine, f32, dev),
                                free32)
    opc = StructuredHexOperatorD(coarse.n, coarse.n, coarse.n,
                                 assemble_soa(coarse, f32, dev), freec32)
    lmax_c = coarse_lmax(opc, v0)
    op64 = StructuredHexOperatorConstD(n, n, n, one_element_ke(fine, dev),
                                       free64)
    synchronize(dev)
    stamps["asm32+lmax"] = time.perf_counter() - t0
    prolong, restrict = make_transfers(n, n, n, 3, dtype=f32, device=dev)
    M = make_twogrid(op, opc, prolong, restrict, lmax_c)

    def residual64(x):
        return f * free64 - op64.matvec(x * free64) * free64

    bnrm = float(np.linalg.norm(fine.f))
    x = torch.zeros(f.numel(), dtype=f64, device=dev)
    per_pass, chunks = [], []
    for p in range(MAX_PASSES):
        r = residual64(x)
        if float(torch.linalg.norm(r)) / bnrm <= RELRES:
            break
        t0 = time.perf_counter()
        b32 = r.to(f32)
        dx = torch.zeros_like(b32)
        its = 0
        for k in range(MAX_CHUNKS):
            res = pcg(op.apply_constrained, b32, M=M, x0=dx, tol=INNER_TOL,
                      maxiter=CG_CHUNK)
            dx, its = res.x, its + res.iters
            if res.relres <= INNER_TOL:
                break
        x = x + dx.to(f64)
        per_pass.append(its)
        chunks.append(k + 1)
        synchronize(dev)
        stamps[f"cg_pass_{p + 1}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    relres = float(torch.linalg.norm(residual64(x))) / bnrm
    stamps["final_resid"] = time.perf_counter() - t0
    return BoxResult(x=x, cg_iters=sum(per_pass), cg_per_pass=per_pass,
                     chunks_per_pass=chunks, relres=relres,
                     lmax_c=float(lmax_c), timings=stamps,
                     n_dof=f.numel(), n_elem=n ** 3,
                     n_elem_coarse=coarse.n ** 3,
                     ops=dict(op=op, opc=opc, restrict=restrict, M=M,
                              lmax_c=lmax_c))


def _wall_ms(fn, reps: int) -> float:
    """Host wall ms per call of ``fn`` (one call first, synchronized)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def split(res: BoxResult) -> dict:
    """Where a CG iteration of the solve goes, on the card: for a whole
    iteration (``pcg`` run 10 iterations past its tolerance), the
    fine product ``A``, the two-grid ``M`` and its degree-20 coarse solve
    alone, the host wall ms per call and the device ms per call summed
    over the kernels ``torch.profiler`` records, with the launches; the
    device-busy share is device over wall.  K2's device ms a CG
    iteration, and K2 alone at the fine and the coarse shape (CUDA
    events)."""
    iters = 10
    o = res.ops
    op, opc, M = o["op"], o["opc"], o["M"]
    gen = torch.Generator(device="cuda").manual_seed(11)
    b = torch.randn(res.n_dof, generator=gen, device="cuda") * op.free_mask
    rc = o["restrict"](b) * opc.free_mask
    Dc = opc.block_jacobi()
    parts = {
        "cg_iteration": lambda: pcg(op.apply_constrained, b, M=M, tol=0.0,
                                    maxiter=iters),
        "fine_product": lambda: op.apply_constrained(b),
        "two_grid": lambda: M(b),
        "coarse_solve": lambda: chebyshev_apply(opc.apply_constrained, Dc,
                                                o["lmax_c"], 20, rc),
    }
    out = {}
    for name, fn in parts.items():
        per = iters if name == "cg_iteration" else 1
        reps = 2 if name == "cg_iteration" else 20
        wall = _wall_ms(fn, reps) / per
        kern, launches = kernel_times(fn, reps)
        out[name] = dict(wall_ms=wall,
                         device_ms=sum(kern.values()) / per,
                         launches=launches / per,
                         k2_device_ms=sum(v for k, v in kern.items()
                                          if "element_mv_kernel" in k)
                         / per)
        out[name]["busy_share"] = out[name]["device_ms"] / wall
    xf = torch.randn((24, res.n_elem), generator=gen, device="cuda")
    xc = torch.randn((24, res.n_elem_coarse), generator=gen, device="cuda")
    out["k2_fine_ms"] = cuda_ms(lambda: element_matvec_soa(op.keT, xf), 20)
    out["k2_coarse_ms"] = cuda_ms(lambda: element_matvec_soa(opc.keT, xc),
                                  50)
    return out


def node_major_relres(box: Box, x: torch.Tensor) -> float:
    """The true relres of a dof-major answer by the node-major f64
    ``StructuredHexOperator`` (every element assembled, K2 on the
    card): an operator and a layout independent of the solve's."""
    dev = x.device
    n = box.n
    nn = box.mesh.n_node
    keT = assemble_soa(box, torch.float64, dev)
    free = from_dof_major(torch.as_tensor(box.free, dtype=torch.float64,
                                          device=dev), nn)
    f = from_dof_major(torch.as_tensor(box.f, dtype=torch.float64,
                                       device=dev), nn)
    op = StructuredHexOperator(n, n, n, keT, free)
    u = from_dof_major(x, nn)
    r = f * free - op.matvec(u * free) * free
    return float(torch.linalg.norm(r) / torch.linalg.norm(f))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=69,
                    help="box_hex8(n, n, n), n a multiple of 3 (default 69)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    fine = make_box(args.n)
    element_matvec_soa.launches = 0
    element_matvec_soa.launches_by_e.clear()
    res = solve(args.n, dev, fine=fine)
    launches = dict(element_matvec_soa.launches_by_e)
    rr_node = node_major_relres(fine, res.x)
    print(f"box_twogrid: box_hex8({args.n}) {res.n_dof} dofs, "
          f"{res.n_elem} elements (coarse {res.n_elem_coarse}); "
          f"lmax_c={res.lmax_c!r}", flush=True)
    print(f"  cg_iters={res.cg_iters} per pass {res.cg_per_pass} "
          f"(chunks {res.chunks_per_pass}); relres ConstD={res.relres!r} "
          f"node-major={rr_node!r}", flush=True)
    print("  " + " ".join(f"{k}={v:.3f}" for k, v in res.timings.items())
          + f"; K2 launches by E {launches}", flush=True)
    if dev.type == "cuda":
        for k, v in split(res).items():
            print(f"  split {k}: {v}", flush=True)
    ok = res.relres <= RELRES and rr_node <= RELRES
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
