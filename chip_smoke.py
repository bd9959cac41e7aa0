"""Smoke run of the PyTorch/CUDA port on one card: builds the kernels,
holds each against its plain PyTorch version, drives the linear-static
tet path once through ``frontistr_tpu_torch.run.run_directory`` (the
function behind ``python -m frontistr_tpu_torch``), checks the answer and
prints the result.

    python3 chip_smoke.py [--n N]

``--n`` sets the box: ``box_tet4(n, n, n)`` has 3*(n+1)^3 dofs and 6*n^3
tets (default n=69: 1,029,000 dofs, 1,971,054 tets; n=40: 206,763
dofs).  The run needs a CUDA card
and exits non-zero without one, or when any phase fails.  Work
directories and the kernel build go under ``build/`` of the checkout.
The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists the kernels, the line before that the card's
name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CNT = ("!VERSION\n 3\n!SOLUTION, TYPE=STATIC\n!BOUNDARY\n X0, 1, 3, 0.0\n"
       "!CLOAD\n X1, 3, -1.0\n!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n"
       "!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
       " 1.0e-8, 1.0, 0.0\n!END\n")
F32_TOL, F64_TOL = 1e-4, 1e-12      # x max|plain|


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over reps launches (CUDA events)."""
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


def check_k1(sm, plan, kes, nns, dtype, label: str) -> float:
    """Kernel vs plain version on the same inputs; two launches must be
    bit-equal.  Returns max |kernel - plain|."""
    kes = [k.to(dtype) for k in kes]
    got = sm.segsum(plan, kes, nns, 3)
    again = sm.segsum(plan, kes, nns, 3)
    want = sm.segsum_reference(plan, kes, nns, 3)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    tol = (F32_TOL if dtype == torch.float32 else F64_TOL) * scale
    log(f"  K1 {label} {str(dtype)[6:]}: max_abs_err={err!r} "
        f"(tol {tol!r}), bit-equal relaunch={torch.equal(got, again)}")
    if not err <= tol:
        raise AssertionError(f"K1 disagrees with its plain version ({label})")
    if not torch.equal(got, again):
        raise AssertionError(f"K1 relaunch not bit-equal ({label})")
    return err


def phase_kernels(sm, bell, box_tet4):
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    # random sorted segments: empty slots and segments past 1024 entries
    n_slots = 50000
    seg = np.sort(np.r_[rng.integers(0, n_slots, 200000),
                        np.full(3000, 17), np.full(1500, 40000)])
    seg = seg[(seg < 1000) | (seg > 2000)].astype(np.int32)  # empty run
    P = len(seg)
    plan = sm.make_plan(rng.permutation(P).astype(np.int32), seg, n_slots,
                        (P,), dev)
    ke = torch.as_tensor(rng.standard_normal((P, 3, 3)), device=dev)
    for dt in (torch.float32, torch.float64):
        check_k1(sm, plan, [ke], [1], dt, "random segments")
    mesh = box_tet4(20, 20, 20)
    conn = mesh.blocks[0].conn
    cprof = bell.build_cluster_profile([conn], mesh.n_node, 3)
    kes = [torch.as_tensor(rng.standard_normal((conn.shape[0], 12, 12)),
                           device=dev)]
    for dt in (torch.float32, torch.float64):
        check_k1(sm, cprof.plan(dev), kes, [4], dt, "box_tet4(20) cluster")


def write_workdir(path: str, dims, ordering, box_tet4, write_workdir_fn):
    mesh = box_tet4(*dims)
    order = np.random.default_rng(3).permutation(mesh.n_node)
    write_workdir_fn(path, ordering.permute_mesh(mesh, order), CNT)
    return mesh.n_node * 3


def true_relres(model, u: np.ndarray, kes) -> float:
    """||b_c - A_c u|| / ||b_c|| with the element matrices scattered by
    index_add_ (independent of the cluster and incidence operators)."""
    dev = kes[0].device
    n = model.n_dof_total
    x = torch.as_tensor(u.reshape(-1), device=dev)

    def K(v):
        y = torch.zeros(n, dtype=torch.float64, device=dev)
        for b, ke in zip(model.blocks, kes):
            d = torch.as_tensor(b.dofs, dtype=torch.int64, device=dev)
            y.index_add_(0, d.reshape(-1),
                         torch.einsum("eij,ej->ei", ke, v[d]).reshape(-1))
        return y
    free = torch.ones(n, dtype=torch.float64, device=dev)
    free[torch.as_tensor(model.fixed_dofs, device=dev)] = 0.0
    u_fix = torch.zeros(n, dtype=torch.float64, device=dev)
    u_fix[torch.as_tensor(model.fixed_dofs, device=dev)] = \
        torch.as_tensor(model.fixed_vals, device=dev)
    f_eff = torch.as_tensor(model.f_ext, device=dev) - K(u_fix)
    # b_c = P (f - K u_fix) + (I-P) u_fix;  A_c x = P K P x + (I-P) x
    b_c = f_eff * free + u_fix * (1 - free)
    r = (f_eff - K(x * free)) * free + (u_fix - x) * (1 - free)
    return float(torch.linalg.norm(r) / torch.linalg.norm(b_c))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=69,
                    help="box_tet4(n, n, n) for the main path (default 69)")
    args = ap.parse_args(argv)

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from frontistr_tpu_torch import ordering
    from frontistr_tpu_torch.analysis import static as stmod
    from frontistr_tpu_torch.assembly import bell
    from frontistr_tpu_torch.assembly import segsum as sm
    from frontistr_tpu_torch.io.neu import write_static_workdir
    from frontistr_tpu_torch.meshgen import box_tet4
    from frontistr_tpu_torch.run import run_directory
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"phase device: torch {torch.__version__} (CUDA "
        f"{torch.version.cuda}), {kind}, {torch.cuda.device_count()} "
        f"device(s)")

    # 2. build
    t0 = time.perf_counter()
    lib = sm.build()
    log(f"phase build: K1 {os.path.relpath(lib, ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s")

    # 3. K1 against its plain version
    log("phase k1_check:")
    phase_kernels(sm, bell, box_tet4)

    # 4. main path through run_directory on the card
    wd = os.path.join(ROOT, "build", "smoke", f"tet{args.n}")
    t0 = time.perf_counter()
    ndof = write_workdir(wd, (args.n,) * 3, ordering, box_tet4,
                         write_static_workdir)
    log(f"phase workdir: box_tet4({args.n}) shuffled, {ndof} dofs, "
        f"written in {time.perf_counter() - t0:.2f} s")
    sm.segsum.launches = 0
    t0 = time.perf_counter()
    out = run_directory(wd, device="cuda")
    wall = time.perf_counter() - t0
    launches = sm.segsum.launches
    res, model = out["static"], out["model"]
    times = " ".join(f"{k}={v:.3f}" for k, v in res.timings.items())
    log(f"phase main_path: {wall:.2f} s; {times}")
    log(f"  policy={res.policy} cg_iters={res.iters} "
        f"refine_passes={res.passes} relres={res.relres!r} "
        f"K1 launches={launches}")
    if launches < 1:
        raise AssertionError("the main path did not launch K1")
    if res.policy != "mixed":
        raise AssertionError(f"policy {res.policy}, expected mixed")
    if not (res.u.shape == (model.n_node, 3) and np.isfinite(res.u).all()):
        raise AssertionError("displacements not finite / wrong shape")
    kes = stmod.compute_element_stiffness(model)
    rr = true_relres(model, res.u, kes)
    log(f"  true f64 relres (index_add_ residual) = {rr!r}")
    if not (res.relres <= 1e-8 and rr <= 1e-8):
        raise AssertionError("true relative residual above 1e-8")
    with open(os.path.join(wd, "0.log")) as fh:
        if "Global Summary" not in fh.read():
            raise AssertionError("0.log holds no Global Summary")

    # 5. K1 time and error at the main path's shapes (after the counts)
    cprof = bell.cluster_profile_from_model(model)
    plan = cprof.plan("cuda")
    nns = [b.conn.shape[1] for b in model.blocks]
    k32 = [k.to(torch.float32) for k in kes]
    err = check_k1(sm, plan, k32, nns, torch.float32, "main path")
    ms = cuda_ms(lambda: sm.segsum(plan, k32, nns, 3))
    plain_ms = cuda_ms(lambda: sm.segsum_reference(plan, k32, nns, 3))
    log(f"phase k1_time: P={plan.perm.numel()} pairs, "
        f"n_slots={plan.n_slots}: kernel {ms:.3f} ms, plain {plain_ms:.3f} "
        f"ms (f32)")
    del k32, kes

    # 6. a small deck through the AMG arm in the mixed policy, on the card
    # and on the CPU (which the CPU tests hold to the JAX package).  In
    # box_tet4(30, 30, 2), shuffled and RCM-ordered, one level-1 AMG block
    # is singular up to rounding, the case that once broke the V-cycle on
    # the card; a V-cycle that differs shows in the CG iteration count.
    small = os.path.join(ROOT, "build", "smoke", "tet30x30x2")
    write_workdir(small, (30, 30, 2), ordering, box_tet4,
                  write_static_workdir)
    saved = {k: os.environ.get(k) for k in ("FRONTISTR_TPU_PRECOND",
                                            "FRONTISTR_TPU_PRECISION")}
    os.environ.update(FRONTISTR_TPU_PRECOND="amg",
                      FRONTISTR_TPU_PRECISION="mixed")
    try:
        r_gpu = run_directory(small, device="cuda")["static"]
        r_cpu = run_directory(small, device="cpu")["static"]
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    rel = float(np.abs(r_gpu.u - r_cpu.u).max() / np.abs(r_cpu.u).max())
    log(f"phase small_reference: box_tet4(30,30,2) AMG mixed, cuda vs cpu "
        f"max rel diff {rel!r}, cg_iters {r_gpu.iters} vs {r_cpu.iters}")
    if not rel <= 1e-6:
        raise AssertionError("cuda and cpu runs disagree on a small deck")
    if not abs(r_gpu.iters - r_cpu.iters) <= 2 + 0.05 * r_cpu.iters:
        raise AssertionError("cuda and cpu AMG solves take different paths")

    log(smi)
    log(json.dumps({"kernels": [{
        "name": "segsum", "route": "cuda",
        "source": "frontistr_tpu_torch/csrc/segsum.cu",
        "replaces": "frontistr_tpu/assembly/segsum_pallas.py:121",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
