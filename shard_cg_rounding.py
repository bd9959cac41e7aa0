"""How far rounding alone moves the CG counts of the newton cell's
stressed solve (on a CUDA card; imports ``chip_smoke.py`` beside it).

The newton deck of ``chip_smoke.py`` (shuffled box_tet4(69), 1,029,000
dofs, NLSTATIC, f64, AMG) cut to CONVERG 0.05 (two Newton iterations,
the second on the stressed tangent) runs on one device, then twice with
the CG right-hand side perturbed by 1e-15 relative (seeds 1, 2), then
on a 1-rank NCCL group of ``FRONTISTR_TPU_SHARDS``; each run prints its
CG counts.  Run: ``python3 shard_cg_rounding.py``."""
import os, sys, time, shutil
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch
import chip_smoke as cs


def main():
    mods = cs.load_mods()
    os.environ["FRONTISTR_TPU_CACHE_DIR"] = "0"
    mods["kernels"].build()
    pools = {1: mods["dist"].RankPool(1, "cuda", os.path.join(cs.ROOT, "build"))}
    m = 69
    wd = os.path.join(cs.ROOT, "build", "diag", "newton")
    shutil.rmtree(wd, ignore_errors=True)
    cs.write_workdir(wd, (m,) * 3, mods["ordering"], mods["box_tet4"],
                     mods["write_static_workdir"],
                     cs.NLCNT.format(load=-1.0).replace(
                         "!STEP, SUBSTEPS=1", "!STEP, SUBSTEPS=1, CONVERG=0.05"))
    inputs = sorted(os.listdir(wd))
    nl = mods["nonlinear"]
    real = nl.pcg
    f64 = {"FRONTISTR_TPU_PRECISION": "f64"}
    for seed in (None, 1, 2):
        if seed is not None:
            def ppcg(A, b, *a, _s=seed, **kw):
                g = torch.Generator().manual_seed(_s)
                e = torch.randn(b.shape, generator=g, dtype=torch.float64)
                return real(A, b * (1 + 1e-15 * e.to(b.device, b.dtype)),
                            *a, **kw)
            nl.pcg = ppcg
        w = cs.copy_inputs(wd, inputs, f"{wd}_{seed}")
        t0 = time.perf_counter()
        out = cs.with_env(f64, lambda: mods["run_directory"](w, device="cuda"))
        nl.pcg = real
        h = out["static"].newton.history
        print(f"one device, b perturbed seed {seed}: cg "
              f"{[x['cg_iters'] for x in h]}, rres {[x['rres'] for x in h]}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del out
        torch.cuda.empty_cache()
    w = cs.copy_inputs(wd, inputs, f"{wd}_r1")
    t0 = time.perf_counter()
    g = pools[1].run(cs.shard_rank_run, w, f64)[0]
    print(f"1 rank {g['backend']}: cg {g['cg']}, ms/CG "
          f"{1e3 * sum(g['solve_s']) / sum(g['cg']):.2f}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for p in pools.values():
        p.close()


if __name__ == "__main__":
    main()
