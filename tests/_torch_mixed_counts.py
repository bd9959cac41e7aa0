"""CG counts of the NLSTATIC bench deck through Newton iteration 2, in
one package and one solve policy, on the CPU (the classification of the
mixed policy's f32 CG on stressed tangents, ROADMAP.md):

    env JAX_PLATFORMS=cpu python tests/_torch_mixed_counts.py {jax|port} N {mixed|f64}

The deck of ``bench.py:83-88`` (X0 fixed, X1 loaded -1 in z, total
Lagrange) on ``box_tet4(N, N, N)``, nodes shuffled with seed 3, RCM
reordered, the AMG forced (``FRONTISTR_TPU_PRECOND=amg``).  The JAX
package runs with the port's floored level-1 block inverse swapped in,
as ``test_torch_static_amg.py::test_mixed_amg_singular_block_matches_jax``
does.  Prints (CG iterations, refinement passes, seconds) of the first
two Newton solves, then stops the run.
"""

import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
NLCNT = ("!VERSION\n 3\n!SOLUTION, TYPE=NLSTATIC\n!BOUNDARY\n X0, 1, 3, 0.0\n"
         "!CLOAD\n X1, 3, -1.0\n!MATERIAL, NAME=M1\n!ELASTIC\n"
         " 210000.0, 0.3\n!STEP, SUBSTEPS=1\n BOUNDARY, 1\n LOAD, 1\n"
         "!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
         " 1.0e-8, 1.0, 0.0\n!END\n")


class _Stop(Exception):
    pass


def main(pkg: str, n: int, policy: str) -> list:
    os.environ.update(FRONTISTR_TPU_PRECISION=policy,
                      FRONTISTR_TPU_COMPILE_CACHE="0",
                      FRONTISTR_TPU_REORDER="1",
                      FRONTISTR_TPU_PRECOND="amg")
    sys.path[:0] = [os.path.dirname(HERE), HERE]
    import numpy as np
    from frontistr_tpu_torch import ordering
    from frontistr_tpu_torch.io.neu import write_static_workdir
    from frontistr_tpu_torch.meshgen import box_tet4
    wd = tempfile.mkdtemp(prefix="mixed_counts_")
    m = box_tet4(n, n, n)
    write_static_workdir(wd, ordering.permute_mesh(
        m, np.random.default_rng(3).permutation(m.n_node)), NLCNT)
    if pkg == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from frontistr_tpu.analysis import nonlinear as mod
        from frontistr_tpu.run import run_directory
        from frontistr_tpu.solver import amg as jamg
        from test_torch_static import _floored_block_inv
        jamg._block_inv = _floored_block_inv

        def run():
            return run_directory(wd)
    else:
        from frontistr_tpu_torch.analysis import nonlinear as mod
        from frontistr_tpu_torch.run import run_directory

        def run():
            return run_directory(wd, device="cpu")
    counts = []
    t0 = time.time()
    real = mod.make_constrained_solver

    def counted(*a, **kw):
        solve = real(*a, **kw)

        def call(*aa, **kk):
            x = solve(*aa, **kk)
            call.last_iters, call.last_passes = (solve.last_iters,
                                                 solve.last_passes)
            call.last_relres = getattr(solve, "last_relres", 0.0)
            counts.append((int(solve.last_iters), int(solve.last_passes),
                           round(time.time() - t0, 1)))
            print("solve", counts[-1], flush=True)
            if len(counts) == 2:
                raise _Stop()
            return x
        return call
    mod.make_constrained_solver = counted
    try:
        run()
    except _Stop:
        pass
    print(f"RESULT pkg={pkg} n={n} dofs={3 * m.n_node} policy={policy} "
          f"(cg, passes, s)={counts}", flush=True)
    return counts


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
