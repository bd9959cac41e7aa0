"""``chip_smoke.py``'s hex20_mpc NLSTATIC deck at the total load it was
specified with, -5,985, on a hex20 box of 4: the port against the JAX
package on the CPU, in a file of its own because the JAX package's
compile of the hex20 Newton run takes most of a minute.  (On the card
the cell runs half that load: ``PERF.md`` §6.)
"""

import numpy as np

from frontistr_tpu_torch.io.meshio import Equation

from _torch_decks import hex20_box, run_both
from test_torch_solids3d_dyn import _close, env  # noqa

# chip_smoke.py's MPCCNT with the hex20_mpc cell's load and spring
MPC_DECK = ("!VERSION\n 3\n!SOLUTION, TYPE=NLSTATIC\n!BOUNDARY\n"
            " X0, 1, 3, 0.0\n!CLOAD\n {mast}, 3, -5985.0\n!SPRING\n"
            " {mast}, 3, 210.0\n!MATERIAL, NAME=M1\n!ELASTIC\n"
            " 210000.0, 0.3\n!STEP, SUBSTEPS=1\n BOUNDARY, 1\n LOAD, 1\n"
            "!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
            " 1.0e-8, 1.0, 0.0\n!END\n")


def test_hex20_mpc_deck_at_the_cell_load_matches_jax(tmp_path, env):
    """The hex20_mpc deck (X0 fixed, every X1 node's u_z tied by
    !EQUATION to the node at X1's middle, a spring there to the ground)
    at the cell's specified total load, -5,985, on a hex20 box of 4:
    both packages converge in the same Newton iterations, with f64
    displacements within 1e-8 of the largest."""
    mesh = hex20_box(4, 4, 4)
    x1 = mesh.node_groups["X1"]
    mid = int(x1[np.argmin(np.linalg.norm(mesh.coords[x1] - [1.0, 0.5, 0.5],
                                          axis=1))])
    mesh.equations = [Equation(np.asarray([int(k), mid]), np.asarray([3, 3]),
                               np.asarray([1.0, -1.0]), 0.0)
                      for k in x1 if int(k) != mid]
    ot, oj, _, _ = run_both(tmp_path, mesh,
                            MPC_DECK.format(mast=int(mesh.node_ids[mid])))
    st, sj = ot["static"], oj["static"]
    assert st.iters == sj.iters == 4
    _close(st.u, sj.u)
