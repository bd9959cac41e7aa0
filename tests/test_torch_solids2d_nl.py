"""The 2-D solids in NLSTATIC (total Lagrange), the port against the JAX
package on the CPU through ``run_directory``: each type and sect_opt on
the decks of ``test_torch_solids2d.py``, X1 loaded in y over two
substeps; a follower edge pressure.  2-D !PLASTIC:
``test_torch_solids2d.py``.

Bars: displacements within 1e-8 of the largest, Newton iterations and
FSTR.sta equal, the 0.log summaries within 1e-8.
"""

import pytest

from _torch_decks import run_both_plane
from test_torch_hyper import check_static
from test_torch_solids2d import (ETYPES, OPTS, env,  # noqa: F401 (fixture)
                                 plane_cnt, plane_mesh)


@pytest.mark.parametrize("etype", ETYPES)
@pytest.mark.parametrize("opt", OPTS)
def test_plane_nlstatic_matches_jax(tmp_path, env, etype, opt):
    ot, oj, wd, wj = run_both_plane(tmp_path, plane_mesh(etype, opt),
                                    plane_cnt("NLSTATIC", loads="!CLOAD\n"
                                              " X1, 2, -300.0\n"))
    check_static(ot, oj, wd, wj)


def test_plane_follower_pressure_matches_jax(tmp_path, env):
    ot, oj, wd, wj = run_both_plane(
        tmp_path, plane_mesh(242, 0),
        plane_cnt("NLSTATIC", loads="!DLOAD\n EX1, S, 200.0\n"))
    check_static(ot, oj, wd, wj)
