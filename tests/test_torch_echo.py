"""!ECHO: the mesh and deck dump at the top of 0.log, held to the JAX
package's on decks the test writes (a STATIC tet deck with two loads
and a transient HEAT deck), on the CPU."""

import os
import shutil

import pytest

import frontistr_tpu.run as jrun
from frontistr_tpu.io.echo import echo_text as jecho_text
from frontistr_tpu_torch.io.echo import echo_text
from frontistr_tpu_torch.meshgen import box_tet4
from frontistr_tpu_torch.run import run_directory

from _torch_decks import heat_deck, heat_mesh, write_deck, write_heat_deck

STATIC = ("!VERSION\n 3\n!SOLUTION, TYPE=STATIC\n!ECHO\n!BOUNDARY\n"
          " X0, 1, 3, 0.0\n!CLOAD\n X1, 3, -1.0\n!DLOAD\n ALL, BX, -2.0\n"
          "!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n!DENSITY\n"
          " 7.85e-9\n!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n"
          " 10000, 1\n 1.0e-8, 1.0, 0.0\n!END\n")


@pytest.mark.parametrize("kind", ["static", "heat"])
def test_echo_block_matches_jax(tmp_path, kind):
    if kind == "static":
        wd = write_deck(tmp_path / "port", box_tet4(3, 2, 2), STATIC)
    else:
        mesh = heat_mesh("hex8")
        wd = write_heat_deck(tmp_path / "port", mesh,
                             heat_deck(mesh).replace("!FIXTEMP",
                                                     "!ECHO\n!FIXTEMP"))
    wj = str(tmp_path / "jax")
    shutil.copytree(wd, wj)
    oj = jrun.run_directory(wj)
    ot = run_directory(wd, device="cpu")
    want = jecho_text(oj["mesh"], oj["cfg"])
    got = echo_text(ot["mesh"], ot["cfg"])
    assert got == want and "### Number of nodes" in got
    with open(os.path.join(wd, "0.log")) as ft, \
            open(os.path.join(wj, "0.log")) as fj:
        lt, lj = ft.read(), fj.read()
    assert lt.startswith(got) and lj.startswith(want)
    assert len(lt) > len(got)
