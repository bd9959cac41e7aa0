"""``!SOLUTION, TYPE=ELEMCHECK | PRECHECK | NZPROF`` in the port against
the JAX package on the CPU (``precheck.py``, ``run._run_precheck``):
through ``run_directory`` on shuffled tet4, hex8 and MITC4 shell decks,
the 0.log, ``nonzero.dat.000`` and ``nonzero.plt.000`` equal byte for
byte and the report's numbers equal; a degenerate element counted."""

import dataclasses
import os

import numpy as np
import pytest

from frontistr_tpu.precheck import precheck as jprecheck
from frontistr_tpu_torch.meshgen import box_hex8, box_tet4, plate_shell
from frontistr_tpu_torch.precheck import precheck

from _torch_decks import run_both

DECK = "!VERSION\n 3\n!SOLUTION, TYPE={sol}\n!END\n"
MESHES = {"tet4": (lambda: box_tet4(3, 2, 2), ("X0", "X1")),
          "hex8": (lambda: box_hex8(3, 3, 2), ("X0", "X1")),
          "shell": (lambda: plate_shell(4, etype=741), ("EDGE",))}


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


@pytest.mark.parametrize("sol", ["ELEMCHECK", "PRECHECK", "NZPROF"])
@pytest.mark.parametrize("kind", list(MESHES))
def test_precheck_matches_jax(tmp_path, kind, sol):
    make, groups = MESHES[kind]
    ot, oj, wd, wj = run_both(tmp_path, make(), DECK.format(sol=sol),
                              ngroups=groups)
    assert dataclasses.asdict(ot["precheck"]) == \
        dataclasses.asdict(oj["precheck"])
    assert _same_file(os.path.join(wd, "0.log"), os.path.join(wj, "0.log"))
    names = ("nonzero.dat.000", "nonzero.plt.000")
    if sol == "NZPROF":
        for name in names:
            assert _same_file(os.path.join(wd, name), os.path.join(wj, name))
        got = {k: v for k, v in ot["nzprof"].items()
               if k not in ("dat", "plt")}
        assert got == {k: v for k, v in oj["nzprof"].items()
                       if k not in ("dat", "plt")}
    else:
        assert not any(os.path.exists(os.path.join(wd, n)) for n in names)


def test_degenerate_element_is_counted():
    """A tet with its fourth node moved through its base: a negative
    Jacobian, counted as degenerate in both packages."""
    mesh = box_tet4(2, 1, 1)
    conn = mesh.blocks[0].conn
    a, b, c, d = mesh.coords[conn[0]]
    n = np.cross(b - a, c - a)
    mesh.coords[conn[0, 3]] = d - 2.0 * np.dot(d - a, n) / np.dot(n, n) * n
    rep, jrep = precheck(mesh), jprecheck(mesh)
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    assert rep.n_degenerate >= 1 and rep.min_jacobian < 0
