"""Linear STATIC by BiCGSTAB, GMRES and GPBiCG on the two other arms,
held to the JAX package on the CPU: a structured hex8 box through
``build_struct_model`` + ``run_linear_static`` (the stencil operator,
its element products through K2) and a deck with !EQUATION (the
eliminated matrix-free operator).  Bars and the JAX package's GPBiCG:
as in test_torch_krylov_static.py, but under !EQUATION the port's count
is at most the JAX package's plus 1 (the port restricts the
preconditioner to the reduced space, ROADMAP queue 3, fault 5)."""

import pytest

from frontistr_tpu.analysis import static as jstatic
from frontistr_tpu.assembly.model import build_struct_model as jbuild
from frontistr_tpu.io.ctrlio import read_cnt as jread_cnt
from frontistr_tpu_torch.analysis import static
from frontistr_tpu_torch.assembly.model import build_struct_model
from frontistr_tpu_torch.io.ctrlio import read_cnt
from frontistr_tpu_torch.meshgen import box_hex8

from _torch_decks import run_both
from test_torch_krylov_static import CNT, _check, env  # noqa: F401
from test_torch_mpc_spring import tie_face


@pytest.mark.parametrize("method", ["BICGSTAB", "GMRES", "GPBICG"])
def test_structured_hex_methods_match_jax(tmp_path, env, method):
    """The structured hex8 box through the library entry points."""
    p = str(tmp_path / "case.cnt")
    with open(p, "w") as fh:
        fh.write(CNT.format(load="X1, 3, -1.0", method=method))
    mesh = box_hex8(4, 3, 3)
    assert mesh.structured is not None
    jres = jstatic.run_linear_static(jbuild(mesh, jread_cnt(p)))
    res = static.run_linear_static(build_struct_model(mesh, read_cnt(p),
                                                      device="cpu"))
    _check(res, jres)


@pytest.mark.parametrize("method", ["BICGSTAB", "GMRES", "GPBICG"])
def test_equation_methods_match_jax(tmp_path, env, method):
    """X1's u_z tied to its first node by !EQUATION, the load there."""
    mesh = box_hex8(3, 2, 2)
    mast = tie_face(mesh)
    cnt = CNT.format(load=f"{mast}, 3, -20.0", method=method)
    ot, oj, _, _ = run_both(tmp_path, mesh, cnt)
    _check(ot["static"], oj["static"], eq=True)
