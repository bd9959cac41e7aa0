"""The MITC shells 731, 741 and 743 of the port (``fem/shell.py``,
``post/shellpost.py``, the 6-dof model and the shell arm of
``collect_dload``) against the JAX package on the CPU, same numpy
inputs: element stiffness, distributed loads (P0, BX, GRAV, CENT) and
nodal stresses on distorted, warped elements within 1e-12 relative; a
warped plate in linear STATIC through ``run_directory`` (u, nodal and
element stresses within 1e-8 relative, CG count and 0.log equal), and
under the mixed policy (CG within 2 + 10% of the JAX package's).  MITC9
stresses fail in the JAX package (its ``shell_nodal_stress`` ties rows 4
and 5 with MITC3's coefficients); the port refuses them by name."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from frontistr_tpu.fem import shell as jshell
from frontistr_tpu_torch.fem import shell as tshell

from _torch_shell_decks import deck, rel, run_both, warped_plate

ETYPES = [731, 741, 743]
LOADS = [("P0", [1.3]), ("BX", [2.0]), ("GRAV", [9.8, 0.0, 0.3, -1.0]),
         ("CENT", [3.0, 0.1, 0.2, 0.0, 0.3, 0.1, 1.0])]


def _elements(etype, seed=0):
    """Five distorted, warped elements around the natural node layout."""
    t = tshell.shell_table(etype)
    base = np.c_[t.nodal, np.zeros(t.nn)]
    rng = np.random.default_rng(seed)
    return base[None] + 0.15 * rng.standard_normal((5, t.nn, 3))


@pytest.mark.parametrize("etype", ETYPES)
def test_element_stiffness_matches_jax(etype):
    elem = _elements(etype)
    want = np.asarray(jshell.stiffness_shell(jnp.asarray(elem), 0.05, 2e5,
                                             0.3, etype=etype))
    got = tshell.stiffness_shell(torch.as_tensor(elem), 0.05, 2e5, 0.3,
                                 etype=etype).numpy()
    assert got.shape == (5, 6 * len(elem[0]), 6 * len(elem[0]))
    assert rel(got, want) <= 1e-12


@pytest.mark.parametrize("etype", ETYPES)
@pytest.mark.parametrize("ltype,params", LOADS)
def test_shell_dload_matches_jax(etype, ltype, params):
    elem = _elements(etype, 1)
    p = np.asarray(params + [0.0] * 7)[:7]
    want = np.asarray(jshell.shell_dload(jnp.asarray(elem), 0.05, 7.8,
                                         ltype, p, etype))
    got = tshell.shell_dload(torch.as_tensor(elem), 0.05, 7.8, ltype, p,
                             etype).numpy()
    assert rel(got, want) <= 1e-12


@pytest.mark.parametrize("etype", [731, 741])
def test_nodal_stress_matches_jax(etype):
    elem = _elements(etype, 2)
    ue = np.random.default_rng(3).standard_normal((5, len(elem[0]), 6))
    we, ws = jshell.shell_nodal_stress(jnp.asarray(elem), jnp.asarray(ue),
                                       0.05, 2e5, 0.3, etype=etype)
    ge, gs = tshell.shell_nodal_stress(torch.as_tensor(elem),
                                       torch.as_tensor(ue), 0.05, 2e5, 0.3,
                                       etype=etype)
    assert rel(ge.numpy(), we) <= 1e-12
    assert rel(gs.numpy(), ws) <= 1e-12


def test_mitc9_stress_refused_where_jax_fails(tmp_path):
    """The JAX package's stress recovery of 743 shells fails (its STATIC,
    NLSTATIC and DYNAMIC runs of a 743 deck end in it); the port refuses
    such a run by name before the solve."""
    elem = _elements(743, 2)
    ue = np.random.default_rng(3).standard_normal((5, 9, 6))
    with pytest.raises(ValueError):
        jshell.shell_nodal_stress(jnp.asarray(elem), jnp.asarray(ue), 0.05,
                                  2e5, 0.3, etype=743)
    from frontistr_tpu_torch.io.neu import write_static_workdir
    from frontistr_tpu_torch.run import run_directory
    write_static_workdir(str(tmp_path), warped_plate(2, 743),
                         deck(loads="!DLOAD\n ALL, P0, 0.01\n"),
                         ngroups=("EDGE",))
    with pytest.raises(NotImplementedError, match="743"):
        run_directory(str(tmp_path), device="cpu")


@pytest.mark.parametrize("etype", [731, 741])
def test_static_plate_matches_jax(tmp_path, etype):
    """A clamped warped plate under pressure and a body force: u, nodal
    and element stresses and strains, the reactions, the CG count and the
    0.log."""
    cnt = deck(loads="!DLOAD\n ALL, P0, 0.01\n ALL, BX, 0.001\n")
    op, oj, wd, wj = run_both(tmp_path, warped_plate(4, etype), cnt)
    a, b = op["static"], oj["static"]
    assert a.u.shape == b.u.shape and a.u.shape[1] == 6
    assert a.iters == b.iters
    assert rel(a.u, b.u) <= 1e-8
    for k in ("nodal_strain", "nodal_stress", "elem_strain", "elem_stress",
              "reaction"):
        assert rel(getattr(a, k), getattr(b, k)) <= 1e-8, k
    assert np.array_equal(a.node_count, b.node_count)
    assert open(wd + "/0.log").read() == open(wj + "/0.log").read()
    # the .res: the port's text file and its binary one, read by the JAX
    # package's reader, against the JAX package's text file (6-column
    # DISPLACEMENT and REACTION_FORCE, the shell stresses)
    from frontistr_tpu.io.resfile import read_result_any
    from frontistr_tpu_torch.io.resfile import write_static_result
    want = read_result_any(wj + "/mesh.res.0.1")
    write_static_result(wd + "/bin.res", op["mesh"], op["model"], a,
                        binary=True)
    for path in (wd + "/mesh.res.0.1", wd + "/bin.res"):
        got = read_result_any(path)
        assert np.array_equal(got["node_ids"], want["node_ids"])
        for (ln, x), (lw, y) in zip(got["node_comps"] + got["elem_comps"],
                                    want["node_comps"] + want["elem_comps"]):
            assert ln == lw and x.shape == y.shape
            assert rel(x, y) <= 1e-8, ln
    assert dict(want["node_comps"])["DISPLACEMENT"].shape[1] == 6


def test_static_plate_mixed_policy_count(tmp_path, monkeypatch):
    """The mixed policy (f32 cluster CG + f64 refinement), both
    packages: the port's CG count within 2 + 10% of the JAX package's,
    u within 1e-6."""
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", "mixed")
    cnt = deck(loads="!DLOAD\n ALL, P0, 0.01\n", resid="1.0e-8")
    op, oj, _, _ = run_both(tmp_path, warped_plate(6, 741), cnt)
    a, b = op["static"], oj["static"]
    assert a.policy == "mixed"
    assert abs(a.iters - b.iters) <= 2 + 0.1 * b.iters
    assert rel(a.u, b.u) <= 1e-6


REFUSED = {
    "spring": ("!SPRING\n 1, 3, 10.0\n", "!SPRING"),
    "temperature": ("!TEMPERATURE\n ALL, 100.0\n", "!TEMPERATURE"),
    "rot_center": ("!BOUNDARY, ROT_CENTER=EDGE\n EDGE, 1, 3, 0.01\n",
                   "ROT_CENTER"),
    "contact": ("!CONTACT, GRPID=1\n CP1, 1, 0.0\n", "!CONTACT"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_six_dof_model_refuses_dropped_cards(tmp_path, case):
    """The JAX package's 6-dof model build reads !BOUNDARY, !CLOAD and
    !DLOAD only and drops the rest without a word: the port refuses
    those cards by name."""
    from frontistr_tpu_torch.io.neu import write_static_workdir
    from frontistr_tpu_torch.run import run_directory
    extra, msg = REFUSED[case]
    cnt = deck(loads="!DLOAD\n ALL, P0, 0.01\n", extra=extra)
    write_static_workdir(str(tmp_path), warped_plate(2, 741), cnt,
                         ngroups=("EDGE",))
    with pytest.raises(NotImplementedError, match=msg):
        run_directory(str(tmp_path), device="cpu")


def test_mixed_shell_solid_mesh_refused_with_jax_message():
    from frontistr_tpu.assembly.model import build_struct_model as jbuild
    from frontistr_tpu_torch.assembly.model import check_slice
    from frontistr_tpu_torch.io.ctrlio import AnalysisConfig
    from frontistr_tpu_torch.meshgen import box_hex8
    from frontistr_tpu_torch.io.meshio import ElemBlock
    mesh = box_hex8(2, 1, 1)
    top = mesh.blocks[0].conn[:, 4:]
    mesh.blocks.append(ElemBlock(741, np.arange(3, 5), top, top, 0))
    cfg = AnalysisConfig()
    with pytest.raises(NotImplementedError, match="mixed shell/solid"):
        check_slice(mesh, cfg)
    with pytest.raises(NotImplementedError, match="mixed shell/solid"):
        jbuild(mesh, cfg)
