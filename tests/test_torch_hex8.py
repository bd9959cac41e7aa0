"""The hex8 (361) linear-static slice of the port against the JAX package
on the CPU: the incompatible-mode element, the 361 formulation rule, the
structured-box stencil arm through ``run_linear_static`` (the library
entry the JAX tests use), and a shuffled hex8 file deck through
``run_directory`` (the cluster-ELL + K1 arm with 8-node elements).

Bars, float64: element matrices and strains within 1e-12 of their
largest magnitude; displacements, nodal stress and Mises within 1e-8 of
theirs (two CG runs to relres 1e-8).  Iterations: the float64 policy
within 2.  The mixed policy within 2 + 10% of the JAX count: the two
packages' float32 inner CG residual histories agree to about 5 digits for
the first ~15 iterations, then separate (float32 rounding of the dot
products and of XLA's fused block inverse), and the inner tolerance 1e-6
sits near float32's floor, where the count is sensitive to that; on
box_hex8 sizes from (5,4,3) to (10,4,3) the counts differed by 0 to 10
(8%).  ``test_mixed_inner_cg_tracks_jax`` holds the first iterations.
"""

import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import frontistr_tpu.run as jrun
from frontistr_tpu.analysis import static as jstatic
from frontistr_tpu.assembly import structured as jstructured
from frontistr_tpu.assembly.model import build_struct_model as jbuild
from frontistr_tpu.elements import tables as jtables
from frontistr_tpu.fem import solid as jsolid
from frontistr_tpu.fem.material import D3, elastic_D
from frontistr_tpu.io import logio as jlogio
from frontistr_tpu.io.ctrlio import read_cnt as jread_cnt
from frontistr_tpu.meshgen import box_hex8 as jbox_hex8
from frontistr_tpu.solver.cg import pcg as jpcg
from frontistr_tpu_torch import ordering
from frontistr_tpu_torch.analysis.static import run_linear_static
from frontistr_tpu_torch.assembly import segsum, structured
from frontistr_tpu_torch.assembly.model import build_struct_model
from frontistr_tpu_torch.convert import model_from_numpy
from frontistr_tpu_torch.elements import tables
from frontistr_tpu_torch.fem import solid
from frontistr_tpu_torch.io.ctrlio import read_cnt
from frontistr_tpu_torch.io.neu import write_static_workdir
from frontistr_tpu_torch.meshgen import box_hex8
from frontistr_tpu_torch.run import run_directory
from frontistr_tpu_torch.solver import amg
from frontistr_tpu_torch.solver.cg import pcg

CNT = ("!VERSION\n 3\n!SOLUTION, TYPE=STATIC\n!BOUNDARY\n X0, 1, 3, 0.0\n"
       "!CLOAD\n X1, 3, -1.0\n!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n"
       "!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
       " 1.0e-8, 1.0, 0.0\n!END\n")
SIZE = (6, 5, 4)


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _mixed_iters_ok(got: int, want: int) -> bool:
    return abs(got - want) <= 2 + 0.10 * want


def _deck(tmp_path, cnt=CNT) -> str:
    p = tmp_path / "case.cnt"
    p.write_text(cnt)
    return str(p)


def _distorted_hexes(seed: int):
    """Elements of box_hex8(3, 2, 2) with every node moved by up to 8% of
    the smallest spacing: no two elements alike, none parallel-sided."""
    mesh = box_hex8(3, 2, 2)
    rng = np.random.default_rng(seed)
    coords = mesh.coords + 0.08 * 0.33 * rng.uniform(-1, 1,
                                                     mesh.coords.shape)
    return coords[mesh.blocks[0].conn]


def test_stiffness_hex8ic_matches_jax():
    coords = _distorted_hexes(0)
    D = np.broadcast_to(elastic_D(210e3, 0.3, D3),
                        (len(coords), 6, 6)).copy()
    want = jsolid.stiffness_hex8ic(jtables.get_table(361),
                                   jnp.asarray(coords), jnp.asarray(D))
    got = solid.stiffness_hex8ic(tables.get_table(361),
                                 torch.as_tensor(coords), torch.as_tensor(D))
    _close(got.numpy(), want, 1e-12)
    assert np.abs(got.numpy() - got.numpy().transpose(0, 2, 1)).max() \
        <= 1e-12 * np.abs(want).max()


def test_strains_at_gauss_hex8ic_matches_jax():
    coords = _distorted_hexes(1)
    u = np.random.default_rng(2).standard_normal(coords.shape) * 1e-3
    D = np.broadcast_to(elastic_D(210e3, 0.3, D3),
                        (len(coords), 6, 6)).copy()
    want = jsolid.strains_at_gauss_hex8ic(
        jtables.get_table(361), jnp.asarray(coords), jnp.asarray(u),
        jnp.asarray(D))
    got = solid.strains_at_gauss_hex8ic(
        tables.get_table(361), torch.as_tensor(coords), torch.as_tensor(u),
        torch.as_tensor(D))
    _close(got.numpy(), want, 1e-12)


@pytest.mark.parametrize("card,form", [
    ("", "IC"), ("!ELEMOPT, 361=1\n", "FI"), ("!ELEMOPT, 361=3\n", "IC"),
    ("!SECTION, SECNUM=1, FORM361=FI\n", "FI"),
    ("!ELEMOPT, 361=1\n!SECTION, SECNUM=1, FORM361=IC\n", "IC"),
    ("!ELEMOPT, 361=2\n", "BBAR"), ("!SECTION, SECNUM=1, FORM361=FBAR\n",
                                    "FBAR")])
def test_formulation_361_matches_jax(tmp_path, card, form):
    p = _deck(tmp_path, CNT.replace("!SOLVER", card + "!SOLVER"))
    assert jbuild(jbox_hex8(2, 2, 2), jread_cnt(p)).blocks[0].formulation \
        == form
    model = build_struct_model(box_hex8(2, 2, 2), read_cnt(p), device="cpu")
    assert model.blocks[0].formulation == form


@pytest.mark.parametrize("policy,form", [("f64", "IC"), ("mixed", "IC"),
                                         ("f64", "FI")])
def test_hex_slice_matches_jax(tmp_path, monkeypatch, policy, form):
    """box_hex8(6, 5, 4) (a structured box) through ``run_linear_static``
    of both packages: the stencil arm, with every element product through
    the K2 wrapper (float32 and float64 in the mixed policy)."""
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", policy)
    cnt = CNT if form == "IC" else \
        CNT.replace("!SOLVER", "!ELEMOPT, 361=1\n!SOLVER")
    p = _deck(tmp_path, cnt)
    jres = jstatic.run_linear_static(jbuild(jbox_hex8(*SIZE), jread_cnt(p)))
    dtypes = set()
    k2 = structured.element_matvec_soa
    monkeypatch.setattr(structured, "element_matvec_soa",
                        lambda keT, xeT: dtypes.add(keT.dtype) or
                        k2(keT, xeT))
    model = build_struct_model(box_hex8(*SIZE), read_cnt(p), device="cpu")
    assert model.mesh.structured == SIZE
    assert model.blocks[0].formulation == form
    res = run_linear_static(model)
    assert res.policy == policy
    assert dtypes == ({torch.float32, torch.float64} if policy == "mixed"
                      else {torch.float64})
    assert set(res.timings) == {"element_stiffness", "assembly", "solve",
                                "stress"}
    assert res.relres <= 1e-8
    for name in ("u", "nodal_stress", "nodal_mises", "elem_stress"):
        _close(getattr(res, name), getattr(jres, name), 1e-8)
    if policy == "f64":
        assert abs(res.iters - int(jres.iters)) <= 2
    else:
        assert res.passes >= 1
        assert _mixed_iters_ok(res.iters, int(jres.iters))


def test_mixed_inner_cg_tracks_jax(tmp_path):
    """The first float32 pass of the mixed stencil solve in both
    packages, on the same right-hand side and element matrices: the
    residual histories agree to 1e-3 for the first 12 iterations."""
    jmodel = jbuild(jbox_hex8(*SIZE), jread_cnt(_deck(tmp_path)))
    ke = np.array(jstatic.compute_element_stiffness(jmodel)[0])
    free = np.ones(jmodel.n_dof_total)
    free[jmodel.fixed_dofs] = 0.0
    b = free * jmodel.f_ext
    jop = jstructured.StructuredHexOperator(
        *SIZE, jstructured.soa_from_blocks(jnp.asarray(ke, jnp.float32)),
        jnp.asarray(free, jnp.float32))
    jres = jax.jit(lambda r: jpcg(jop.apply_constrained, r,
                                  M=jop.block_jacobi(), tol=1e-6,
                                  maxiter=10000, hist_len=12))(
        jnp.asarray(b, jnp.float32))
    op = structured.StructuredHexOperator(
        *SIZE, structured.soa_from_blocks(torch.as_tensor(ke,
                                                          dtype=torch.float32)),
        torch.as_tensor(free, dtype=torch.float32))
    res = pcg(op.apply_constrained, torch.as_tensor(b, dtype=torch.float32),
              M=op.block_jacobi(), tol=1e-6, hist_len=12)
    want = np.asarray(jres.hist)
    assert (want > 0).all() and (res.hist > 0).all()
    assert np.abs(res.hist - want).max() <= 1e-3 * want.max()


def _jax_start_vectors(n0, n1, dtype, device, generator=None):
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    k0, k1 = jax.random.split(jax.random.PRNGKey(11))
    return (torch.as_tensor(np.array(jax.random.normal(k0, (n0,), jd)),
                            device=device),
            torch.as_tensor(np.array(jax.random.normal(k1, (n1,), jd)),
                            device=device))


def _floored_block_inv(D, nd):
    """The port's level-1 AMG block inverse (``amg._block_inv``: zero
    diagonal set to 1, float64 eigendecomposition, eigenvalues floored at
    100 eps(dtype) of the block's largest), written for the JAX
    package."""
    D64 = D.astype(jnp.float64)
    idx = jnp.arange(D.shape[-1])
    dd = D64[:, idx, idx]
    D64 = D64.at[:, idx, idx].add(jnp.where(dd == 0.0, 1.0, 0.0))
    lam, V = jnp.linalg.eigh(0.5 * (D64 + jnp.swapaxes(D64, 1, 2)))
    top = lam[:, -1:]
    floor = jnp.where(top > 0, top * (100.0 * jnp.finfo(D.dtype).eps), 1.0)
    lam = jnp.maximum(lam, floor)
    return jnp.einsum("aij,aj,akj->aik", V, 1.0 / lam, V).astype(D.dtype)


@pytest.fixture
def fresh_jax_traces():
    """The JAX package keeps its jitted solves traced: drop the traces
    around a test that swaps one of the functions they call."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("precond", ["jacobi", "amg"])
@pytest.mark.parametrize("policy", ["f64", "mixed"])
def test_hex8_file_deck_matches_jax(tmp_path, monkeypatch, fresh_jax_traces,
                                    policy, precond):
    """A shuffled box_hex8(5, 4, 3) deck through ``run_directory`` of
    both packages: the .msh reader sets no ``structured``, so both take
    the cluster-ELL arm (K1 with 8-node elements), block-Jacobi at this
    size or, with FRONTISTR_TPU_AMG_MIN lowered, the AMG (the port fed
    the JAX start vectors).  On this deck the JAX package's own level-1
    AMG block inverse stalls its CG at 10,000 iterations even in float64
    (the deviation of ROADMAP queue 3), so the AMG case puts the port's
    floored inverse into the JAX package, as
    ``test_torch_static_amg.test_mixed_amg_singular_block_matches_jax``
    does."""
    from frontistr_tpu.solver import amg as jamg
    monkeypatch.setenv("FRONTISTR_TPU_PRECISION", policy)
    monkeypatch.setenv("FRONTISTR_TPU_REORDER", "1")
    monkeypatch.setenv("FRONTISTR_TPU_COMPILE_CACHE", "0")
    if precond == "amg":
        monkeypatch.setenv("FRONTISTR_TPU_AMG_MIN", "100")
        monkeypatch.setattr(amg, "start_vectors", _jax_start_vectors)
        monkeypatch.setattr(jamg, "_block_inv", _floored_block_inv)
    mesh = box_hex8(5, 4, 3)
    order = np.random.default_rng(3).permutation(mesh.n_node)
    wd = str(tmp_path / "port")
    write_static_workdir(wd, ordering.permute_mesh(mesh, order), CNT)
    wj = str(tmp_path / "jax")
    shutil.copytree(wd, wj)
    jres = jrun.run_directory(wj)["static"]
    nns = []
    k1 = segsum.segsum
    monkeypatch.setattr(segsum, "segsum", lambda plan, kes, nn, nd:
                        nns.append(tuple(nn)) or k1(plan, kes, nn, nd))
    out = run_directory(wd, device="cpu")
    res = out["static"]
    assert out["model"].mesh.structured is None
    assert out["model"].blocks[0].formulation == "IC"
    assert nns and set(nns) == {(8,)}
    assert ("amg_setup" in res.timings) and res.policy == policy
    assert float(jres.relres) <= 1e-8 and res.relres <= 1e-8
    _close(res.u, jres.u, 1e-8)
    if policy == "f64":
        assert abs(res.iters - int(jres.iters)) <= 2
    else:
        assert _mixed_iters_ok(res.iters, int(jres.iters))
    got = jlogio.parse_log_summaries(os.path.join(wd, "0.log"))
    want = jlogio.parse_log_summaries(os.path.join(wj, "0.log"))
    assert got and got == want


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _deck(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        build_struct_model(box_hex8(2, 2, 2), read_cnt(p))
    with pytest.raises(RuntimeError, match="cuda"):
        model_from_numpy(jbuild(jbox_hex8(2, 2, 2), jread_cnt(p)))
