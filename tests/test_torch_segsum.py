"""K1 sorted segment-sum: the port's plain version against the JAX
package's assembly (XLA segment_sum and the Pallas kernel in interpret
mode).  The CUDA kernel is held to the plain version on the card in
tests/test_torch_segsum_cuda.py.

Tolerances: float32 within 1e-4 x max|ref| (the bar of
tests/test_segsum_pallas.py); float64 within 1e-12 x max|ref| (sums of
the same entries in another order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from frontistr_tpu.assembly import bell as jbell
from frontistr_tpu.assembly import ell as jell
from frontistr_tpu.assembly.model import build_struct_model as jbuild
from frontistr_tpu.io.ctrlio import read_cnt as jread_cnt
from frontistr_tpu.io.meshio import ElemBlock as JElemBlock
from frontistr_tpu.meshgen import box_tet4 as jbox_tet4
from frontistr_tpu_torch.assembly import bell, ell
from frontistr_tpu_torch.assembly import segsum as sm

TOL = {torch.float32: 1e-4, torch.float64: 1e-12}
CNT = ("!VERSION\n 3\n!SOLUTION, TYPE=STATIC\n!BOUNDARY\n X0, 1, 3, 0.0\n"
       "!CLOAD\n X1, 3, -1.0\n!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n"
       "!SOLVER, METHOD=CG\n 10000, 1\n 1.0e-8, 1.0, 0.0\n!END\n")


def _nodal_case(seg: np.ndarray, n_slots: int, seed: int, dtype):
    """A single block of 'elements' with one node and nd=3, so raw entry
    p is ke[p]: perm is a random permutation, seg the sorted slots."""
    rng = np.random.default_rng(seed)
    P = len(seg)
    perm = rng.permutation(P).astype(np.int32)
    ke = rng.standard_normal((P, 3, 3))
    ref = np.zeros((n_slots, 9))
    np.add.at(ref, seg, ke[perm].reshape(P, 9))
    plan = sm.make_plan(perm, seg, n_slots, (P,), "cpu")
    return plan, torch.as_tensor(ke, dtype=dtype), ref.T


def _seg_cases():
    rng = np.random.default_rng(0)
    random = np.sort(rng.integers(0, 3000, 20000)).astype(np.int32)
    empty = np.asarray([0, 0, 5, 5, 5], np.int32)          # slots 1-4 empty
    long = np.sort(np.r_[np.zeros(50, np.int64), np.full(1500, 3),
                         rng.integers(4, 40, 400)]).astype(np.int32)
    return {"random": (random, 3000), "empty_slots": (empty, 10),
            "long_segment": (long, 40)}


@pytest.mark.parametrize("case", ["random", "empty_slots", "long_segment"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_matches_numpy(case, dtype):
    seg, n_slots = _seg_cases()[case]
    plan, ke, ref = _nodal_case(seg, n_slots, 1, dtype)
    got = sm.segsum(plan, [ke], [1], 3).numpy()
    assert got.shape == (9, n_slots)
    assert np.abs(got - ref).max() <= TOL[dtype] * np.abs(ref).max()
    occupied = np.zeros(n_slots, bool)
    occupied[seg] = True
    assert (got[:, ~occupied] == 0).all()


def test_wrapper_rejects_bad_input():
    plan, ke, _ = _nodal_case(*_seg_cases()["random"], 1, torch.float64)
    with pytest.raises(TypeError):
        sm.segsum(plan, [ke.to(torch.float16)], [1], 3)
    with pytest.raises(ValueError):
        sm.segsum(plan, [ke[:, :2, :2].contiguous()], [1], 2)  # nd=3 only
    with pytest.raises(ValueError):
        sm.segsum(plan, [ke.transpose(1, 2)], [1], 3)


def _two_block_jax_model():
    mesh = jbox_tet4(3, 3, 2)
    b = mesh.blocks[0]
    h = len(b.elem_ids) // 3
    mesh.blocks = [JElemBlock(341, b.elem_ids[:h], b.conn[:h],
                              b.conn_hecmw[:h], 0),
                   JElemBlock(341, b.elem_ids[h:], b.conn[h:],
                              b.conn_hecmw[h:], 0)]
    return mesh


def _jax_model(tmp_path, mesh):
    p = tmp_path / "case.cnt"
    p.write_text(CNT)
    return jbuild(mesh, jread_cnt(str(p)))


def _random_kes(conns, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((c.shape[0], 12, 12)) for c in conns]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_assembly_matches_jax(dtype):
    mesh = jbox_tet4(3, 3, 3)
    conns = [mesh.blocks[0].conn]
    jprof = jell.build_profile(conns, mesh.n_node, 3)
    prof = ell.build_profile(conns, mesh.n_node, 3)
    kes = _random_kes(conns, 2)
    jd = jnp.float32 if dtype == torch.float32 else jnp.float64
    want = np.asarray(jell._assemble_jit(
        jprof.device(), tuple(jnp.asarray(k, jd) for k in kes), (4,)))
    raw = sm.segsum(prof.plan("cpu"),
                    [torch.as_tensor(k, dtype=dtype) for k in kes], [4], 3)
    got = raw.reshape(3, 3, prof.n_node, prof.W).permute(2, 3, 0, 1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL[dtype] * np.abs(want).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cluster_assembly_two_blocks_matches_jax(dtype):
    mesh = _two_block_jax_model()
    conns = [b.conn for b in mesh.blocks]
    jprof = jbell.build_cluster_profile(conns, mesh.n_node, 3)
    prof = bell.build_cluster_profile(conns, mesh.n_node, 3)
    kes = _random_kes(conns, 3)
    jd = jnp.float32 if dtype == torch.float32 else jnp.float64
    want_b, want_r = jbell._assemble_jit(
        jprof.device(), tuple(jnp.asarray(k, jd) for k in kes), (4, 4))
    got_b, got_r = bell.assemble_cluster(
        prof, [torch.as_tensor(k, dtype=dtype) for k in kes], [4, 4])
    want_r = np.stack([np.asarray(p) for p in want_r])
    scale = np.abs(want_r).max()
    assert np.abs(got_r.numpy() - want_r).max() <= TOL[dtype] * scale
    assert np.abs(got_b.numpy() - np.asarray(want_b)).max() \
        <= TOL[dtype] * scale


def test_from_model_matches_jax_pallas_interpret(tmp_path, monkeypatch):
    """bell.from_model of the JAX package with its Pallas segment-sum in
    interpret mode (f32) against the port's f32 cluster assembly."""
    from frontistr_tpu_torch.convert import model_from_numpy
    monkeypatch.setenv("FRONTISTR_TPU_PALLAS_ASM", "force")
    jmodel = _jax_model(tmp_path, _two_block_jax_model())
    kes = _random_kes([b.conn for b in jmodel.blocks], 4)
    jop = jbell.from_model(jmodel, [jnp.asarray(k) for k in kes],
                           dtype=jnp.float32)
    model, tkes = model_from_numpy(jmodel, "cpu", kes=kes)
    op = bell.from_model(model, tkes, dtype=torch.float32)
    want = np.asarray(jop.blocks)
    tol = 1e-4 * np.abs(want).max()
    assert np.abs(op.blocks.numpy() - want).max() <= tol
    assert np.abs(op.diag.numpy() - np.asarray(jop.diag)).max() <= tol
