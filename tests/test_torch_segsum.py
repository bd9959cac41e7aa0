"""K1 sorted segment-sum: the port's plain versions (the element
assembly ``segsum`` and the generic planes entry ``segsum_planes``)
against the JAX package (XLA segment_sum and the Pallas kernel of
``make_segsum`` in interpret mode).  The CUDA kernels are held to the
plain versions on the card in tests/test_torch_segsum_cuda.py.

Tolerances: float32 within 1e-4 x max|ref| (the bar of
tests/test_segsum_pallas.py); float64 within 1e-12 x max|ref| (sums of
the same entries in another order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from frontistr_tpu.assembly import bell as jbell
from frontistr_tpu.assembly import ell as jell
from frontistr_tpu.assembly.model import build_struct_model as jbuild
from frontistr_tpu.io.ctrlio import read_cnt as jread_cnt
from frontistr_tpu.io.meshio import ElemBlock as JElemBlock
from frontistr_tpu.assembly.segsum_pallas import make_segsum
from frontistr_tpu.meshgen import box_tet4 as jbox_tet4
from frontistr_tpu.solver import amg as jamg
from frontistr_tpu_torch.assembly import bell, ell
from frontistr_tpu_torch.assembly import segsum as sm
from frontistr_tpu_torch.post import nodal

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


@pytest.mark.parametrize("case", ["random", "empty_slots", "long_segment"])
def test_counted_slot_ptr_equals_searchsorted(case):
    """make_plan counts the segments (bincount + cumsum); the pointer is
    bit-equal to the searchsorted one of the first plan."""
    seg, n_slots = _seg_cases()[case]
    plan = sm.make_plan(np.arange(len(seg), dtype=np.int32), seg, n_slots,
                        (len(seg),), "cpu")
    want = np.searchsorted(seg, np.arange(n_slots + 1),
                           side="left").astype(np.int32)
    assert plan.slot_ptr.dtype == torch.int32
    assert np.array_equal(plan.slot_ptr.numpy(), want)


@pytest.mark.parametrize("seg", [[0, 2, 1], [0, 1, 10], [-1, 0, 0]])
def test_make_plan_rejects_unsorted_or_out_of_range(seg):
    with pytest.raises(ValueError):
        sm.make_plan(np.arange(3, dtype=np.int32),
                     np.asarray(seg, np.int32), 10, (3,), "cpu")


def test_wrapper_rejects_bad_input():
    plan, ke, _ = _nodal_case(*_seg_cases()["random"], 1, torch.float64)
    with pytest.raises(TypeError):
        sm.segsum(plan, [ke.to(torch.float16)], [1], 3)
    with pytest.raises(ValueError):       # nd = 2, 3, 4 or 6 only
        sm.segsum(plan, [torch.zeros((ke.shape[0], 5, 5),
                                     dtype=ke.dtype)], [1], 5)
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


# --- the element kernel's schedule (element_schedule), read on the host


def _two_block_profile():
    """The cluster profile of box_tet4(3, 3, 2) cut into two blocks."""
    conn = jbox_tet4(3, 3, 2).blocks[0].conn
    h = conn.shape[0] // 3
    conns = [conn[:h], conn[h:]]
    return bell.build_cluster_profile(conns, 48, 3), conns


def _entry_tiles(plan, sc):
    """The tile of each entry in slot order, from the schedule's tiling."""
    seg = plan.seg_sorted.numpy().astype(np.int64)
    fine = (seg // (sc.C * sc.bw)) * sc.C + seg % sc.C
    return (fine // sc.C) * sc.n_chunks + ((fine % sc.C) >> sc.ct_log2)


def _entry_offsets(plan, sc):
    """Each entry's (0, 0) value offset, decoded from the schedule: its
    tile's row block r and column sub-block c from loc."""
    loc = sc.loc.numpy().astype(np.int64)
    rbs = 3 * sc.m_max
    r, off = loc // rbs, loc % rbs
    rb = sc.rb_src.numpy().astype(np.int64)
    return rb[sc.rb_ptr.numpy()[_entry_tiles(plan, sc)] + r] + off


@pytest.mark.parametrize("itemsize", [4, 8])
def test_schedule_offsets_equal_the_decode(itemsize):
    """Each entry's source offset, decoded on the host from its tile's
    row blocks, is the first kernel's decode of perm[k] (a search over
    the block offsets and two divisions): element e, sub-block (a, c) of
    block b; and every row block is read by one tile only."""
    prof, conns = _two_block_profile()
    plan = prof.plan("cpu")
    sc = sm.element_schedule(plan, [4, 4], 3, itemsize)
    assert sc.rb_src.dtype == torch.int32 and plan.shape == prof.slot_shape
    assert sc.rb_src.numel() == len(np.unique(sc.rb_src.numpy()))
    off = np.r_[0, np.cumsum(plan.pair_counts)]
    want = []
    for p in plan.perm.numpy().astype(np.int64):
        b = int(np.searchsorted(off, p, side="right") - 1)
        E, nn = conns[b].shape
        m = 3 * nn
        q = p - off[b]
        a, r = divmod(q, nn * E)
        c, e = divmod(r, E)
        want.append(sc.starts[b] + e * m * m + a * 3 * m + c * 3)
    assert np.array_equal(_entry_offsets(plan, sc), np.asarray(want))


def _emulate_element_kernel(plan, kes, nns):
    """The element kernel's two passes on the host.  Pass 1, per tile:
    its row blocks staged (rows of m_max values) when they fit, then each
    item's nine sums in ascending k, read from the stage or from the
    element matrices at the same coordinates.  Pass 2: every slot's
    planes from its item's sums, zeros for empty slots."""
    sc = sm.element_schedule(plan, nns, 3, 8)
    tile_ptr, rb_ptr = sc.tile_ptr.numpy(), sc.rb_ptr.numpy()
    k0s, k1s = sc.item_k0.numpy(), sc.item_k1.numpy()
    rb_src = sc.rb_src.numpy().astype(np.int64)
    loc = sc.loc.numpy().astype(np.int64)
    flat = np.concatenate([k.numpy().reshape(-1) for k in kes])
    starts, widths = np.asarray(sc.starts), np.asarray(sc.ms)
    offsets = _entry_offsets(plan, sc)
    width = widths[np.searchsorted(starts, offsets, side="right") - 1]
    assert (sc.bw << sc.ct_log2) <= sm.TILE_SLOTS
    rbs = 3 * sc.m_max
    sums = np.full((len(k0s), 9), np.nan)
    for tile in range(sc.n_tiles):
        n_rb = rb_ptr[tile + 1] - rb_ptr[tile]
        stage = None
        if n_rb <= sc.stage_rb:
            stage = np.zeros(n_rb * rbs)
            for r, g in enumerate(rb_src[rb_ptr[tile]:rb_ptr[tile + 1]]):
                m = widths[np.searchsorted(starts, g, side="right") - 1]
                for i in range(3):
                    stage[r * rbs + i * sc.m_max:][:m] = \
                        flat[g + i * m:g + (i + 1) * m]
        its = range(tile_ptr[tile], tile_ptr[tile + 1])
        lens = [k1s[it] - k0s[it] for it in its]
        assert lens == sorted(lens, reverse=True) and min(lens + [1]) > 0
        for it in its:
            ks = np.arange(k0s[it], k1s[it])
            assert (_entry_tiles(plan, sc)[ks] == tile).all()
            for v in range(9):
                i, j = divmod(v, 3)
                xs = flat[offsets[ks] + i * width[ks] + j]
                if stage is not None:
                    assert np.array_equal(
                        stage[loc[ks] + i * sc.m_max + j], xs)
                total = 0.0
                for x in xs:
                    total += x
                sums[it, v] = total
    out = np.zeros((9, plan.n_slots))
    nz_slot, nz_item = sc.nz_slot.numpy(), sc.nz_item.numpy()
    nz_ptr = sc.nz_ptr.numpy()
    assert nz_ptr[-1] == len(nz_slot) and (np.diff(nz_slot) > 0).all()
    for blk in range(len(nz_ptr) - 1):
        for p in range(nz_ptr[blk], nz_ptr[blk + 1]):
            assert nz_slot[p] // sm.WRITE_SLOTS == blk
            out[:, nz_slot[p]] = sums[nz_item[p]]
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("case", ["random", "empty_slots", "long_segment",
                                  "two_block_cluster", "cluster_chunks"])
def test_element_kernel_schedule_matches_plain(case):
    """The element kernel's loops, run on the host over its schedule,
    give the plain version's planes bit for bit (float64: both add each
    slot's entries in ascending k).  ``cluster_chunks``: one block whose
    clusters fill several tile chunks (tiles cut to the shared-memory
    stage), the last one ragged."""
    if case in ("two_block_cluster", "cluster_chunks"):
        if case == "two_block_cluster":
            prof, conns = _two_block_profile()
        else:
            mesh = jbox_tet4(10, 8, 6)
            conns = [mesh.blocks[0].conn]
            prof = bell.build_cluster_profile(conns, mesh.n_node, 3)
        plan = prof.plan("cpu")
        kes = [torch.as_tensor(k) for k in _random_kes(conns, 16)]
        nns = [4] * len(conns)
        if case == "cluster_chunks":
            sc = sm.element_schedule(plan, nns, 3, 8)
            assert sc.bw == prof.G * prof.Wc
            assert sc.n_chunks > 1 and sc.C % (1 << sc.ct_log2)
    else:
        seg, n_slots = _seg_cases()[case]
        plan, ke, _ = _nodal_case(seg, n_slots, 17, torch.float64)
        kes, nns = [ke], [1]
    got = _emulate_element_kernel(plan, kes, nns)
    want = sm.segsum_reference(plan, kes, nns, 3).numpy()
    assert np.array_equal(got, want)


# --- the planes entry (segsum_planes), the counterpart of make_segsum


def _planes_case(seg: np.ndarray, n_slots: int, V: int, seed: int):
    """V random value planes over P = len(seg) raw entries and a random
    perm: (plan, values (V, P) float64 numpy, values in slot order)."""
    rng = np.random.default_rng(seed)
    P = len(seg)
    perm = rng.permutation(P).astype(np.int32)
    values = rng.standard_normal((V, P))
    return (sm.make_plan(perm, seg, n_slots, (P,), "cpu"), values,
            values[:, perm])


def _jax_make_segsum(sorted_vals: np.ndarray, seg: np.ndarray,
                     n_slots: int) -> np.ndarray:
    """The Pallas kernel of ``make_segsum`` (interpret mode off the TPU)
    on values already in slot order, (V <= 15, P) float32."""
    V, P = sorted_vals.shape
    run, aux = make_segsum(seg, n_slots, c_ent=512)
    ent_pad = np.zeros((P + 1, 16), np.float32)
    ent_pad[:P, :V] = sorted_vals.T
    fm = np.asarray(aux["ent_map"])
    entT = jnp.asarray(ent_pad[np.where(fm < P, fm, P)].T.copy())
    return np.asarray(run(entT, aux["seg_pad"], aux["slot_src"]))[:V]


def _jax_segment_sum(sorted_vals: np.ndarray, seg: np.ndarray,
                     n_slots: int) -> np.ndarray:
    return np.asarray(jax.ops.segment_sum(
        jnp.asarray(sorted_vals.T), jnp.asarray(seg), num_segments=n_slots,
        indices_are_sorted=True)).T


@pytest.mark.parametrize("case", ["random", "empty_slots", "long_segment"])
def test_planes_matches_jax_pallas_interpret(case):
    seg, n_slots = _seg_cases()[case]
    plan, values, sorted_vals = _planes_case(seg, n_slots, 7, 11)
    want = _jax_make_segsum(sorted_vals.astype(np.float32), seg, n_slots)
    got = sm.segsum_planes(torch.as_tensor(values, dtype=torch.float32),
                           plan).numpy()
    assert got.shape == want.shape == (7, n_slots)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("case", ["random", "empty_slots", "long_segment"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_planes_matches_jax_segment_sum(case, dtype):
    seg, n_slots = _seg_cases()[case]
    plan, values, sorted_vals = _planes_case(seg, n_slots, 5, 12)
    want = _jax_segment_sum(sorted_vals, seg, n_slots)
    got = sm.segsum_planes(torch.as_tensor(values, dtype=dtype),
                           plan).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL[dtype] * np.abs(want).max()
    occupied = np.zeros(n_slots, bool)
    occupied[seg] = True
    assert (got[:, ~occupied] == 0).all()


@pytest.mark.parametrize("level", ["01", "12"])
def test_planes_on_amg_maps_match_jax(level):
    """The AMG's Galerkin maps of a small tet deck, built by the JAX
    package: float64 against segment_sum (36 planes, as the AMG sums),
    float32 against the Pallas kernel (9 planes)."""
    mesh = jbox_tet4(6, 4, 4)
    jprof = jell.build_profile([mesh.blocks[0].conn], mesh.n_node, 3)
    jm = jamg.build_maps(jprof.cols, jprof.n_node, 3)
    perm, seg = getattr(jm, "perm" + level), getattr(jm, "seg" + level)
    n_slots = jm.Na * jm.Wc if level == "01" else jm.Na2 * jm.Na2
    P = len(perm)
    plan = sm.make_plan(perm, seg, n_slots, (P,), "cpu")
    values = np.random.default_rng(13).standard_normal((36, P))
    want = _jax_segment_sum(values[:, perm], seg, n_slots)
    got = sm.segsum_planes(torch.as_tensor(values), plan).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    want = _jax_make_segsum(values[:9, perm].astype(np.float32), seg,
                            n_slots)
    got = sm.segsum_planes(torch.as_tensor(values[:9], dtype=torch.float32),
                           plan).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_node_plan_sums_in_index_add_order():
    """Nodal smoothing's plan (a stable sort of the flat connectivity of
    two blocks): on the CPU the planes entry is bit-equal to index_add_
    block by block, the sum it replaced."""
    rng = np.random.default_rng(14)
    conns = [rng.integers(0, 60, (40, 4)), rng.integers(0, 60, (30, 8))]
    vals = [torch.as_tensor(rng.standard_normal((c.size, 13)))
            for c in conns]
    want = torch.zeros((60, 13), dtype=torch.float64)
    for c, v in zip(conns, vals):
        want.index_add_(0, torch.as_tensor(c.reshape(-1)), v)
    plan = nodal.node_plan(np.concatenate([c.reshape(-1) for c in conns]),
                           60, "cpu")
    got = sm.segsum_planes(torch.cat(vals).T.contiguous(), plan)
    assert torch.equal(got.T, want)


@pytest.mark.parametrize("fault,error", [("dtype", TypeError),
                                         ("length", ValueError),
                                         ("strides", ValueError),
                                         ("device", ValueError)])
def test_planes_rejects_bad_input(fault, error):
    """After good calls have cached their key, a call with another dtype,
    another length, other strides or another device is checked anew and
    raises."""
    seg, n_slots = _seg_cases()["random"]
    plan, values, _ = _planes_case(seg, n_slots, 3, 15)
    good = torch.as_tensor(values)
    sm.segsum_planes(good, plan)
    sm.segsum_planes(good, plan)
    bad = {"dtype": lambda: good.to(torch.float16),
           "length": lambda: good[:, 1:].contiguous(),
           "strides": lambda: good.T.contiguous().T,
           "device": lambda: good.to("meta")}[fault]()
    with pytest.raises(error):
        sm.segsum_planes(bad, plan)


@pytest.mark.parametrize("etype", [231, 232, 241, 242])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plane_cluster_assembly_matches_jax(etype, dtype):
    """nd = 2: the cluster assembly of a plane box's element matrices
    (the element entry's four planes) against the JAX package's."""
    from frontistr_tpu_torch.meshgen import box_plane
    mesh = box_plane(7, 5, etype=etype)
    conns = [mesh.blocks[0].conn]
    nn = conns[0].shape[1]
    jprof = jbell.build_cluster_profile(conns, mesh.n_node, 2)
    prof = bell.build_cluster_profile(conns, mesh.n_node, 2)
    kes = [np.random.default_rng(4).standard_normal(
        (conns[0].shape[0], 2 * nn, 2 * nn))]
    jd = jnp.float32 if dtype == torch.float32 else jnp.float64
    want_b, want_r = jbell._assemble_jit(
        jprof.device(), tuple(jnp.asarray(k, jd) for k in kes), (nn,))
    got_b, got_r = bell.assemble_cluster(
        prof, [torch.as_tensor(k, dtype=dtype) for k in kes], [nn])
    want_r = np.stack([np.asarray(p) for p in want_r])
    assert got_r.shape == want_r.shape and got_r.shape[0] == 4
    scale = np.abs(want_r).max()
    assert np.abs(got_r.numpy() - want_r).max() <= TOL[dtype] * scale
    assert np.abs(got_b.numpy() - np.asarray(want_b)).max() \
        <= TOL[dtype] * scale
