"""Sorted segment-sum assembly: the K1 kernel wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``frontistr_tpu/assembly/segsum_pallas.py``
(``_kernel`` / ``make_segsum`` / ``make_planes_segsum``).  Given element
matrices of one or more element blocks and a profile's ``perm`` /
``seg_sorted`` (raw pair entries in slot order), it returns the
``(nd*nd, n_slots)`` slot planes

    out[i*nd + j, s] = sum over entries p with slot s of ke_p[i, j]

where raw pair entries run in pair order (a, b, e), e fastest, per block
(``ell.build_profile`` / ``bell.build_cluster_profile``).  Empty slots
are 0.

``segsum_planes`` is K1's generic entry, the counterpart of
``make_segsum``: it sums V value planes (V, R) over any sorted map into
(V, n_slots).  The AMG's Galerkin products and the nodal smoothing sum
through it, in a fixed order, so on the card their results repeat bit
for bit; so do the scatter-adds of ``IndexAdd`` (the !EQUATION and
contact reductions), an ``index_add`` in a fixed order.

Both wrappers take the plain version for CPU tensors (``index_add_``
of the values gathered into slot order, by ``seg_sorted``) and for CUDA
tensors launch the hand-written kernel ``csrc/segsum.cu`` or raise.  The
kernel is CUDA C++ built at first use by ``frontistr_tpu_torch.kernels``
and bound through a plain C interface with ctypes, on the lean launch
path of ``frontistr_tpu_torch.launch`` (checks once per key, the raw
stream, no device context).  The element kernel runs two passes over a
schedule built on the device once per plan (``element_schedule``: the
tiles' element-matrix row blocks, each entry's place in them, the
non-empty slots by tile and in order); the source says how that design
answers what bounds it, device-memory bytes.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from frontistr_tpu_torch import kernels, launch

_MAX_BLOCKS = 8            # kMaxBlocks in csrc/segsum.cu


@dataclasses.dataclass(eq=False)
class SegsumPlan:
    """A sorted map's segment-sum plan on one device."""
    perm: torch.Tensor        # (P,) int32: slot order -> raw entry
    seg_sorted: torch.Tensor  # (P,) int32 destination slots, ascending
    slot_ptr: torch.Tensor    # (n_slots+1,) int32 CSR pointer
    n_slots: int
    pair_counts: tuple        # raw entries per element block (sum P)
    # the slot space (A, B, W, C), slot ((a*B + b)*W + w)*C + c, or None:
    # how the element kernel tiles the slots (``element_schedule``)
    shape: Optional[tuple] = None
    # the launch path's validated keys (frontistr_tpu_torch.launch) and
    # the element kernel's schedules, by (nns, nd, value size)
    cache: dict = dataclasses.field(default_factory=dict, repr=False)
    schedules: dict = dataclasses.field(default_factory=dict, repr=False)


def make_plan(perm, seg_sorted, n_slots: int, pair_counts, device,
              shape: Optional[tuple] = None) -> SegsumPlan:
    """The plan of a sorted map: ``seg_sorted`` (P,) ascending slot ids
    in [0, n_slots) and ``perm`` (P,), raw entry of each sorted position
    (numpy arrays or tensors).  Every map goes onto ``device``, where the
    CSR pointer over ``seg_sorted`` (segment s is ``[slot_ptr[s],
    slot_ptr[s+1])``) is computed by counting.  ``pair_counts`` count
    the raw entries of each element block; ``perm`` may pick a part of
    them (a rank's rows: ``bell.build_row_cluster_profile``)."""
    dev = torch.device(device)
    perm = torch.as_tensor(perm).to(dev, torch.int32).contiguous()
    seg = torch.as_tensor(seg_sorted).to(dev, torch.int32).contiguous()
    P = int(perm.numel())
    if P >= 2 ** 31 or sum(pair_counts) < P or seg.numel() != P:
        raise ValueError(f"bad sorted map: P={P}, {seg.numel()} slot ids, "
                         f"pair_counts={pair_counts}")
    # segment s is [slot_ptr[s], slot_ptr[s+1]): the counts' prefix sum,
    # O(P + n_slots) on the device
    if P and (int(seg[0]) < 0 or int(seg[-1]) >= n_slots
              or not bool((seg[1:] >= seg[:-1]).all())):
        raise ValueError(f"slot ids must ascend within [0, {n_slots})")
    slot_ptr = torch.zeros(n_slots + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(seg, minlength=n_slots), 0,
                 out=slot_ptr[1:])
    if shape is not None and int(np.prod(shape)) != n_slots:
        raise ValueError(f"slot shape {shape} holds {int(np.prod(shape))} "
                         f"slots, not {n_slots}")
    return SegsumPlan(perm=perm, seg_sorted=seg,
                      slot_ptr=slot_ptr.to(torch.int32),
                      n_slots=int(n_slots),
                      pair_counts=tuple(int(c) for c in pair_counts),
                      shape=None if shape is None
                      else tuple(int(v) for v in shape))


def cached_plan(profile, device) -> SegsumPlan:
    """Plan of an ELL or cluster profile on ``device``, kept on the
    profile (one per device)."""
    plans = profile.__dict__.setdefault("_plans", {})
    key = str(torch.device(device))
    if key not in plans:
        plans[key] = make_plan(profile.perm, profile.seg_sorted,
                               profile.n_slots, profile.pair_counts, device,
                               getattr(profile, "slot_shape", None))
    return plans[key]


TILE_SLOTS = 4096          # most slots of a pass-1 tile
WRITE_SLOTS = 4096         # kWriteSlots in csrc/segsum.cu: a pass-2 block
SMEM_BYTES = 48 * 1024     # a pass-1 tile's stage
STAGED_SHARE = 0.99        # least share of entries in staged tiles
STAGE_READS = 1.5          # most values staged per value an entry reads
DIRECT_ITEMS = 128         # most items of an unstaged tile (kSumThreads)


@dataclasses.dataclass(eq=False)
class ElementSchedule:
    """What the element kernel reads besides the element matrices, built
    on the plan's device once per (nns, nd, value size): see
    ``element_schedule``."""
    loc: torch.Tensor          # (P,) int32 entry coordinates, slot order
    rb_src: torch.Tensor       # (n_rb,) int32/int64 row-block offsets
    rb_ptr: torch.Tensor       # (n_tiles+1,) int32 CSR over rb_src
    item_k0: torch.Tensor      # (n_items,) int32 segments of the items
    item_k1: torch.Tensor
    tile_ptr: torch.Tensor     # (n_tiles+1,) int32 CSR over the items
    nz_slot: torch.Tensor      # (n_items,) int32 non-empty slots, ascending
    nz_item: torch.Tensor      # (n_items,) int32 their items
    nz_ptr: torch.Tensor       # (n_slots / WRITE_SLOTS + 1,) int32 CSR
    bw: int                    # runs (b, w) of a tile
    C: int                     # slots of a run's row
    ct_log2: int               # a run holds 1 << ct_log2 slots
    n_chunks: int              # chunks of C a row
    n_tiles: int
    m_max: int                 # widest element matrix
    stage_rb: int              # row blocks a staged tile may hold
    vec16: bool                # row blocks alike and 16-byte aligned
    starts: tuple              # flat offset of each block's first value
    ms: tuple                  # each block's element-matrix width
    c_starts: ctypes.Array = dataclasses.field(init=False, repr=False)
    c_ms: ctypes.Array = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.c_starts = (ctypes.c_longlong * len(self.starts))(*self.starts)
        self.c_ms = (ctypes.c_int * len(self.ms))(*self.ms)


def element_schedule(plan: SegsumPlan, nns: Sequence[int], nd: int,
                     itemsize: int) -> ElementSchedule:
    """The element kernel's per-plan arrays, on the plan's device (built
    at the first call of ``segsum`` with these ``nns`` and value size,
    then kept on the plan).  The kernel runs two passes: pass 1 sums the
    non-empty slots (the items) tile by tile into an (items, nd*nd) buffer,
    pass 2 writes the planes in blocks of WRITE_SLOTS consecutive slots.

    Raw entry p of block b is pair (a, c) of element e, (a, c, e) with e
    fastest: value (i, j) of its sub-block is ke_b[e, a*nd + i, c*nd + j].
    Its row block is rows a*nd..a*nd+nd-1 of ke_b[e], nd*m contiguous
    values (m = nn*nd) from flat offset ``starts[b] + e*m*m + a*nd*m``,
    counted over the blocks' element matrices laid end to end.

    Pass 1's tiles: the slot space (A, B, W, C) of the plan's ``shape``
    (slot ((a*B + b)*W + w)*C + c), else (1, 1, 1, n_slots).  A tile is
    one a, every (b, w) and CT consecutive c, tile t = a * n_chunks + c //
    CT.  Its row blocks are the distinct ones of its entries within each
    (a, c): for the cluster profile's (aoff, boff, wc, cluster) every
    entry of a row block lies in one (aoff, cluster), so a row block is
    read once.  A tile stages its row blocks in shared memory only where
    they hold at most ``STAGE_READS`` times the values its entries read
    (a shape without such reuse reads every tile from device memory).
    CT is the largest power of two that keeps a tile within
    ``TILE_SLOTS`` slots and the stages of the tiles that hold
    ``STAGED_SHARE`` of the entries within ``SMEM_BYTES`` (an unstaged
    shape: DIRECT_ITEMS items a tile); the other tiles are read from
    device memory.  Without such a CT, the shape falls back to (1, 1, 1,
    n_slots).

    - ``rb_src``/``rb_ptr``: the tiles' row-block offsets, by tile
      (int32 while the blocks hold fewer than 2**31 values, else int64);
    - ``loc``: entry k's row block r within its tile and column sub-block
      c, ``r*nd*m_max + c*nd``;
    - the items: the non-empty slots by tile, longest segment first
      within a tile (``item_k0``/``item_k1``: the segment), ``tile_ptr``
      the CSR pointer of the tiles over them;
    - ``nz_slot``/``nz_item``: the non-empty slots ascending and their
      items, ``nz_ptr`` the CSR pointer of pass 2's blocks over them."""
    key = (tuple(nns), nd, itemsize)
    got = plan.schedules.get(key)
    if got is not None:
        return got
    dev = plan.slot_ptr.device
    ms = [nn * nd for nn in nns]
    m_max = max(ms)
    rbs = nd * m_max
    Es = [cnt // (nn * nn) for cnt, nn in zip(plan.pair_counts, nns)]
    starts = np.zeros(len(nns) + 1, np.int64)
    np.cumsum([E * m * m for E, m in zip(Es, ms)], out=starts[1:])
    poff = np.zeros(len(nns) + 1, np.int64)
    np.cumsum(plan.pair_counts, out=poff[1:])
    total = int(starts[-1]) + 1
    isz_idx = 4 if total <= 2 ** 31 else 8
    # offsets below 2**31 are decoded in int32 (half the bytes)
    idx = torch.int32 if isz_idx == 4 else torch.int64

    def per_block(vals):
        return torch.as_tensor(np.asarray(vals, np.int64), device=dev,
                               ).to(idx)

    q = plan.perm.to(idx)
    if len(nns) == 1:
        E, nn, m = Es[0], nns[0], ms[0]
        base = 0
    else:
        b = torch.bucketize(q, per_block(poff[1:]), right=True)
        E, nn, m = per_block(Es)[b], per_block(nns)[b], per_block(ms)[b]
        q = q - per_block(poff)[b]
        base = per_block(starts)[b]
        del b
    a, r = q // (nn * E), q % (nn * E)
    c, e = r // E, r % E
    rb = base + e * m * m + a * nd * m
    del q, a, r, e, base

    seg = plan.seg_sorted
    ptr = plan.slot_ptr
    lens = ptr[1:] - ptr[:-1]
    s = torch.nonzero(lens).squeeze(1)
    lens = lens[s]
    budget = SMEM_BYTES // (rbs * itemsize + isz_idx)
    shapes = ([plan.shape] if plan.shape else []) + [(1, 1, 1,
                                                      plan.n_slots)]
    best = None
    for A, B, W, C in shapes:
        bw = B * W
        if bw > TILE_SLOTS:
            continue
        # the (a, c) column of each entry and its distinct row blocks
        fine = (seg // (C * bw)) * C + seg % C
        key_s, by_key = torch.sort(fine.long() * total + rb)
        first = torch.ones_like(key_s, dtype=torch.bool)
        torch.ne(key_s[1:], key_s[:-1], out=first[1:])
        uniq = key_s[first]
        inv = torch.empty_like(by_key)
        inv[by_key] = torch.cumsum(first, 0) - 1
        del key_s, by_key, first
        rb_fine = (uniq // total).int()
        fine_s = (s // (C * bw)) * C + s % C
        stage = uniq.numel() * rbs <= STAGE_READS * seg.numel() * nd * nd
        # items, row blocks and entries of each (a, c) column, summed
        # per tile for each CT
        per_fine = [torch.bincount(f, minlength=A * C)
                    for f in (fine_s, rb_fine, fine)]
        col = torch.arange(A * C, device=dev)
        for ct_log2 in range((TILE_SLOTS // bw).bit_length() - 1, -1, -1):
            n_chunks = -(-C // (1 << ct_log2))
            n_tiles = A * n_chunks

            def tile_of(f):
                return (f // C) * n_chunks + ((f % C) >> ct_log2)

            tcol = tile_of(col)
            n_items, n_rb, n_ent = (
                torch.zeros(n_tiles, dtype=torch.int64, device=dev)
                .index_add_(0, tcol, cnt) for cnt in per_fine)
            if stage:
                n_all = int(n_ent.sum())
                ok = not n_all or float(
                    n_ent[n_rb <= budget].sum()) >= STAGED_SHARE * n_all
            else:
                ok = not n_tiles or int(n_items.max()) <= DIRECT_ITEMS
            best = (bw, C, fine, uniq, inv, fine_s, ct_log2, n_chunks,
                    n_tiles, n_items, n_rb, budget if stage else -1)
            if ok:
                break
        if ok:
            break
    (bw, C, fine, uniq, inv, fine_s, ct_log2, n_chunks, n_tiles, n_items,
     n_rb, budget) = best
    fits = n_rb[n_rb <= budget]
    stage_rb = int(fits.max()) if fits.numel() else 0
    rb_ptr = torch.zeros(n_tiles + 1, dtype=torch.int64, device=dev)
    torch.cumsum(n_rb, 0, out=rb_ptr[1:])
    tile_e = (fine // C) * n_chunks + ((fine % C) >> ct_log2)
    loc = (inv - rb_ptr[tile_e]) * rbs + c * nd
    tile = (fine_s // C) * n_chunks + ((fine_s % C) >> ct_log2)
    longest = int(lens.max()) if lens.numel() else 0
    order = torch.sort(tile * (longest + 1) + (longest - lens),
                       stable=True)[1]
    tile_ptr = torch.zeros(n_tiles + 1, dtype=torch.int64, device=dev)
    torch.cumsum(n_items, 0, out=tile_ptr[1:])
    nz_item = torch.empty_like(order)
    nz_item[order] = torch.arange(order.numel(), device=dev)
    n_write = -(-plan.n_slots // WRITE_SLOTS)
    nz_ptr = torch.zeros(n_write + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(s // WRITE_SLOTS, minlength=n_write), 0,
                 out=nz_ptr[1:])
    so = s[order]
    got = ElementSchedule(
        loc=loc.to(torch.int32),
        rb_src=(uniq % total).to(torch.int32 if isz_idx == 4
                                 else torch.int64),
        rb_ptr=rb_ptr.to(torch.int32), item_k0=ptr[so].to(torch.int32),
        item_k1=ptr[so + 1].to(torch.int32),
        tile_ptr=tile_ptr.to(torch.int32), nz_slot=s.to(torch.int32),
        nz_item=nz_item.to(torch.int32), nz_ptr=nz_ptr.to(torch.int32),
        bw=bw, C=int(C), ct_log2=ct_log2, n_chunks=int(n_chunks),
        n_tiles=int(n_tiles), m_max=m_max, stage_rb=stage_rb,
        vec16=bool(min(ms) == m_max and rbs * itemsize % 16 == 0
                   and not bool(((uniq % total) * itemsize % 16).any())),
        starts=tuple(int(v) for v in starts), ms=tuple(ms))
    plan.schedules[key] = got
    return got


def entry_planes(kes: Sequence[torch.Tensor], nns: Sequence[int],
                 nd: int) -> torch.Tensor:
    """(nd*nd, P) entries in raw pair order (a, b, e), e fastest."""
    planes = []
    for ke, nn in zip(kes, nns):
        E = ke.shape[0]
        kr = ke.reshape(E, nn, nd, nn, nd)
        planes.append(kr.permute(2, 4, 1, 3, 0).reshape(nd * nd,
                                                        nn * nn * E))
    return torch.cat(planes, dim=1)


def segsum_reference(plan: SegsumPlan, kes: Sequence[torch.Tensor],
                     nns: Sequence[int], nd: int) -> torch.Tensor:
    """Plain PyTorch version (any device): gather the entry planes into
    slot order, then ``index_add_`` them by ``seg_sorted``."""
    ent = entry_planes(kes, nns, nd)
    out = torch.zeros((nd * nd, plan.n_slots), dtype=ent.dtype,
                      device=ent.device)
    out.index_add_(1, plan.seg_sorted.long(), ent[:, plan.perm.long()])
    return out


def segsum(plan: SegsumPlan, kes: Sequence[torch.Tensor],
           nns: Sequence[int], nd: int) -> torch.Tensor:
    """(nd*nd, n_slots) slot planes.  CPU tensors: the plain version;
    CUDA tensors: the K1 kernel (``csrc/segsum.cu``), or an exception."""
    got = launch.cached(plan.cache, _plan_elements, *kes, plan.perm,
                        plan.slot_ptr,
                        extra=(tuple(nns), nd, plan.pair_counts))
    if got is None:
        return segsum_reference(plan, kes, nns, nd)
    fn, dev, is_double = got
    sc = element_schedule(plan, nns, nd, kes[0].element_size())
    out = kes[0].new_empty((nd * nd, plan.n_slots))
    sums = kes[0].new_empty((sc.nz_slot.numel(), nd * nd))
    launch.launch(fn, dev, nd, is_double, sc.rb_src.dtype == torch.int64,
                  sc.loc.data_ptr(), sc.rb_src.data_ptr(),
                  sc.rb_ptr.data_ptr(), sc.item_k0.data_ptr(),
                  sc.item_k1.data_ptr(), sc.tile_ptr.data_ptr(), sc.n_tiles,
                  sc.nz_slot.data_ptr(), sc.nz_item.data_ptr(),
                  sc.nz_ptr.data_ptr(), plan.n_slots, sc.m_max, sc.stage_rb,
                  int(sc.vec16 and not any(k.data_ptr() % 16 for k in kes)),
                  (ctypes.c_void_p * len(kes))(*[k.data_ptr() for k in kes]),
                  sc.c_starts, sc.c_ms, len(kes), sums.data_ptr(),
                  out.data_ptr())
    segsum.launches += 1
    return out


segsum.launches = 0     # K1 launches, both passes (plain calls excluded)


def segsum_planes_reference(values: torch.Tensor,
                            plan: SegsumPlan) -> torch.Tensor:
    """Plain PyTorch version of ``segsum_planes`` (any device):
    ``index_add_`` of the values gathered into slot order by
    ``seg_sorted``."""
    out = values.new_zeros((values.shape[0], plan.n_slots))
    out.index_add_(1, plan.seg_sorted.long(), values[:, plan.perm.long()])
    return out


def segsum_planes(values: torch.Tensor, plan: SegsumPlan) -> torch.Tensor:
    """(V, n_slots) planes ``out[v, s] = sum over k in segment s of
    values[v, perm[k]]`` of values (V, R), R = the plan's P; empty slots
    are 0 (the counterpart of ``make_segsum``).  CPU tensors: the plain
    version; CUDA tensors: K1's planes kernel (``csrc/segsum.cu``), or an
    exception.  Each slot's sum runs in ascending k, so on the card a
    relaunch is bit-equal."""
    got = launch.cached(plan.cache, _plan_planes, values, plan.perm,
                        plan.slot_ptr)
    if got is None:
        return segsum_planes_reference(values, plan)
    fn, dev, is_double = got
    V, R = values.shape
    out = values.new_empty((V, plan.n_slots))
    launch.launch(fn, dev, is_double, values.data_ptr(), V, R,
                  plan.slot_ptr.data_ptr(), plan.perm.data_ptr(),
                  plan.n_slots, out.data_ptr())
    segsum_planes.launches += 1
    return out


segsum_planes.launches = 0  # planes kernel launches (plain calls excluded)


@dataclasses.dataclass(eq=False)
class IndexAdd:
    """``y.index_add(0, idx, v)`` of a fixed index list in a fixed order:
    each distinct target sums its own value first, then the entries
    aimed at it in list order, through K1's planes entry.  Entries known
    to carry 0 may stay out of the plan (``keep``): a slot is one
    thread's serial sum, so thousands of padding entries aimed at one
    index would serialise the launch."""
    targets: torch.Tensor        # (U,) int64 distinct targets, ascending
    keep: torch.Tensor           # (P,) int64 entries in the plan, or None
    plan: SegsumPlan      # U + P entries -> U slots

    @classmethod
    def build(cls, idx, device, keep=None) -> "IndexAdd":
        """The plan of the host index list ``idx`` on ``device``;
        ``keep`` (a host bool mask over ``idx``) the entries that may be
        nonzero, all without it."""
        idx = np.asarray(idx, np.int64).reshape(-1)
        if keep is not None:
            keep = np.flatnonzero(np.asarray(keep).reshape(-1))
            idx = idx[keep]
        targets = np.unique(idx)
        U = len(targets)
        seg = np.concatenate([np.arange(U), np.searchsorted(targets, idx)])
        perm = np.argsort(seg, kind="stable")
        plan = make_plan(perm, seg[perm], U, (U + len(idx),), device)
        dev = plan.perm.device
        return cls(torch.as_tensor(targets, device=dev),
                   None if keep is None else torch.as_tensor(keep,
                                                              device=dev),
                   plan)

    def __call__(self, y: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """``y`` with ``v`` (one value per entry of the index list) added
        at the plan's indices."""
        v = v.reshape(-1)
        if self.keep is not None:
            v = v[self.keep]
        vals = torch.cat([y[self.targets], v.to(y.dtype)])
        return y.index_put((self.targets,),
                           segsum_planes(vals[None], self.plan)[0])


def _plan_planes(values, perm, slot_ptr):
    dev = values.device
    if values.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"segsum_planes: dtype {values.dtype} "
                        "(float32/float64 only)")
    if values.dim() != 2 or values.shape[0] < 1 \
            or values.shape[1] != perm.numel():
        raise ValueError(f"segsum_planes: values {tuple(values.shape)}, "
                         f"want (V >= 1, {perm.numel()})")
    if not values.is_contiguous():
        raise ValueError("segsum_planes: values not contiguous")
    if perm.device != dev or slot_ptr.device != dev:
        raise ValueError(f"segsum_planes: values on {dev}, plan on "
                         f"{perm.device}")
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"segsum_planes: unsupported device {dev}")
    lib = kernels.load("segsum", _SIGNATURES)
    return lib.fstr_segsum_planes, dev.index, int(values.dtype ==
                                                  torch.float64)


def _plan_elements(*args):
    """The element wrapper's checks: args = (*kes, perm, slot_ptr, nns,
    nd, pair_counts)."""
    *kes, perm, slot_ptr, nns, nd, pair_counts = args
    dev = kes[0].device
    dtype = kes[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"segsum: dtype {dtype} (float32/float64 only)")
    if nd not in (2, 3, 4, 6):
        raise ValueError(f"segsum: nd={nd} (2 or 3 for the solids, 4 for "
                         "the u-p flow element, 6 for shells and beams)")
    if not 1 <= len(kes) <= _MAX_BLOCKS or len(kes) != len(nns):
        raise ValueError(f"segsum: {len(kes)} element blocks "
                         f"(1..{_MAX_BLOCKS} supported)")
    if len(pair_counts) != len(kes):
        raise ValueError("segsum: plan and element blocks disagree")
    for ke, nn, cnt in zip(kes, nns, pair_counts):
        m = nn * nd
        if ke.device != dev or ke.dtype != dtype:
            raise ValueError("segsum: element blocks on mixed "
                             "devices/dtypes")
        if ke.dim() != 3 or tuple(ke.shape[1:]) != (m, m):
            raise ValueError(f"segsum: ke shape {tuple(ke.shape)}, "
                             f"want (E, {m}, {m})")
        if not ke.is_contiguous():
            raise ValueError("segsum: element matrices not contiguous")
        if ke.shape[0] * nn * nn != cnt:
            raise ValueError("segsum: element count disagrees with plan")
    if perm.device != dev or slot_ptr.device != dev:
        raise ValueError(f"segsum: element matrices on {dev}, plan on "
                         f"{perm.device}")
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"segsum: unsupported device {dev}")
    lib = kernels.load("segsum", _SIGNATURES)
    return lib.fstr_segsum, dev.index, int(dtype == torch.float64)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# each ends in (stream, device index)
_SIGNATURES = {
    "fstr_segsum": (
        [_I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _L, _I, _I, _I,
         ctypes.POINTER(_P), ctypes.POINTER(_L), ctypes.POINTER(_I), _I, _P,
         _P, _P, _I], _I),
    "fstr_segsum_planes": ([_I, _P, _I, _L, _P, _P, _L, _P, _P, _I], _I),
}
