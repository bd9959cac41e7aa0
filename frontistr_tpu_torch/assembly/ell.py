"""Scalar block-ELL sparsity profile (torch port of
``frontistr_tpu/assembly/ell.py``: ``ELLProfile``, ``build_profile``,
``profile_from_model``).

The profile is the symbolic assembly of the node graph (the role of
hecmw_mat_con, hecmw1/src/solver/matrix/hecmw_mat_con.f90): padded ELL
columns per node, and the permutation that sorts every element pair
entry by its destination slot.  It is host numpy and bit-equal to the
JAX package's.  On this slice it feeds the cluster profile's scalar-slot
map and the AMG aggregation maps.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence

import numpy as np

from frontistr_tpu_torch.assembly import profsort
from frontistr_tpu_torch.assembly import segsum as segmod


@dataclasses.dataclass
class ELLProfile:
    """Static sparsity profile of the node graph."""
    n_node: int
    ndof: int
    W: int                       # max neighbors (incl. self), padded width
    cols: np.ndarray             # (N, W) int32, padded with the row index
    diag_slot: np.ndarray        # (N,) int32 slot of the diagonal block
    perm: np.ndarray             # (P,) int32 sorts pair entries by slot
    seg_sorted: np.ndarray       # (P,) int32 destination slots, sorted
    pair_counts: tuple           # entries per block (E*nn*nn each)

    @property
    def n_slots(self) -> int:
        return self.n_node * self.W

    def plan(self, device) -> segmod.SegsumPlan:
        """Device-resident segment-sum plan (cached per device)."""
        return segmod.cached_plan(self, device)


def build_profile(conns: Sequence[np.ndarray], n_node: int,
                  ndof: int) -> ELLProfile:
    """Symbolic assembly: node graph -> padded ELL columns + scatter maps."""
    rows_l, cols_l, counts = [], [], []
    for c in conns:
        E, nn = c.shape
        ct = c.T                                          # (nn, E)
        # pair order (a, b, e): e fastest, the order the segment-sum
        # kernel decodes entries in
        r = np.repeat(ct[:, None, :], nn, axis=1).reshape(-1)
        q = np.broadcast_to(ct[None, :, :], (nn, nn, E)).reshape(-1)
        rows_l.append(r.astype(np.int64))
        cols_l.append(q.astype(np.int64))
        counts.append(E * nn * nn)
    rows = np.concatenate(rows_l)
    colsv = np.concatenate(cols_l)
    key = rows * n_node + colsv
    uniq, inv = profsort.unique_inverse(key)
    urow = (uniq // n_node).astype(np.int64)
    ucol = (uniq % n_node).astype(np.int32)
    per_row = np.bincount(urow, minlength=n_node)
    W = max(int(per_row.max()) if len(per_row) else 1, 1)
    starts = np.zeros(n_node + 1, dtype=np.int64)
    np.cumsum(per_row, out=starts[1:])
    within = np.arange(len(uniq), dtype=np.int64) - starts[urow]
    cols_pad = np.repeat(np.arange(n_node, dtype=np.int32)[:, None], W,
                         axis=1)
    cols_pad[urow, within] = ucol
    uniq_slot = (urow * W + within).astype(np.int64)     # per unique pair
    slot = uniq_slot[inv]                                # per raw pair entry
    perm = profsort.stable_argsort(slot)
    seg_sorted = slot[perm].astype(np.int32)
    diag_slot = np.zeros(n_node, dtype=np.int32)
    is_diag = urow == ucol
    diag_slot[urow[is_diag]] = within[is_diag].astype(np.int32)
    return ELLProfile(n_node=n_node, ndof=ndof, W=W, cols=cols_pad,
                      diag_slot=diag_slot, perm=perm.astype(np.int32),
                      seg_sorted=seg_sorted, pair_counts=tuple(counts))


def profile_key(conns, n_node, ndof) -> str:
    h = hashlib.sha1()
    h.update(np.int64(n_node).tobytes())
    h.update(np.int64(ndof).tobytes())
    for c in conns:
        h.update(np.int64(c.shape[0]).tobytes())
        h.update(np.ascontiguousarray(c[:: max(1, c.shape[0] // 64)])
                 .tobytes())
    return h.hexdigest()


_PROFILE_CACHE: dict = {}


def model_conns(model) -> list:
    """The connectivity of the model's element blocks, then its spring
    blocks (``model.extras``)."""
    return [b.conn for b in model.blocks] + \
        list(getattr(model, "extras", ([],))[0])


def profile_from_model(model, n_node: Optional[int] = None) -> ELLProfile:
    """Build (and cache: one profile, they are large) the ELL profile of
    a StructModel, its spring blocks included."""
    conns = model_conns(model)
    nn = model.n_node if n_node is None else n_node
    key = profile_key(conns, nn, model.ndof)
    prof = _PROFILE_CACHE.get(key)
    if prof is None:
        prof = build_profile(conns, nn, model.ndof)
        _PROFILE_CACHE.clear()
        _PROFILE_CACHE[key] = prof
    return prof
