"""Dynamic load balancing: repartition a DIST workdir in place (host
code copied from ``frontistr_tpu/parallel/rebalance.py``; only the
imports differ).

Analogue of hecmw1/src/operations/dynamic_load_balancing/ (the
hecmw_dlb tool).  The reference reads the distributed — typically
adaptively-refined and therefore imbalanced — mesh, converts it to a
graph and calls ParMETIS_V3_PartKway / AdaptiveRepartKway
(hecmw_dlb_mesh2graph.c:378-430), migrates nodes/elements between MPI
ranks (hecmw_dlb_migrate.c) and rewrites the distributed mesh plus any
attached result data (hecmw_transfer_result_c.f90).

Here there are no MPI processes to migrate between — the '<base>.<rank>'
DIST files ARE the distribution and the runner reassembles them under one
device mesh (io/distio.mesh_from_dist_ranks).  The analogue is therefore
file-level: reassemble the whole model from every rank, optionally run
one adaptation pass (the reference's trigger for DLB,
hecmw_dynamic_load_balancing.c), re-partition from scratch with the
balance-aware partitioner, and atomically rewrite the rank files.  A
fresh K-way/RCB split of the refined mesh is the serial equivalent of
ParMETIS AdaptiveRepartKway: both re-equalise per-rank owned-element
counts after refinement skews them.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def workdir_ranks(base: str):
    """Paths of the '<base>.<rank>' files, rank order (run.py's rule)."""
    paths = []
    while os.path.exists(f"{base}.{len(paths)}"):
        paths.append(f"{base}.{len(paths)}")
    if not paths:
        raise FileNotFoundError(f"no rank files '{base}.0' ...")
    return paths


def owned_elem_counts(dms) -> np.ndarray:
    """Per-rank owned-element counts from the elem_ID owner column
    (hecmwST_local_mesh%elem_ID(2,:), hecmw_util_f.F90:296-312)."""
    out = np.zeros(len(dms), np.int64)
    for dm in dms:
        owners = np.asarray(dm.elem_ID, np.int64).reshape(-1, 2)[:, 1]
        out[dm.my_rank] = int((owners == dm.my_rank).sum())
    return out


def imbalance(counts: np.ndarray) -> float:
    """max/avg owned elements — ParMETIS's load-imbalance measure."""
    counts = np.asarray(counts, np.float64)
    avg = counts.mean() if counts.size else 0.0
    return float(counts.max() / avg) if avg > 0 else 1.0


def rebalance_workdir(base: str, n_parts: Optional[int] = None,
                      method: str = "RCB",
                      marked_eids: Optional[Sequence[int]] = None,
                      verbose: bool = False) -> dict:
    """Reassemble a partitioned workdir, optionally adapt, re-partition.

    marked_eids: global element ids to refine before repartitioning —
    this is the reference's adaptation+DLB pipeline (adapt each rank,
    then hecmw_dlb redistributes) run at the file level, and closes the
    'adapt an already-partitioned workdir' scope gap: adaptation runs on
    the reassembled whole model (conforming closure crosses former rank
    boundaries for free) and the fresh partition restores balance.

    Rewrites '<base>.<rank>' atomically (tmp + os.replace); stale rank
    files beyond the new n_parts are removed.  Returns stats:
    {"n_ranks", "before", "after", "imb_before", "imb_after",
     "n_elem_before", "n_elem_after"}.
    """
    from frontistr_tpu_torch.io.distio import (dist_from_subdomain,
                                         mesh_from_dist_ranks, read_dist,
                                         write_dist)
    from frontistr_tpu_torch.parallel.partition import partition_mesh

    paths = workdir_ranks(base)
    dms = [read_dist(p) for p in paths]
    before = owned_elem_counts(dms)
    mesh, _ = mesh_from_dist_ranks(dms)
    n_elem_before = mesh.n_elem
    if marked_eids is not None and len(marked_eids):
        from frontistr_tpu_torch import adapt
        mesh = adapt.adapt_mesh(mesh, marked_eids)
    n_parts = int(n_parts or len(paths))
    part, subs = partition_mesh(mesh, n_parts, method)
    for r in range(n_parts):
        dm = dist_from_subdomain(mesh, subs, r, part=part)
        tmp = f"{base}.{r}.tmp"
        write_dist(dm, tmp)
        os.replace(tmp, f"{base}.{r}")
    for r in range(n_parts, len(paths)):
        os.remove(f"{base}.{r}")
    after = owned_elem_counts([read_dist(f"{base}.{r}")
                               for r in range(n_parts)])
    stats = {
        "n_ranks": n_parts,
        "before": before.tolist(),
        "after": after.tolist(),
        "imb_before": round(imbalance(before), 4),
        "imb_after": round(imbalance(after), 4),
        "n_elem_before": int(n_elem_before),
        "n_elem_after": int(mesh.n_elem),
    }
    if verbose:
        print(f"### DLB: {len(paths)} -> {n_parts} ranks, owned elems "
              f"{before.tolist()} (imb {stats['imb_before']}) -> "
              f"{after.tolist()} (imb {stats['imb_after']})")
    return stats
