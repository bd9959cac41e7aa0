"""Mesh precheck: element quality metrics and the nonzero profile
(``!SOLUTION, TYPE=ELEMCHECK | PRECHECK | NZPROF``), host numpy copied
from ``frontistr_tpu/precheck.py``.

Rebuild of fstr_precheck (fistr1/src/common/fstr_precheck.f90 +
precheck_LIB_{2d,3d}.f90): per-element volume/area, minimum Jacobian over
quadrature points, aspect ratio (max/min edge), and a global summary;
``nzprof`` writes the node graph's nonzero profile and a gnuplot script.
Element types without a table (shells, beams) are left out of the
summary, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from frontistr_tpu_torch.elements.tables import get_table

_EDGES = {
    231: [(0, 1), (1, 2), (2, 0)],
    241: [(0, 1), (1, 2), (2, 3), (3, 0)],
    341: [(0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3)],
    351: [(0, 1), (1, 2), (2, 0), (3, 4), (4, 5), (5, 3), (0, 3), (1, 4),
          (2, 5)],
    361: [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
          (0, 4), (1, 5), (2, 6), (3, 7)],
}
_EDGES[232] = _EDGES[231]
_EDGES[242] = _EDGES[241]
_EDGES[342] = _EDGES[341]
_EDGES[352] = _EDGES[351]
_EDGES[362] = _EDGES[361]


@dataclasses.dataclass
class PrecheckReport:
    total_volume: float
    min_volume: float
    min_jacobian: float
    max_aspect: float
    n_degenerate: int
    per_block: List[dict]

    def summary(self) -> str:
        lines = ["##### PRECHECK SUMMARY #####",
                 f" total volume      : {self.total_volume:12.5E}",
                 f" min element volume: {self.min_volume:12.5E}",
                 f" min jacobian      : {self.min_jacobian:12.5E}",
                 f" max aspect ratio  : {self.max_aspect:12.5E}",
                 f" degenerate elems  : {self.n_degenerate}"]
        return "\n".join(lines)


def precheck(mesh, dim=None) -> PrecheckReport:
    total_v = 0.0
    min_v = np.inf
    min_j = np.inf
    max_a = 0.0
    ndeg = 0
    per_block = []
    for b in mesh.blocks:
        try:
            t = get_table(b.etype)
        except KeyError:
            continue
        d = t.dim
        coords_e = mesh.coords[:, :d][b.conn]
        J = np.einsum("qni,enj->eqij", t.dN, coords_e)
        det = np.linalg.det(J)
        vol = np.einsum("eq,q->e", det, t.weights)
        edges = _EDGES.get(b.etype)
        if edges is not None:
            el = np.stack([np.linalg.norm(coords_e[:, a] - coords_e[:, bb],
                                          axis=1) for a, bb in edges], 1)
            aspect = el.max(axis=1) / np.maximum(el.min(axis=1), 1e-300)
        else:
            aspect = np.ones(len(vol))
        deg = int((det.min(axis=1) <= 0).sum())
        per_block.append(dict(etype=b.etype, n=len(vol),
                              volume=float(vol.sum()),
                              min_volume=float(vol.min()),
                              min_jacobian=float(det.min()),
                              max_aspect=float(aspect.max()),
                              degenerate=deg))
        total_v += float(vol.sum())
        min_v = min(min_v, float(vol.min()))
        min_j = min(min_j, float(det.min()))
        max_a = max(max_a, float(aspect.max()))
        ndeg += deg
    return PrecheckReport(total_v, min_v, min_j, max_a, ndeg, per_block)


def nzprof(mesh, workdir: str, rank: int = 0) -> dict:
    """!SOLUTION TYPE=NZPROF: dump the node-graph nonzero profile as
    nonzero.dat.<rank> (i j pairs, both triangles) plus a gnuplot script
    nonzero.plt.<rank> (hecmw_nonzero_profile,
    fistr1/src/common/fstr_precheck.f90:47 + the writer below it)."""
    import os

    n = mesh.n_node
    pairs = set()
    for b in mesh.blocks:
        conn = np.asarray(b.conn)
        nn = conn.shape[1]
        for a in range(nn):
            for c in range(a + 1, nn):
                lo = np.minimum(conn[:, a], conn[:, c])
                hi = np.maximum(conn[:, a], conn[:, c])
                for i, j in zip(lo.tolist(), hi.tolist()):
                    if i != j:
                        pairs.add((i, j))
    fid = f"{rank:03d}"
    dat = os.path.join(workdir, f"nonzero.dat.{fid}")
    with open(dat, "w") as fh:
        for i in range(1, n + 1):
            fh.write(f"{i}  {i}\n")
        for (i, j) in sorted(pairs):
            fh.write(f"{i + 1}  {j + 1}\n")
            fh.write(f"{j + 1}  {i + 1}\n")
    nnz = n + 2 * len(pairs)
    dens = 100.0 * nnz / max(float(n) * n, 1.0)
    rnum = (7.21 + 0.01 * np.log10(max(n, 1))) * 10.0 / max(n, 1)
    plt = os.path.join(workdir, f"nonzero.plt.{fid}")
    with open(plt, "w") as fh:
        fh.write("set terminal png size 1500,1500\n")
        fh.write("unset key\nunset xtics\nunset ytics\n")
        fh.write("set size ratio 1.0\nset border lw 1.0\n")
        fh.write(f"set xrange[0.5:{n}.5]\n")
        fh.write(f"set yrange[0.5:{n}.5] reverse \n")
        fh.write(f'set out "image.{fid}.png"\n')
        fh.write(f'plot "nonzero.dat.{fid}" pointtype 5 pointsize '
                 f"{rnum:12.5f} linecolor rgb \"#F96566\"\n")
    return dict(n=n, nnz=nnz, density_pct=dens, dat=dat, plt=plt)
