"""Matrix dump facility (!SOLVER DUMPTYPE=MM|CSR|BSR), copied from
``frontistr_tpu/solver/dump.py`` (host numpy).

The counterpart of hecmw1/src/solver/matrix/hecmw_matrix_dump.f90: writes the
assembled operator for offline analysis.  The source here is the scalar
block-ELL blocks (N, W, nd, nd) + cols — the padded slots (col == row
off-diagonal duplicates with zero blocks) are skipped, so the MM file
carries exactly the true sparsity.  File name
'dump_matrix_<ncall>_<rank>.mm' matches make_file_name
(hecmw_matrix_dump.f90:53-59).
"""

from __future__ import annotations

import numpy as np

_NUM_CALL = [0]


def dump_operator(blocks, cols, ndof: int, dumptype: str = "MM",
                  rank: int = 0, out_dir: str = ".") -> str:
    """Write the assembled block operator; returns the file path."""
    import os
    dumptype = (dumptype or "NONE").upper()
    if dumptype in ("NONE", "0", ""):
        return ""
    _NUM_CALL[0] += 1
    b = np.asarray(blocks.cpu() if hasattr(blocks, "cpu") else blocks)
    c = np.asarray(cols)
    N, W = c.shape
    # true entries: first occurrence of each (row, col) pair (ELL pads
    # row tails with the row index + zero blocks)
    rows = np.repeat(np.arange(N), W)
    colsv = c.reshape(-1)
    key = rows * np.int64(N) + colsv
    _, first = np.unique(key, return_index=True)
    sel = np.zeros(N * W, bool)
    sel[first] = True
    rr, cc = rows[sel], colsv[sel]
    bb = b.reshape(N * W, ndof, ndof)[sel]
    nnz = len(rr) * ndof * ndof
    if dumptype == "MM":
        path = os.path.join(out_dir,
                            f"dump_matrix_{_NUM_CALL[0]}_{rank}.mm")
        with open(path, "w") as f:
            f.write("%%MatrixMarket matrix coordinate real general\n")
            f.write(f"{N * ndof} {N * ndof} {nnz}\n")
            order = np.argsort(rr * np.int64(N) + cc, kind="stable")
            for k in order:
                i0, j0 = int(rr[k]) * ndof, int(cc[k]) * ndof
                for i in range(ndof):
                    for j in range(ndof):
                        f.write(f"{i0 + i + 1} {j0 + j + 1} "
                                f"{bb[k, i, j]:20.12e}\n")
        return path
    if dumptype in ("CSR", "BSR"):
        path = os.path.join(
            out_dir, f"dump_matrix_{_NUM_CALL[0]}_{rank}."
            + dumptype.lower())
        order = np.argsort(rr * np.int64(N) + cc, kind="stable")
        rr2, cc2, bb2 = rr[order], cc[order], bb[order]
        indptr = np.searchsorted(rr2, np.arange(N + 1))
        with open(path, "w") as f:
            f.write(f"{N} {ndof} {len(rr2)}\n")
            f.write(" ".join(str(v) for v in indptr) + "\n")
            f.write(" ".join(str(v + 1) for v in cc2) + "\n")
            for blk in bb2:
                f.write(" ".join(f"{v:20.12e}" for v in blk.reshape(-1))
                        + "\n")
        return path
    raise ValueError(f"unknown DUMPTYPE {dumptype!r}")
