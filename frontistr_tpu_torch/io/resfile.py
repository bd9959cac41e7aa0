"""FrontISTR-compatible result file (``.res``) writer.

Text layout replicates hecmw1/src/common/res_txt_io.inc:12-177:
  line 1: header ('*fstrresult')
  line 2: 'n_node n_elem'
  line 3: 'nn_comp ne_comp'
  per-comp dof counts (10 per line), labels (one per line),
  then per node: global ID line + values (%.16E, 5 per line);
  same for elements.
Filename convention '<name>.<rank>.<step>' (hecmw_result.c:492-509).
Labels follow fstr_write_static_result
(fistr1/src/analysis/static/static_make_result.f90:65-120, 320-360).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

COL_INT = 10
COL_DOUBLE = 5


def _write_wrapped_ints(f, vals: Sequence[int]):
    n = 0
    for v in vals:
        f.write(f"{v}")
        n += 1
        f.write("\n" if n % COL_INT == 0 else " ")
    if n % COL_INT:
        f.write("\n")


ROWS_A_WRITE = 8192        # rows formatted by one % of a row template


def _write_rows(f, ids, comps, id_fmt: str):
    """Each item's id line (``id_fmt``), then its components' values,
    ``%.16E`` each, COL_DOUBLE a line, a space after every value that
    does not end a line and a newline after the last (the JAX writer's
    bytes); a chunk of rows at a time through one row template."""
    vals = np.concatenate([np.asarray(a, np.float64).reshape(len(ids), -1)
                           for _, a in comps], axis=1)
    k = vals.shape[1]
    row = id_fmt + "".join(
        "%.16E" + ("\n" if (j + 1) % COL_DOUBLE == 0 else " ")
        for j in range(k)) + ("\n" if k % COL_DOUBLE else "")
    ids = np.asarray(ids).astype(np.int64)
    for r0 in range(0, len(ids), ROWS_A_WRITE):
        flat = []
        for i, v in zip(ids[r0:r0 + ROWS_A_WRITE].tolist(),
                        vals[r0:r0 + ROWS_A_WRITE].tolist()):
            flat.append(i)
            flat.extend(v)
        f.write((row * (len(flat) // (k + 1))) % tuple(flat))


def write_result(path: str, header: str,
                 node_ids: np.ndarray,
                 elem_ids: np.ndarray,
                 node_comps: List[Tuple[str, np.ndarray]],
                 elem_comps: List[Tuple[str, np.ndarray]]):
    """Write a HEC-MW text result file.

    node_comps/elem_comps: list of (label, (n, dof) array).
    """
    n_node = len(node_ids)
    n_elem = len(elem_ids)
    with open(path, "w") as f:
        f.write(header + "\n")
        f.write(f"{n_node} {n_elem}\n")
        f.write(f"{len(node_comps)} {len(elem_comps)}\n")
        if node_comps:
            _write_wrapped_ints(f, [a.shape[1] for _, a in node_comps])
            for label, _ in node_comps:
                f.write(label + "\n")
            _write_rows(f, node_ids, node_comps, "%d \n")
        if elem_comps:
            _write_wrapped_ints(f, [a.shape[1] for _, a in elem_comps])
            for label, _ in elem_comps:
                f.write(label + "\n")
            _write_rows(f, elem_ids, elem_comps, "%d\n")


def write_static_result(path: str, mesh, model, res, step: int = 1,
                        binary: bool = False, node_sel=None,
                        elem_sel=None):
    """Default static result set (DISPLACEMENT + nodal/elemental
    strain/stress/mises, static_make_result.f90 default outinfo).
    binary=True emits the reference HECMW_BINARY_RESULT format
    (!RESULT ... TYPE=BINARY, hecmw_control.c:1267-1271).
    node_sel/elem_sel restrict the rows to one partition rank's owned
    nodes/elements (per-rank '<name>.<rank>.<step>' files that
    fstr_rmerge reassembles)."""
    node_comps = [
        ("DISPLACEMENT", np.asarray(res.u)),
        ("NodalSTRAIN", res.nodal_strain),
        ("NodalSTRESS", res.nodal_stress),
        ("NodalMISES", res.nodal_mises[:, None]),
    ]
    if getattr(res, "reaction", None) is not None:
        node_comps.insert(1, ("REACTION_FORCE",
                              np.asarray(res.reaction)))
    elem_comps = [
        ("ElementalSTRAIN", res.elem_strain),
        ("ElementalSTRESS", res.elem_stress),
        ("ElementalMISES", res.elem_mises[:, None]),
    ]
    node_ids, elem_ids = mesh.node_ids, res.elem_ids
    if node_sel is not None:
        node_ids = node_ids[node_sel]
        node_comps = [(n, np.asarray(a)[node_sel])
                      for n, a in node_comps]
    if elem_sel is not None:
        elem_ids = np.asarray(elem_ids)[elem_sel]
        elem_comps = [(n, np.asarray(a)[elem_sel])
                      for n, a in elem_comps]
    w = write_result_bin if binary else write_result
    w(path, "*fstrresult", node_ids, elem_ids,
      node_comps, elem_comps)


def read_result(path: str):
    """Read a text result file back (rmerge/rconv-style tooling support)."""
    with open(path) as f:
        toks_lines = f.readlines()
    header = toks_lines[0].strip()
    n_node, n_elem = (int(v) for v in toks_lines[1].split())
    nn_comp, ne_comp = (int(v) for v in toks_lines[2].split())
    pos = 3

    def read_ints(count):
        nonlocal pos
        out = []
        while len(out) < count:
            out.extend(int(v) for v in toks_lines[pos].split())
            pos += 1
        return out

    def read_section(n_items, n_comp):
        nonlocal pos
        dofs = read_ints(n_comp)
        labels = []
        for _ in range(n_comp):
            labels.append(toks_lines[pos].strip())
            pos += 1
        total = sum(dofs)
        ids = np.zeros(n_items, np.int64)
        vals = np.zeros((n_items, total))
        for i in range(n_items):
            ids[i] = int(toks_lines[pos].split()[0])
            pos += 1
            row = []
            while len(row) < total:
                row.extend(float(v) for v in toks_lines[pos].split())
                pos += 1
            vals[i] = row
        comps = []
        off = 0
        for lab, d in zip(labels, dofs):
            comps.append((lab, vals[:, off:off + d]))
            off += d
        return ids, comps

    node_ids, node_comps = (np.zeros(0, np.int64), [])
    elem_ids, elem_comps = (np.zeros(0, np.int64), [])
    if nn_comp:
        node_ids, node_comps = read_section(n_node, nn_comp)
    if ne_comp:
        elem_ids, elem_comps = read_section(n_elem, ne_comp)
    return dict(header=header, node_ids=node_ids, node_comps=node_comps,
                elem_ids=elem_ids, elem_comps=elem_comps)


# ---------------------------------------------------------------------------
# Reference BINARY result format (hecmw1/src/common/hecmw_bin_io.c +
# res_bin_io.inc): magic "HECMW_BINARY_RESULT" + "%2d" % sizeof(long),
# ints as 8-byte native-endian longs, doubles raw 8 bytes, strings as
# bytes + NUL.  Record order identical to the text layout (header,
# n_node/n_elem, nn_comp/ne_comp, per-comp dofs, labels, then per item:
# global ID + concatenated component values).
# ---------------------------------------------------------------------------

import struct

_BIN_MAGIC = b"HECMW_BINARY_RESULT"


def _wbin_int(f, v: int):
    f.write(struct.pack("<q", int(v)))


def _wbin_dbl(f, v: float):
    f.write(struct.pack("<d", float(v)))


def _wbin_str(f, s: str):
    f.write(s.encode() + b"\0")


def write_result_bin(path: str, header: str,
                     node_ids: np.ndarray, elem_ids: np.ndarray,
                     node_comps: List[Tuple[str, np.ndarray]],
                     elem_comps: List[Tuple[str, np.ndarray]]):
    """Binary twin of write_result (HECMW_result_write_bin_by_fname)."""
    n_node, n_elem = len(node_ids), len(elem_ids)
    with open(path, "wb") as f:
        f.write(_BIN_MAGIC)
        f.write(b" 8")                       # "%2d" % sizeof(long)
        _wbin_str(f, header)
        _wbin_int(f, n_node)
        _wbin_int(f, n_elem)
        _wbin_int(f, len(node_comps))
        _wbin_int(f, len(elem_comps))
        for _, a in node_comps:
            _wbin_int(f, a.shape[1])
        for lab, _ in node_comps:
            _wbin_str(f, lab)
        if node_comps:
            for i in range(n_node):
                _wbin_int(f, node_ids[i])
                for _, a in node_comps:
                    for v in a[i]:
                        _wbin_dbl(f, v)
        for _, a in elem_comps:
            _wbin_int(f, a.shape[1])
        for lab, _ in elem_comps:
            _wbin_str(f, lab)
        if elem_comps:
            for i in range(n_elem):
                _wbin_int(f, elem_ids[i])
                for _, a in elem_comps:
                    for v in a[i]:
                        _wbin_dbl(f, v)


def is_binary_result(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(len(_BIN_MAGIC)) == _BIN_MAGIC


def read_result_bin(path: str):
    """Binary twin of read_result."""
    with open(path, "rb") as f:
        buf = f.read()
    assert buf[:len(_BIN_MAGIC)] == _BIN_MAGIC, "not a HECMW binary result"
    nbyte = int(buf[len(_BIN_MAGIC):len(_BIN_MAGIC) + 2])
    pos = len(_BIN_MAGIC) + 2
    ifmt = {8: "<q", 4: "<i"}[nbyte]

    def rstr():
        nonlocal pos
        end = buf.index(b"\0", pos)
        s = buf[pos:end].decode()
        pos = end + 1
        return s

    def rint():
        nonlocal pos
        v = struct.unpack_from(ifmt, buf, pos)[0]
        pos += nbyte
        return v

    def rdbl():
        nonlocal pos
        v = struct.unpack_from("<d", buf, pos)[0]
        pos += 8
        return v

    header = rstr()
    n_node, n_elem = rint(), rint()
    nn_comp, ne_comp = rint(), rint()

    def section(n_items, n_comp):
        dofs = [rint() for _ in range(n_comp)]
        labels = [rstr() for _ in range(n_comp)]
        total = sum(dofs)
        ids = np.zeros(n_items, np.int64)
        vals = np.zeros((n_items, total))
        for i in range(n_items):
            ids[i] = rint()
            for k in range(total):
                vals[i, k] = rdbl()
        comps, off = [], 0
        for lab, d in zip(labels, dofs):
            comps.append((lab, vals[:, off:off + d]))
            off += d
        return ids, comps

    node_ids, node_comps = (np.zeros(0, np.int64), [])
    elem_ids, elem_comps = (np.zeros(0, np.int64), [])
    if nn_comp:
        node_ids, node_comps = section(n_node, nn_comp)
    if ne_comp:
        elem_ids, elem_comps = section(n_elem, ne_comp)
    return dict(header=header, node_ids=node_ids, node_comps=node_comps,
                elem_ids=elem_ids, elem_comps=elem_comps)


def read_result_any(path: str):
    """Auto-detect text vs binary (judge_result_bin_file semantics)."""
    return read_result_bin(path) if is_binary_result(path) \
        else read_result(path)
