"""Reference-format restart interchange (hecmw_restart.c blob stream).

The reference's restart file is a raw per-rank record stream: each
record is a native ``size_t`` byte count followed by that many bytes
(HECMW_restart_add / HECMW_restart_read, hecmw_restart.c:69-160).  On
top of it fstr lays the solid-analysis record sequence of
fstr_Restart.f90:110-204 (version >= 5): step counters, times,
Newton statistics, previous-step load ids, unode, QFORCE, then per
(element, gauss point) the istatus/fstatus sizes + strain/stress(+
status) records, then optional contact state.

This module (copied from the JAX package's ``io/hecmw_restart.py``)
reads and writes that exact layout, byte for byte as the JAX package
writes it, so a run checkpointed by the reference binary can resume here
and the other way round.  The ``.npz`` restart (``io/restart.py``)
remains the native format; FRONTISTR_TPU_RESTART_FORMAT=hecmw selects
this one when the Newton driver writes a checkpoint.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

import numpy as np

_SZ = struct.Struct("=Q")      # native size_t (LP64)


class RestartWriter:
    """HECMW_restart_add*: buffer records, then write the stream."""

    def __init__(self):
        self._recs: List[bytes] = []

    def add_int(self, data) -> None:
        a = np.ascontiguousarray(np.asarray(data, dtype=np.int32))
        self._recs.append(a.tobytes())

    def add_real(self, data) -> None:
        a = np.ascontiguousarray(np.asarray(data, dtype=np.float64))
        self._recs.append(a.tobytes())

    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            for r in self._recs:
                f.write(_SZ.pack(len(r)))
                f.write(r)


class RestartReader:
    """HECMW_restart_read: sequential records from the stream."""

    def __init__(self, path: str):
        self._buf = open(path, "rb").read()
        self._pos = 0

    def _record(self) -> bytes:
        if self._pos + _SZ.size > len(self._buf):
            raise EOFError("restart stream exhausted")
        (size,) = _SZ.unpack_from(self._buf, self._pos)
        self._pos += _SZ.size
        rec = self._buf[self._pos:self._pos + size]
        if len(rec) != size:
            raise EOFError("truncated restart record")
        self._pos += size
        return rec

    def read_int(self, n: Optional[int] = None) -> np.ndarray:
        a = np.frombuffer(self._record(), dtype=np.int32)
        if n is not None and a.size != n:
            raise ValueError(f"expected {n} ints, record holds {a.size}")
        return a.copy()

    def read_real(self, n: Optional[int] = None) -> np.ndarray:
        a = np.frombuffer(self._record(), dtype=np.float64)
        if n is not None and a.size != n:
            raise ValueError(f"expected {n} reals, record holds {a.size}")
        return a.copy()

    @property
    def exhausted(self) -> bool:
        return self._pos >= len(self._buf)


def write_fstr_restart(path: str, *, cstep_ext: int, substep: int,
                       step_count: int, ctime: float, dtime: float,
                       steptime: float,
                       unode: np.ndarray, qforce: np.ndarray,
                       gauss: List[dict],
                       nrstat_i=None, nrstat_r=None,
                       autoinc_stat: int = 0,
                       loads_prev=None) -> None:
    """fstr_write_restart (version >= 5) record sequence.

    gauss: one dict per (element, gauss point) in element order with
    keys strain, stress, and optional istatus/fstatus arrays.
    steptime: ctime when the step is finished, else the step's start
    time (times(3) of fstr_Restart.f90:133-138)."""
    w = RestartWriter()
    w.add_int([cstep_ext, substep, step_count])
    w.add_real([ctime, dtime, steptime])
    w.add_int(np.zeros(10, np.int32) if nrstat_i is None else nrstat_i)
    w.add_real(np.zeros(10) if nrstat_r is None else nrstat_r)
    w.add_int([autoinc_stat])
    loads_prev = [] if loads_prev is None else list(loads_prev)
    w.add_int([len(loads_prev)])
    if loads_prev:
        w.add_int(loads_prev)
    w.add_real(unode)
    w.add_real(qforce)
    for g in gauss:
        ist = g.get("istatus")
        fst = g.get("fstatus")
        w.add_int([0 if ist is None else np.asarray(ist).size,
                   0 if fst is None else np.asarray(fst).size])
        w.add_real(g["strain"])
        w.add_real(g["stress"])
        if ist is not None and np.asarray(ist).size:
            w.add_int(ist)
        if fst is not None and np.asarray(fst).size:
            w.add_real(fst)
    w.write(path)


def read_fstr_restart(path: str, n_gauss: Optional[int] = None) -> Dict:
    """fstr_read_restart (version >= 5): returns the state dict."""
    r = RestartReader(path)
    step = r.read_int(3)
    times = r.read_real(3)
    nrstat_i = r.read_int(10)
    nrstat_r = r.read_real(10)
    istat = r.read_int(1)
    nload = int(r.read_int(1)[0])
    loads_prev = r.read_int(nload) if nload > 0 else np.zeros(0, np.int32)
    unode = r.read_real()
    qforce = r.read_real()
    gauss: List[dict] = []
    while not r.exhausted if n_gauss is None else len(gauss) < n_gauss:
        try:
            nif = r.read_int(2)
        except EOFError:
            break
        g = {"strain": r.read_real(), "stress": r.read_real()}
        if nif[0] > 0:
            g["istatus"] = r.read_int(int(nif[0]))
        if nif[1] > 0:
            g["fstatus"] = r.read_real(int(nif[1]))
        gauss.append(g)
    return dict(cstep_ext=int(step[0]), substep=int(step[1]),
                step_count=int(step[2]), ctime=float(times[0]),
                dtime=float(times[1]), steptime=float(times[2]),
                nrstat_i=nrstat_i, nrstat_r=nrstat_r,
                autoinc_stat=int(istat[0]), loads_prev=loads_prev,
                unode=unode, qforce=qforce, gauss=gauss)


def export_solid_state(path: str, u, qforce, states, blocks, *,
                       cstep_ext=1, substep=1, step_count=0,
                       ctime=0.0, dtime=0.0, steptime=0.0) -> None:
    """Write the repo's per-block gauss pytrees as a reference-format
    solid restart: gauss records in block-element order, strain/stress
    straight from the state; plastic history rides as istatus=[yielded]
    and fstatus=[pstrain] (the reference's MechGauss status arrays)."""
    gauss: List[dict] = []
    for st, blk in zip(states, blocks):
        E = len(blk.elem_ids)
        if not st or "strain" not in st:
            # stateless (shell/beam/linear) blocks: zero-strain records
            for _ in range(E):
                gauss.append({"strain": np.zeros(6),
                              "stress": np.zeros(6)})
            continue
        sn = np.asarray(st["strain"])
        ss = np.asarray(st["stress"])
        ps = np.asarray(st["pstrain"]) if "pstrain" in st else None
        yl = np.asarray(st["yielded"]) if "yielded" in st else None
        for e in range(E):
            for q in range(sn.shape[1]):
                g = {"strain": sn[e, q], "stress": ss[e, q]}
                if ps is not None and (ps != 0).any() or \
                        yl is not None and yl.any():
                    g["istatus"] = [int(yl[e, q])] if yl is not None \
                        else [0]
                    g["fstatus"] = [float(ps[e, q])] if ps is not None \
                        else [0.0]
                gauss.append(g)
    write_fstr_restart(path, cstep_ext=cstep_ext, substep=substep,
                       step_count=step_count, ctime=ctime, dtime=dtime,
                       steptime=steptime, unode=np.asarray(u),
                       qforce=np.asarray(qforce), gauss=gauss)


def import_solid_state(path: str, states, blocks):
    """Read a reference-format solid restart back into the repo's state
    pytrees (inverse of export_solid_state).  Returns
    (u, t, step_count, new_states)."""
    d = read_fstr_restart(path)
    gi = 0
    new_states = []
    for st, blk in zip(states, blocks):
        E = len(blk.elem_ids)
        if not st or "strain" not in st:
            gi += E
            new_states.append(st)
            continue
        sn = np.array(np.asarray(st["strain"]))
        ss = np.array(np.asarray(st["stress"]))
        ps = np.array(np.asarray(st["pstrain"])) \
            if "pstrain" in st else None
        yl = np.array(np.asarray(st["yielded"])) \
            if "yielded" in st else None
        nq = sn.shape[1]
        for e in range(E):
            for q in range(nq):
                g = d["gauss"][gi]
                sn[e, q] = g["strain"][:sn.shape[2]]
                ss[e, q] = g["stress"][:ss.shape[2]]
                if "fstatus" in g and ps is not None:
                    ps[e, q] = g["fstatus"][0]
                if "istatus" in g and yl is not None:
                    yl[e, q] = bool(g["istatus"][0])
                gi += 1
        ns = dict(st)
        ns["strain"] = ns["strain_bak"] = np.asarray(sn)
        ns["stress"] = ns["stress_bak"] = np.asarray(ss)
        if ps is not None:
            ns["pstrain"] = ns["pstrain_new"] = np.asarray(ps)
        if yl is not None:
            ns["yielded"] = np.asarray(yl)
        new_states.append(ns)
    return (d["unode"], d["ctime"], d["step_count"], new_states)
