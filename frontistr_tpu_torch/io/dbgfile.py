"""FSTR.dbg debug log (fistr_main.f90:193 'FSTR.dbg.<rank>' / the IDBG
unit): stage breadcrumbs the reference scatters through setup and the
rcap/solver paths.  Single-process rank is always 0."""

from __future__ import annotations

import atexit
import datetime
import os

_FH = None


def dbg_open(workdir: str, rank: int = 0):
    global _FH
    dbg_close()
    _FH = open(os.path.join(workdir, f"FSTR.dbg.{rank}"), "w")
    dbg("FSTR debug log opened")
    atexit.register(dbg_close)


def dbg(msg: str):
    if _FH is None:
        return
    ts = datetime.datetime.now().strftime("%H:%M:%S")
    _FH.write(f" {ts} {msg}\n")
    _FH.flush()


def dbg_close():
    global _FH
    if _FH is not None:
        try:
            _FH.close()
        except Exception:
            pass
        _FH = None
