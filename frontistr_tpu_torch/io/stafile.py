"""FSTR.sta status file (fistr_main.f90:218-246 opens it; the NLGEOM
driver prints one row per substep via fstr_TimeInc_PrintSTATUS,
fstr_Ctrl_TimeInc.f90:54-117)."""

from __future__ import annotations


def sta_init(path: str):
    with open(path, "w") as f:
        f.write("####" + "FSTR.sta".ljust(80) + "\n")
        f.write("-" * 10 + "-+-" + "-" * 60 + "-+-" + "-" * 40 + "\n")
        f.write("%5s%5s | %5s%5s%7s%7s%12s%12s%12s | %s\n" % (
            "", "", "", " # of", "MAX #", "TOT #", "", "", "", ""))
        f.write("%5s%5s | %5s%5s%7s%7s%12s%12s%12s | %7s%s\n" % (
            "STEP", "SUB", "STAT", " CONT", "NEWTON", "NEWTON",
            "START", "TIME", "END", "MESSAGE", ""))
        f.write("%5s%5s | %5s%5s%7s%7s%12s%12s%12s | %s\n" % (
            "", "STEP", "", "ITER", "ITER", "ITER", "TIME", "INC",
            "TIME", ""))
        f.write("-" * 10 + "-+-" + "-" * 60 + "-+-" + "-" * 40 + "\n")


def sta_status(path: str, step: int, substep: int, n_cont: int,
               max_newton: int, tot_newton: int, t0: float, dt: float,
               cutback: int = 0, message: str = ""):
    state = "S" if cutback == 0 else f"{cutback:4d}F"
    tend = t0 if cutback > 0 else t0 + dt
    with open(path, "a") as f:
        f.write("%5d%5d | %5s%5d%7d%7d%12.4E%12.4E%12.4E | %s\n" % (
            step, substep, state, n_cont, max_newton, tot_newton,
            t0, dt, tend, message))


def sta_final(path: str, success: bool):
    with open(path, "a") as f:
        f.write("-" * 10 + "-+-" + "-" * 60 + "-+-" + "-" * 40 + "\n")
        f.write("FSTR_SOLVE_NLGEOM HAS %sCOMPLETED SUCCESSFULLY\n" %
                ("" if success else "NOT "))
