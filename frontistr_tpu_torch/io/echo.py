"""!ECHO — dump the consumed mesh + deck into the analysis log.

Design references: fistr1/src/analysis/static/static_echo.f90:24-101
(nodes / elements / ngroup / egroup / reftemp blocks) and
fistr1/src/analysis/heat/heat_echo.f90:27-300 (global parameters +
material/BC summaries).  The reference prints through ILOG (the
per-rank <rank>.log); here the block is prepended to 0.log.  Copied
from the JAX package's ``io/echo.py`` (host only).
"""

from __future__ import annotations

from typing import List


def echo_text(mesh, cfg) -> str:
    """Render the echo block for a parsed mesh + control deck."""
    out: List[str] = []
    w = out.append
    w(" global parameters  ***********")
    w(f"  IECHO    1")
    w(f"  IRESULT  {1 if cfg.write_result else 0}")
    w(f"  IVISUAL  {1 if cfg.write_visual else 0}")
    w(f"  SOLUTION {cfg.solution_type}")
    w("")

    w(f" ### Number of nodes {mesh.n_node}")
    w(" ID X Y Z")
    for i in range(mesh.n_node):
        x, y, z = (float(v) for v in mesh.coords[i][:3])
        w(f"{int(mesh.node_ids[i]):8d}{x:15.5E}{y:15.5E}{z:15.5E}")
    w("")

    w(f" ### Elements {mesh.n_elem}")
    for b in mesh.blocks:
        conn = b.conn_hecmw if b.conn_hecmw is not None else b.conn
        for e in range(len(b.elem_ids)):
            w(f" ### Element ID= {b.etype} {int(b.elem_ids[e])}")
            w("  " + " ".join(str(int(mesh.node_ids[g]))
                              for g in conn[e]))
    w("")

    w(" ### Ngroup")
    for name, nodes in mesh.node_groups.items():
        w("")
        w(f" {name}")
        w("  " + " ".join(str(int(mesh.node_ids[i])) for i in nodes))
    w("")

    w(" ### Egroup")
    for name, eids in mesh.elem_groups.items():
        w("")
        w(f" {name}")
        w("  " + " ".join(str(int(e)) for e in eids))
    w("")
    w(f" ### Reftemp {cfg.reftemp}")

    # deck summaries (heat_echo.f90 material/BC blocks)
    w("")
    w(" ### Materials")
    for name, md in cfg.materials.items():
        props = [k for k in ("elastic", "plastic", "hyperelastic",
                             "viscoelastic", "creep", "density",
                             "specific_heat", "conductivity")
                 if getattr(md, k, None) is not None]
        w(f"  {name}: " + ", ".join(props))
    if cfg.boundaries:
        w(" ### Boundary cards " + str(len(cfg.boundaries)))
    if cfg.cloads:
        w(" ### Cload cards " + str(len(cfg.cloads)))
    if cfg.dloads:
        w(" ### Dload cards " + str(len(cfg.dloads)))
    if cfg.fixtemps:
        w(" ### Fixtemp cards " + str(len(cfg.fixtemps)))
    if cfg.cfluxes or cfg.dfluxes:
        w(" ### Flux cards "
          + str(len(cfg.cfluxes) + len(cfg.dfluxes)))
    if cfg.films or cfg.radiates:
        w(" ### Film/Radiate cards "
          + str(len(cfg.films) + len(cfg.radiates)))
    w("")
    return "\n".join(out) + "\n"


def prepend_echo(log_path: str, mesh, cfg) -> None:
    """Prepend the echo block to an existing analysis log (the drivers
    truncate-write their summaries first; the reference's echo sits at
    the top of ILOG)."""
    import os
    existing = ""
    if os.path.exists(log_path):
        with open(log_path) as fh:
            existing = fh.read()
    with open(log_path, "w") as fh:
        fh.write(echo_text(mesh, cfg))
        fh.write(existing)
