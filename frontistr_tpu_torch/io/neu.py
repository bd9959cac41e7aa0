"""HECMW-ENTIRE ``.msh`` writer (``write_fstr_msh`` copied from
``frontistr_tpu/io/neu.py``; the NEU reader is not part of the port
yet) and ``write_static_workdir``, which writes a runnable STATIC work
directory for a generated mesh."""

from __future__ import annotations

import os

import numpy as np

from frontistr_tpu_torch.io.meshio import Mesh


def write_fstr_msh(mesh: Mesh, path: str) -> None:
    """Minimal HECMW-ENTIRE '.msh' writer (the neu2fstr output side)."""
    with open(path, "w") as f:
        f.write("!HEADER\n converted by frontistr_tpu neu2fstr\n")
        f.write("!NODE\n")
        for i in range(mesh.n_node):
            x, y, z = mesh.coords[i][:3]
            f.write(f" {mesh.node_ids[i]}, {float(x)!r}, "
                    f"{float(y)!r}, {float(z)!r}\n")
        for b in mesh.blocks:
            f.write(f"!ELEMENT, TYPE={b.etype}\n")
            conn = b.conn_hecmw if b.conn_hecmw is not None else b.conn
            for e in range(len(b.elem_ids)):
                ids = ", ".join(str(mesh.node_ids[g]) for g in conn[e])
                f.write(f" {b.elem_ids[e]}, {ids}\n")
        # element groups per section so !SECTION can bind materials
        for si, sec in enumerate(mesh.sections):
            eids = np.concatenate(
                [b.elem_ids for b in mesh.blocks
                 if b.section_id == si]) if mesh.blocks else []
            f.write(f"!EGROUP, EGRP={sec.egrp}\n")
            for e in eids:
                f.write(f" {int(e)}\n")
        for name, md in mesh.materials.items():
            f.write(f"!MATERIAL, NAME={name}, ITEM={len(md.items)}\n")
            for k in sorted(md.items):
                rows = md.items[k]
                sub = len(rows[0]) if rows else 1
                f.write(f"!ITEM={k}, SUBITEM={sub}\n")
                for row in rows:
                    f.write(" " + ", ".join(repr(float(v))
                                            for v in row) + "\n")
        for sec in mesh.sections:
            f.write(f"!SECTION, TYPE={sec.stype}, EGRP={sec.egrp}, "
                    f"MATERIAL={sec.material}\n")
            if sec.values:
                f.write(" " + ", ".join(repr(float(v))
                                        for v in sec.values) + "\n")
        if mesh.equations:
            f.write("!EQUATION\n")
            for eq in mesh.equations:
                f.write(f" {len(eq.nodes)}, {float(eq.const)!r}\n ")
                f.write(", ".join(
                    f"{int(mesh.node_ids[nd])}, {int(df)}, {float(cf)!r}"
                    for nd, df, cf in zip(eq.nodes, eq.dofs, eq.coefs))
                    + "\n")
        f.write("!END\n")


def write_static_workdir(workdir: str, mesh: Mesh, cnt: str,
                         ngroups=("X0", "X1")) -> None:
    """``workdir/{mesh.msh, case.cnt, hecmw_ctrl.dat}``: the mesh with
    the named node groups as ``!NGROUP`` cards, and the deck ``cnt``."""
    os.makedirs(workdir, exist_ok=True)
    msh = os.path.join(workdir, "mesh.msh")
    write_fstr_msh(mesh, msh)
    end = "!END\n"
    with open(msh, "r+") as f:
        f.seek(0, os.SEEK_END)
        f.seek(f.tell() - len(end))
        f.truncate()
        for g in ngroups:
            ids = mesh.node_ids[np.sort(mesh.node_groups[g])]
            f.write(f"!NGROUP, NGRP={g}\n")
            for k in range(0, len(ids), 10):
                f.write(" " + ", ".join(str(int(v))
                                        for v in ids[k:k + 10]) + "\n")
        f.write(end)
    with open(os.path.join(workdir, "case.cnt"), "w") as f:
        f.write(cnt)
    with open(os.path.join(workdir, "hecmw_ctrl.dat"), "w") as f:
        f.write("!MESH, NAME=fstrMSH, TYPE=HECMW-ENTIRE\n mesh.msh\n"
                "!CONTROL, NAME=fstrCNT\n case.cnt\n"
                "!RESULT, NAME=fstrRES, IO=OUT\n mesh.res\n")
