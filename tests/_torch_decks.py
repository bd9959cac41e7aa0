"""Deck helpers shared by the port's parity tests of the plastic,
B-bar/F-bar, tet10, load and dynamics slices: meshes from ``meshgen``
(tet10 raised from ``box_tet4`` by mid-edge nodes; no package has a
tet10 generator), the top element layer and top faces as element and
surface groups, work directories through
``io.neu.write_static_workdir`` (with ``!AMPLITUDE`` tables), and the
DYNAMIC deck ``dyn_deck``.

Importing it also sets PyTorch's intra-op pool to one thread: the
suite runs under pytest-xdist, several workers on the machine's cores,
and PyTorch's default of one thread a core in every worker
oversubscribes them (the port's CPU tests ran about 3x slower so; the
spawned ranks of the sharded tests set one thread too)."""

import numpy as np
import torch

from frontistr_tpu_torch import ordering
from frontistr_tpu_torch.assembly.loads import FACE_TABLES
from frontistr_tpu_torch.elements.tables import HECMW2FSTR_ORDER
from frontistr_tpu_torch.io.meshio import ElemBlock
from frontistr_tpu_torch.io.neu import write_static_workdir
from frontistr_tpu_torch.meshgen import (box_hex8, box_plane, box_tet4,
                                         hex8_pair_541)

torch.set_num_threads(1)

# the six edges of a tet in the FSTR order of 342's mid-edge nodes 4..9
TET10_EDGES = ((0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3))


def tet10_box(nx, ny, nz):
    """``box_tet4(nx, ny, nz)`` raised to 342: one node at the middle of
    every edge, shared by the tets around it."""
    m = box_tet4(nx, ny, nz)
    conn4 = m.blocks[0].conn.astype(np.int64)
    edges = np.stack([np.sort(conn4[:, list(e)], axis=1)
                      for e in TET10_EDGES], 1)           # (E, 6, 2)
    uniq, inv = np.unique(edges.reshape(-1, 2), axis=0, return_inverse=True)
    mid = m.n_node + inv.reshape(-1, 6)
    coords = np.concatenate([m.coords, m.coords[uniq].mean(axis=1)])
    conn = np.concatenate([conn4, mid], axis=1).astype(np.int32)
    # the .msh holds HEC-MW order: fstr[k] = hecmw[TABLE[k] - 1]
    hecmw = np.empty_like(conn)
    hecmw[:, np.asarray(HECMW2FSTR_ORDER[342]) - 1] = conn
    n = len(coords)
    m.coords = coords
    m.node_ids = np.arange(1, n + 1, dtype=np.int64)
    m.id2idx = {int(g): int(g) - 1 for g in m.node_ids}
    for g in ("X0", "X1", "Y0", "Y1", "Z0", "Z1"):
        axis, side = "XYZ".index(g[0]), g[1] == "1"
        x = coords[:, axis]
        m.node_groups[g] = np.flatnonzero(
            np.isclose(x, x.max() if side else x.min())).astype(np.int64)
    m.node_groups["ALL"] = np.arange(n, dtype=np.int64)
    m.blocks = [ElemBlock(342, m.blocks[0].elem_ids, conn, hecmw, 0)]
    return m


# mid-edge nodes of the quadratic solids, FSTR order (post/nodal.py)
QUAD_EDGES = {
    352: ((0, 1), (1, 2), (2, 0), (3, 4), (4, 5), (5, 3), (0, 3), (1, 4),
          (2, 5)),
    362: ((0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
          (0, 4), (1, 5), (2, 6), (3, 7)),
}


def _regroup(m):
    """The box's face node groups X0..Z1 and ALL from its coordinates."""
    c = m.coords
    for g in ("X0", "X1", "Y0", "Y1", "Z0", "Z1"):
        x = c[:, "XYZ".index(g[0])]
        m.node_groups[g] = np.flatnonzero(
            np.isclose(x, x.max() if g[1] == "1" else x.min())
        ).astype(np.int64)
    m.node_groups["ALL"] = np.arange(len(c), dtype=np.int64)
    m.node_ids = np.arange(1, len(c) + 1, dtype=np.int64)
    m.id2idx = {int(g): int(g) - 1 for g in m.node_ids}
    m.structured = None
    return m


def prism6_box(nx, ny, nz, **kw):
    """``box_hex8(nx, ny, nz)`` with every hex split into two 351 prisms
    along its bottom face's 0-2 diagonal."""
    m = box_hex8(nx, ny, nz, **kw)
    h = m.blocks[0].conn
    conn = np.concatenate([h[:, [0, 1, 2, 4, 5, 6]],
                           h[:, [0, 2, 3, 4, 6, 7]]]).astype(np.int32)
    ids = np.arange(1, len(conn) + 1, dtype=np.int64)
    m.blocks = [ElemBlock(351, ids, conn, conn.copy(), 0)]
    m.elem_groups = {"ALL": ids}
    return _regroup(m)


def raise_order(m, etype):
    """The linear solid mesh ``m`` (351 or 361) raised to ``etype`` (352
    or 362): one node at the middle of every edge, shared by the
    elements around it."""
    lin = m.blocks[0].conn.astype(np.int64)
    edges = np.stack([np.sort(lin[:, list(e)], axis=1)
                      for e in QUAD_EDGES[etype]], 1)
    uniq, inv = np.unique(edges.reshape(-1, 2), axis=0, return_inverse=True)
    mid = m.n_node + inv.reshape(len(lin), -1)
    m.coords = np.concatenate([m.coords, m.coords[uniq].mean(axis=1)])
    conn = np.concatenate([lin, mid], axis=1).astype(np.int32)
    hecmw = conn.copy()
    if etype in HECMW2FSTR_ORDER:
        hecmw[:, np.asarray(HECMW2FSTR_ORDER[etype]) - 1] = conn
    b = m.blocks[0]
    m.blocks = [ElemBlock(etype, b.elem_ids, conn, hecmw, 0)]
    return _regroup(m)


def hex20_box(nx, ny, nz, **kw):
    """``box_hex8(nx, ny, nz)`` raised to 362: (n+1)^3 corners and
    3 n (n+1)^2 edge midpoints on a cube of n."""
    return raise_order(box_hex8(nx, ny, nz, **kw), 362)


def prism15_box(nx, ny, nz, **kw):
    return raise_order(prism6_box(nx, ny, nz, **kw), 352)


def solid_box(etype, nx, ny, nz, **kw):
    """A box of one 3-D solid type: 341, 342, 351, 352, 361 or 362."""
    return {341: box_tet4, 342: tet10_box, 351: prism6_box,
            352: prism15_box, 361: box_hex8, 362: hex20_box}[etype](
                nx, ny, nz, **kw)


def top_faces(mesh):
    """(n, 2) rows (element id, face number) of the faces on the box's
    top (z = max) side."""
    b = mesh.blocks[0]
    z = mesh.coords[:, 2]
    top = np.isclose(z, z.max())
    rows = []
    for f, (_, ln) in enumerate(FACE_TABLES[b.etype], start=1):
        ncorner = 3 if b.etype in (341, 342) else 4
        on = top[b.conn[:, ln[:ncorner]]].all(axis=1)
        rows.extend((int(e), f) for e in b.elem_ids[on])
    return np.asarray(rows, np.int64)


def run_both(path, mesh, cnt, ngroups=("X0", "X1"), seed=3):
    """The deck through the port and the JAX package on the CPU, the
    mesh's nodes shuffled; returns (port output, JAX output, port dir,
    JAX dir) of ``run_directory``."""
    import shutil
    import frontistr_tpu.run as jrun
    from frontistr_tpu_torch.run import run_directory
    order = np.random.default_rng(seed).permutation(mesh.n_node)
    wd, wj = str(path / "port"), str(path / "jax")
    write_static_workdir(wd, ordering.permute_mesh(mesh, order), cnt,
                         ngroups=ngroups)
    shutil.copytree(wd, wj)
    oj = jrun.run_directory(wj)
    return run_directory(wd, device="cpu"), oj, wd, wj


def write_deck(path, mesh, cnt, seed=3, amplitudes=None):
    """The deck in ``path`` with the mesh's nodes shuffled (the RCM
    reorder then has work to do); element group TOP (the elements of the
    top faces) and surface group STOP (the top faces); ``amplitudes``
    (name -> rows of time, value) as ``!AMPLITUDE`` cards."""
    rows = top_faces(mesh)
    order = np.random.default_rng(seed).permutation(mesh.n_node)
    write_static_workdir(str(path), ordering.permute_mesh(mesh, order), cnt,
                         ngroups=("X0", "X1", "Z0", "Z1"),
                         egroups={"TOP": np.unique(rows[:, 0])},
                         sgroups={"STOP": rows}, amplitudes=amplitudes)
    return str(path)


DECK = ("!VERSION\n 3\n!SOLUTION, TYPE={sol}\n!BOUNDARY\n X0, 1, 3, 0.0\n"
        "{loads}!MATERIAL, NAME=M1\n!ELASTIC{el}\n 210000.0, 0.3\n"
        "{plastic}{extra}!STEP, SUBSTEPS={sub}{step}\n BOUNDARY, 1\n"
        " LOAD, 1\n!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
        " 1.0e-8, 1.0, 0.0\n{write}!END\n")


MISES_DECK = "!PLASTIC, YIELD=MISES, HARDEN=LINEAR\n 250.0, 1000.0\n"


def deck(sol="NLSTATIC", loads="", el="", plastic="", extra="", sub=1,
         step="", write="!WRITE, RESULT\n"):
    return DECK.format(sol=sol, loads=loads, el=el, plastic=plastic,
                       extra=extra, sub=sub, step=step, write=write)


DYN = ("!VERSION\n 3\n!SOLUTION, TYPE=DYNAMIC\n!DYNAMIC{typ}\n {eqa}, 1\n"
       " 0.0, {t_end!r}, {n_step}, {dt!r}\n {gamma}, {beta}\n"
       " 1, 1, {ray_m!r}, {ray_k!r}\n 10, {monit}, {every}\n"
       "!BOUNDARY\n X0, 1, 3, 0.0\n{loads}!STEP, SUBSTEPS=1, CONVERG={conv}\n"
       "!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n{plastic}!DENSITY\n"
       " 7.85e-9\n!SOLVER, METHOD=CG, PRECOND=1, ITERLOG=NO, TIMELOG=NO\n"
       " 10000, 1\n {resid}, 1.0, 0.0\n{write}!END\n")


def dyn_deck(eqa=11, n_step=20, dt=4e-9, loads="", typ="", gamma=0.5,
             beta=0.25, ray_m=0.0, ray_k=0.0, monit=0, every=1,
             conv="1.0e-6", plastic="", resid="1.0e-10", write=""):
    """A DYNAMIC deck: X0 fixed, steel in N, mm, s (E 210000, nu 0.3,
    rho 7.85e-9); ``eqa`` 11 explicit, 1 implicit Newmark; ``typ``
    ", TYPE=NONLINEAR" for finite strain; ``monit`` the monitor node's
    global id (0: none) every ``every`` steps."""
    return DYN.format(eqa=eqa, t_end=n_step * dt, n_step=n_step, dt=dt,
                      typ=typ, gamma=gamma, beta=beta, ray_m=ray_m,
                      ray_k=ray_k, monit=monit, every=every, loads=loads,
                      conv=conv, plastic=plastic, resid=resid, write=write)


# ---- heat decks -------------------------------------------------------
HEAT_ITEMS = {1: [[7.8e-6]], 2: [[460.0, 0.0], [520.0, 400.0]],
              3: [[50.0, 0.0], [42.0, 150.0], [30.0, 400.0]]}


def _face_corners(ftype):
    return {111: 2, 112: 2, 231: 3, 232: 3, 241: 4, 242: 4}[ftype]


def side_faces(mesh, axis, high=True, block=0):
    """(n, 2) rows (element id, face number) of the faces of block
    ``block`` on the box side where coordinate ``axis`` is largest
    (``high``) or smallest."""
    b = mesh.blocks[block]
    x = mesh.coords[:, axis]
    on_side = np.isclose(x, x.max() if high else x.min())
    rows = []
    for f, (ft, ln) in enumerate(FACE_TABLES[b.etype], start=1):
        on = on_side[b.conn[:, ln[:_face_corners(ft)]]].all(axis=1)
        rows.extend((int(e), f) for e in b.elem_ids[on])
    return np.asarray(rows, np.int64)


def heat_mesh(kind, seed=5):
    """The heat decks' meshes: "hex8" ``box_hex8(4, 3, 2)`` 4 x 1 x 0.7,
    "tet4" ``box_tet4(3, 2, 2)``, "tet10" ``tet10_box(2, 2, 1)``, "quad"
    and "tri" ``box_plane(4, 3)`` 2 x 1, "iface" ``hex8_pair_541(2)``,
    an element type number (351, 352, 362) ``solid_box(kind, 3, 2, 2)``
    3 x 1 x 0.7;
    the heat material (T-dependent specific heat and conductivity),
    !ZERO -273.15 and an initial temperature of 20 on every node.  Nodes
    off the box's sides move by up to 2.5% of its shortest side, drawn
    from ``seed``, so no two nodes share a temperature by symmetry."""
    if kind == "hex8":
        m = box_hex8(4, 3, 2, lx=4.0, ly=1.0, lz=0.7)
    elif kind == "tet4":
        m = box_tet4(3, 2, 2)
    elif kind == "tet10":
        m = tet10_box(2, 2, 1)
    elif isinstance(kind, int):
        m = solid_box(kind, 3, 2, 2, lx=3.0, ly=1.0, lz=0.7)
    elif kind in ("quad", "tri"):
        m = box_plane(4, 3, lx=2.0, etype=231 if kind == "tri" else 241)
    else:
        m = hex8_pair_541(2)
    m.materials["M1"].items = {k: [list(r) for r in v]
                               for k, v in HEAT_ITEMS.items()}
    m.zero_temp = -273.15
    m.initial_conditions = {"TEMPERATURE": np.stack(
        [np.arange(m.n_node), np.full(m.n_node, 20.0)], 1)}
    c = m.coords
    side = np.zeros(m.n_node, bool)
    for ax in range(3):
        if not np.ptp(c[:, ax]):
            continue
        side |= np.isclose(c[:, ax], c[:, ax].min()) | \
            np.isclose(c[:, ax], c[:, ax].max())
    if kind == "iface":
        side |= np.isclose(c[:, 0], 1.0) | np.isclose(c[:, 0], 2.0)
    h = np.min([np.ptp(c[:, ax]) for ax in range(3) if np.ptp(c[:, ax])])
    jit = np.random.default_rng(seed).uniform(-0.1, 0.1, c.shape) * h / 4
    jit[side] = 0.0
    jit[:, np.ptp(c, axis=0) == 0] = 0.0
    m.coords = c + jit
    return m


HEAT = ("!SOLUTION, TYPE=HEAT\n!HEAT\n {heat}\n!FIXTEMP\n X0, 100.0\n"
        "{loads}!SOLVER, METHOD=CG\n 2000, 1\n {resid}, 1.0, 0.0\n"
        "{write}!END\n")
HEAT_LOADS = ("!CFLUX\n {node}, 2.0\n!DFLUX\n {egrp}, BF, 0.5\n"
              "!SFLUX\n SHI, 0.3\n!SFILM\n SHI, 0.02, 20.0\n"
              "!SRADIATE\n SHI, 5.67e-11, 300.0\n")
WELD = "!WELD_LINE\n 120.0, 10.0, 0.5, 1.0\n {egrp}, 1, 0.0, {lx}, 0.7, 0.0\n"


def heat_deck(mesh, transient=True, weld=False, resid="1.0e-12",
              write=""):
    """A HEAT deck for ``heat_mesh``: X0 at 100; a CFLUX on the last
    node, a body flux, and a flux, a film and radiation on the surface
    group SHI (the faces of the box's high-y side; ``write_heat_deck``
    writes it); transient: 3 steps of 1e-4 s (alpha dt about 1.4 mm^2, a
    few elements' squares); ``weld`` a weld line along x over the
    box."""
    egrp = "SOLID" if "SOLID" in mesh.elem_groups else "ALL"
    loads = HEAT_LOADS.format(node=int(mesh.node_ids[-1]), egrp=egrp)
    if weld:
        loads += WELD.format(egrp=egrp, lx=float(np.ptp(mesh.coords[:, 0])))
    return HEAT.format(heat="1.0e-4, 3.0e-4, 0.0, 0.0, 20, 1.0e-6"
                       if transient
                       else "0.0, 0.0, 0.0, 0.0, 20, 1.0e-6",
                       loads=loads, resid=resid, write=write)


def shi_faces(mesh):
    """The surface group SHI of the heat decks: the faces on the high-y
    side of the first block (of the right cube of the 541 pair)."""
    return side_faces(mesh, 1, block=1 if mesh.blocks[-1].etype == 541
                      else 0)


def write_heat_deck(path, mesh, cnt, seed=3):
    """The heat deck in ``path`` with the mesh's nodes shuffled; surface
    group SHI (``shi_faces``) and the element groups of ``mesh``."""
    rows = shi_faces(mesh)
    order = np.random.default_rng(seed).permutation(mesh.n_node)
    groups = {g: v for g, v in mesh.elem_groups.items()
              if g not in {s.egrp for s in mesh.sections}}
    write_static_workdir(str(path), ordering.permute_mesh(mesh, order), cnt,
                         ngroups=tuple(g for g in ("X0", "X1")
                                       if g in mesh.node_groups),
                         egroups=groups, sgroups={"SHI": rows})
    return str(path)


# ---- the 2-D solids ----------------------------------------------------
def write_plane_deck(path, mesh, cnt, seed=3):
    """A plane deck in ``path``, the mesh's nodes shuffled; node groups
    X0, X1, Y0, Y1 and the surface group EX1 (the element edges on the
    box's x = max side)."""
    order = np.random.default_rng(seed).permutation(mesh.n_node)
    write_static_workdir(str(path), ordering.permute_mesh(mesh, order), cnt,
                         ngroups=("X0", "X1", "Y0", "Y1"),
                         sgroups={"EX1": side_faces(mesh, 0)})
    return str(path)


def run_both_plane(path, mesh, cnt, seed=3):
    """``run_both`` for a plane deck written by ``write_plane_deck``."""
    import shutil
    import frontistr_tpu.run as jrun
    from frontistr_tpu_torch.run import run_directory
    wd, wj = str(path / "port"), str(path / "jax")
    write_plane_deck(wd, mesh, cnt, seed)
    shutil.copytree(wd, wj)
    oj = jrun.run_directory(wj)
    return run_directory(wd, device="cpu"), oj, wd, wj
