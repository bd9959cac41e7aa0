"""Deck helpers of the port's parity tests of the mesh readers, refinement,
HECMW-DIST work directories and pictures: a field-by-field comparison of
two ``Mesh`` objects (one from each package), an ABAQUS ``.inp`` writer,
work directories whose ``hecmw_ctrl.dat`` names a ``!MESH, TYPE=`` and
``REFINE=``, a run of one work directory through both packages, and the
pixel bar of the picture tests (over the port's ``psf.bmp_diff``)."""

import dataclasses
import os
import shutil

import numpy as np

from frontistr_tpu_torch import ordering
from frontistr_tpu_torch.vis import psf

# a linear STATIC deck: X0 fixed, X1 loaded -1 in z per node
CNT = ("!VERSION\n 3\n!SOLUTION, TYPE={sol}\n!BOUNDARY\n X0, 1, 3, 0.0\n"
       "!CLOAD\n X1, 3, -1.0\n!MATERIAL, NAME=M1\n!ELASTIC\n 210000.0, 0.3\n"
       "!SOLVER, METHOD=CG, ITERLOG=NO, TIMELOG=NO\n 10000, 1\n"
       " 1.0e-10, 1.0, 0.0\n{extra}!END\n")
# the !VISUAL card of the picture decks (96 x 96, the bar of the CPU tests)
VISUAL = ("!WRITE, VISUAL{freq}\n!VISUAL, METHOD={method}\n"
          "!x_resolution = 96\n!y_resolution = 96\n{more}")
# the picture bar: at most this share of the pixels more than one level
# apart (test_torch_visual.py::test_psr_ties_flip_within_the_reference
# shows the JAX package breaking PSR ties the other way under a 1e-14
# change of u on this order)
FAR_SHARE = 1e-3
# ABAQUS element names of the meshgen types
ABAQUS_NAME = {341: "C3D4", 342: "C3D10", 361: "C3D8"}


def assert_same(a, b, where="mesh"):
    """``a`` (the port's) equals ``b`` (the JAX package's) field by field:
    dataclasses by their field names, dicts by key, arrays element by
    element (coordinates bit-equal), numbers exactly."""
    if dataclasses.is_dataclass(a):
        fa = [f.name for f in dataclasses.fields(a)]
        assert fa == [f.name for f in dataclasses.fields(b)], where
        for k in fa:
            assert_same(getattr(a, k), getattr(b, k), f"{where}.{k}")
    elif isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for k, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{k}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape, where
        assert np.array_equal(x, y), where
    else:
        assert a == b, where


def write_abaqus(path, mesh, name):
    """``mesh`` (one solid block) as an ABAQUS ``.inp``: *NODE, *ELEMENT
    of type ``name`` (the rows in HEC-MW node order, which ABAQUS shares
    for these types), *NSET X0 and X1, *SOLID SECTION, *MATERIAL with
    *ELASTIC 210000, 0.3."""
    b = mesh.blocks[0]
    conn = b.conn_hecmw if b.conn_hecmw is not None else b.conn
    ids = np.asarray(mesh.node_ids)
    with open(path, "w") as f:
        f.write("*HEADING\n generated box\n*NODE\n")
        for g, (x, y, z) in zip(ids, mesh.coords):
            f.write(f"{int(g)}, {float(x)!r}, {float(y)!r}, "
                    f"{float(z)!r}\n")
        f.write(f"*ELEMENT, TYPE={name}, ELSET=EALL\n")
        for e, row in zip(b.elem_ids, ids[np.asarray(conn, np.int64)]):
            f.write(f"{int(e)}, " + ", ".join(str(int(v)) for v in row)
                    + "\n")
        for g in ("X0", "X1"):
            f.write(f"*NSET, NSET={g}\n")
            sel = ids[np.sort(mesh.node_groups[g])]
            for k in range(0, len(sel), 16):
                f.write(", ".join(str(int(v)) for v in sel[k:k + 16])
                        + "\n")
        f.write("*SOLID SECTION, ELSET=EALL, MATERIAL=M1\n"
                "*MATERIAL, NAME=M1\n*ELASTIC\n 210000., 0.3\n")


def write_ctrl(wd, mesh_file, mtype=None, refine=0, result=False):
    """``wd/hecmw_ctrl.dat`` naming ``mesh_file`` as ``!MESH`` (of
    ``TYPE=mtype``, refined ``refine`` times), ``case.cnt`` and (with
    ``result``) ``!RESULT`` ``result``."""
    head = "!MESH, NAME=fstrMSH" + (f", TYPE={mtype}" if mtype else "") + \
        (f", REFINE={refine}" if refine else "")
    with open(os.path.join(wd, "hecmw_ctrl.dat"), "w") as f:
        f.write(f"{head}\n {mesh_file}\n!CONTROL, NAME=fstrCNT\n case.cnt\n")
        if result:
            f.write("!RESULT, NAME=fstrRES, IO=OUT\n result\n")


def abaqus_workdir(wd, mesh, cnt, refine=0):
    """A work directory of ``mesh`` as an ABAQUS ``mesh.inp`` (nodes in
    a shuffled order, element rows reversed), the deck ``cnt``, the
    mesh refined ``refine`` times on load."""
    os.makedirs(wd, exist_ok=True)
    order = np.random.default_rng(3).permutation(mesh.n_node)
    m = ordering.permute_mesh(mesh, order)
    b = m.blocks[0]
    m.blocks = [dataclasses.replace(
        b, elem_ids=b.elem_ids[::-1].copy(), conn=b.conn[::-1].copy(),
        conn_hecmw=None if b.conn_hecmw is None else b.conn_hecmw[::-1])]
    write_abaqus(os.path.join(wd, "mesh.inp"), m, ABAQUS_NAME[b.etype])
    with open(os.path.join(wd, "case.cnt"), "w") as f:
        f.write(cnt)
    write_ctrl(wd, "mesh.inp", "ABAQUS", refine)
    return str(wd)


def visual_deck(tmp_path, method, sol="STATIC", more="", mesh=None,
                cnt=None):
    """A work directory ``tmp_path/wd`` of ``mesh`` (``box_hex8(4, 3, 2)``)
    with its nodes shuffled, the deck ``cnt`` (``CNT`` of ``sol``) with
    ``!WRITE, VISUAL`` and ``!VISUAL, METHOD=method`` (96 x 96) and the
    cards ``more``."""
    from frontistr_tpu_torch.io.neu import write_static_workdir
    from frontistr_tpu_torch.meshgen import box_hex8
    mesh = box_hex8(4, 3, 2) if mesh is None else mesh
    extra = VISUAL.format(freq="", method=method, more=more)
    cnt = CNT.format(sol=sol, extra=extra) if cnt is None else \
        cnt.replace("!END", extra + "!END")
    order = np.random.default_rng(3).permutation(mesh.n_node)
    wd = str(tmp_path / "wd")
    write_static_workdir(wd, ordering.permute_mesh(mesh, order), cnt)
    return wd


def run_pair(wd):
    """``wd`` through the port on the CPU and, in a copy, through the
    JAX package; returns (port output, JAX output, JAX dir)."""
    import frontistr_tpu.run as jrun
    from frontistr_tpu_torch.run import run_directory
    wj = str(wd) + "_jax"
    shutil.copytree(wd, wj)
    oj = jrun.run_directory(wj)
    return run_directory(str(wd), device="cpu"), oj, wj


def u_by_id(out):
    """The displacement rows of a run's static result, sorted by node id."""
    u = np.asarray(out["static"].u).reshape(out["mesh"].n_node, -1)
    return u[np.argsort(out["mesh"].node_ids)]


def assert_pictures_close(a, b):
    """Two BMPs of one deck from the two packages: same size; every byte
    within one level (both quantise float images within 1e-12 of each
    other, and a channel at exactly 1.0 in one may be 1 - 2**-53 in the
    other); at most 0.1% of the pixels further apart (PSR: the z-buffer
    ties that a displacement 1e-14 apart breaks the other way)."""
    d = psf.bmp_diff(a, b)
    assert d["far"] <= FAR_SHARE * d["pixels"], d
    # a picture is drawn: the JAX test's bar (tests/test_visualizer.py)
    st = psf.bmp_stats(a)
    assert st["drawn"] > 0.2 and st["colours"] > 10, st
