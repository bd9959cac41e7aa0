"""Adaptive refinement in the port (``adapt.py``) against the JAX package
on the CPU: the cases of ``tests/test_adapt.py`` (the sharded one comes
with multi-GPU), each on the same input mesh in both packages, with the
refined meshes identical (coordinates bit-equal, the same node and
element numbering, blocks, sections and groups), the geometric checks
of the JAX test on the port's mesh, and ``zz_error`` within 1e-10 of
max|eta| on the same result (within 1e-6 on each package's own solve:
two CG solves to RESID 1e-8)."""

from itertools import combinations

import numpy as np
import pytest

from frontistr_tpu import adapt as jadapt
from frontistr_tpu.analysis.static import run_linear_static as jrun_static
from frontistr_tpu.assembly.model import build_struct_model as jbuild
from frontistr_tpu.io import ctrlio as jctrlio
from frontistr_tpu.io import meshio as jmeshio
from frontistr_tpu.meshgen import box_tet4 as jbox_tet4
from frontistr_tpu_torch import adapt
from frontistr_tpu_torch.analysis.static import run_linear_static
from frontistr_tpu_torch.assembly.model import build_struct_model
from frontistr_tpu_torch.io import ctrlio, meshio
from frontistr_tpu_torch.meshgen import box_tet4


def _same_mesh(m, jm):
    np.testing.assert_array_equal(m.coords, jm.coords)
    np.testing.assert_array_equal(m.node_ids, jm.node_ids)
    assert m.id2idx == jm.id2idx
    assert len(m.blocks) == len(jm.blocks)
    for b, jb in zip(m.blocks, jm.blocks):
        assert (b.etype, b.section_id) == (jb.etype, jb.section_id)
        np.testing.assert_array_equal(b.elem_ids, jb.elem_ids)
        np.testing.assert_array_equal(b.conn, jb.conn)
        np.testing.assert_array_equal(b.conn_hecmw, jb.conn_hecmw)
        assert b.conn.dtype == jb.conn.dtype
    for g, jg in ((m.node_groups, jm.node_groups),
                  (m.elem_groups, jm.elem_groups)):
        assert sorted(g) == sorted(jg)
        for k in g:
            np.testing.assert_array_equal(g[k], jg[k])
    assert dict(m.surf_groups) == dict(jm.surf_groups) == {}


def _vol(coords, conn):
    return np.abs(np.linalg.det(coords[conn[:, 1:]]
                                - coords[conn[:, :1]])) / 6.0


def _check_conforming(coords, conn):
    """Positive volumes; every face shared by at most 2 tets and a face
    of one tet on the unit box's hull (no hanging node)."""
    det = np.linalg.det(coords[conn[:, 1:]] - coords[conn[:, :1]])
    assert det.min() > 1e-14
    faces = {}
    for row in conn:
        for tri in combinations(sorted(map(int, row)), 3):
            faces[tri] = faces.get(tri, 0) + 1
    assert max(faces.values()) <= 2
    for tri, cnt in faces.items():
        if cnt == 1:
            p = coords[list(tri)]
            assert any(np.allclose(p[:, d], p[0, d]) and
                       (abs(p[0, d]) < 1e-12 or abs(p[0, d] - 1) < 1e-12)
                       for d in range(3)), tri


def _both(build_args, marks):
    """The same marks refined by each package: (port mesh, JAX mesh)."""
    m = adapt.adapt_mesh(build_args(box_tet4, meshio), marks)
    jm = jadapt.adapt_mesh(build_args(jbox_tet4, jmeshio), marks)
    _same_mesh(m, jm)
    return m


def test_single_mark_conforming_and_volume():
    m = _both(lambda box, mio: box(2, 2, 2), [1])
    conn = m.blocks[0].conn
    assert conn.shape[0] > 48
    _check_conforming(m.coords, conn)
    assert np.isclose(_vol(m.coords, conn).sum(), 1.0)


def test_marked_region_refined_others_coarse():
    m0 = box_tet4(3, 3, 3)
    conn0 = m0.blocks[0].conn
    touch = np.flatnonzero((m0.coords[conn0] ** 2).sum(-1).min(1) < 1e-12)
    m = _both(lambda box, mio: box(3, 3, 3), m0.blocks[0].elem_ids[touch])
    conn = m.blocks[0].conn
    _check_conforming(m.coords, conn)
    v = _vol(m.coords, conn)
    cen = m.coords[conn].mean(axis=1)
    near = v[np.linalg.norm(cen, axis=1) < 0.25]
    far = v[np.linalg.norm(cen - 1.0, axis=1) < 0.45]
    assert near.max() < far.min()
    assert np.isclose(v.sum(), 1.0)


def test_groups_propagate():
    m0 = box_tet4(2, 2, 2)
    m = _both(lambda box, mio: box(2, 2, 2), m0.blocks[0].elem_ids[:6])
    z0 = m.node_groups["Z0"]
    assert np.allclose(m.coords[z0][:, 2], 0.0)
    have = set(map(tuple, np.round(m.coords[z0][:, :2], 9)))
    for g in m0.node_groups["Z0"]:
        assert tuple(np.round(m0.coords[g][:2], 9)) in have
    assert len(m.elem_groups["ALL"]) == m.blocks[0].conn.shape[0]


def _corner_cfg(cio, mesh):
    cfg = cio.AnalysisConfig()
    cfg.solution_type = "STATIC"
    cfg.steps = [cio.StepInfo()]
    cfg.boundaries = [cio.Card("BOUNDARY", {}, [["Z0", "1", "3", "0.0"]])]
    corner = int(np.argmin(((mesh.coords - 1.0) ** 2).sum(1)))
    cfg.cloads = [cio.Card("CLOAD", {},
                           [[str(corner + 1), "3", "-1000.0"]])]
    return cfg


def test_zz_marks_stress_concentration():
    """Clamped box with a corner point load in each package: the ZZ
    indicator, the marks and the adapted mesh; the adapted mesh solves."""
    m, jm = box_tet4(3, 3, 3), jbox_tet4(3, 3, 3)
    res = run_linear_static(build_struct_model(m, _corner_cfg(ctrlio, m),
                                               device="cpu"))
    jres = jrun_static(jbuild(jm, _corner_cfg(jctrlio, jm)))
    eta = adapt.zz_error(m, res)
    scale = np.abs(eta).max()
    assert np.abs(jadapt.zz_error(jm, res) - eta).max() <= 1e-10 * scale
    assert np.abs(jadapt.zz_error(jm, jres) - eta).max() <= 1e-6 * scale
    eids = adapt.mark_fraction(eta, m.blocks[0].elem_ids, 0.15)
    np.testing.assert_array_equal(
        eids, jadapt.mark_fraction(eta, jm.blocks[0].elem_ids, 0.15))
    conn0 = m.blocks[0].conn
    cen = m.coords[conn0[np.asarray(eids) - 1]].mean(axis=1)
    d_all = np.linalg.norm(m.coords[conn0].mean(axis=1) - 1.0, axis=1)
    assert np.linalg.norm(cen - 1.0, axis=1).mean() < 0.8 * d_all.mean()
    m2 = adapt.adapt_by_error(m, res, 0.15)
    _same_mesh(m2, jadapt.adapt_by_error(jm, res, 0.15))
    _check_conforming(m2.coords, m2.blocks[0].conn)
    res2 = run_linear_static(build_struct_model(m2, _corner_cfg(ctrlio, m),
                                                device="cpu"))
    assert res2.relres < 1e-6


def _two_blocks(box, mio):
    mesh = box(3, 3, 3)
    b = mesh.blocks[0]
    conn = np.asarray(b.conn)
    lo = mesh.coords[conn].mean(axis=1)[:, 0] < 0.5
    e_ids = np.asarray(b.elem_ids)
    mesh.blocks = [mio.ElemBlock(341, e_ids[lo], conn[lo], conn[lo].copy(),
                                 section_id=0),
                   mio.ElemBlock(341, e_ids[~lo], conn[~lo],
                                 conn[~lo].copy(), section_id=1)]
    return mesh


def test_multiblock_adapt_conforming():
    mesh = _two_blocks(box_tet4, meshio)
    lo_ids = mesh.blocks[0].elem_ids
    out = _both(_two_blocks, [int(e) for e in lo_ids[:4]])
    assert [b.section_id for b in out.blocks] == [0, 1]
    conn_all = np.concatenate([bb.conn for bb in out.blocks])
    _check_conforming(out.coords, conn_all)
    assert np.isclose(_vol(out.coords, conn_all).sum(), 1.0)
    assert len(out.blocks[0].elem_ids) > len(lo_ids)
    eids = np.concatenate([bb.elem_ids for bb in out.blocks])
    assert len(np.unique(eids)) == len(eids)


def _mesh(mio, coords, blocks):
    md = mio.MaterialDef("M1")
    md.items[1] = [[210e3, 0.3]]
    ids = np.arange(1, len(coords) + 1)
    return mio.Mesh(header="", coords=coords, node_ids=ids,
                    id2idx={int(g): int(g) - 1 for g in ids},
                    blocks=[mio.ElemBlock(et, np.asarray(e), c, c.copy())
                            for et, e, c in blocks],
                    sections=[mio.Section("SOLID", "ALL", "M1", [])],
                    materials={"M1": md}, node_groups={}, elem_groups={},
                    surf_groups={}, amplitudes={}, equations=[],
                    contact_pairs=[], initial_conditions={}, zero_temp=0.0)


def _prism_grid(box, mio, nx=2, ny=2, nz=2):
    """A triangulated (nx, ny) layer extruded nz times, as prism6."""
    xs, ys, zs = (np.linspace(0, 1, k + 1) for k in (nx, ny, nz))
    coords = np.array([(x, y, z) for z in zs for y in ys for x in xs])

    def nid(i, j, k):
        return k * (nx + 1) * (ny + 1) + j * (nx + 1) + i
    conns = []
    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                a, b = nid(i, j, k), nid(i + 1, j, k)
                c, d = nid(i + 1, j + 1, k), nid(i, j + 1, k)
                A, B = nid(i, j, k + 1), nid(i + 1, j, k + 1)
                C, D = nid(i + 1, j + 1, k + 1), nid(i, j + 1, k + 1)
                conns += [[a, b, c, A, B, C], [a, c, d, A, C, D]]
    conn = np.asarray(conns, np.int64)
    return _mesh(mio, coords, [(351, np.arange(1, len(conn) + 1), conn)])


def test_prism_adapt_conforming_and_volume():
    m = _both(_prism_grid, [1])
    conn = m.blocks[0].conn
    assert m.blocks[0].etype == 351 and conn.shape[0] > 16
    dz = m.coords[conn[:, 3:]] - m.coords[conn[:, :3]]
    assert np.allclose(dz[:, :, :2], 0.0) and (dz[:, :, 2] > 1e-12).all()
    faces = {}
    for row in conn:
        for tri in (tuple(sorted(row[:3])), tuple(sorted(row[3:]))):
            faces[tri] = faces.get(tri, 0) + 1
    assert max(faces.values()) <= 2


def _tet_on_prism(box, mio, apex=(0.33, 0.33, 2.0), tet=(3, 4, 5, 6)):
    coords = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
                       [1, 0, 1], [0, 1, 1], list(apex)], float)
    return _mesh(mio, coords,
                 [(351, [1], np.asarray([[0, 1, 2, 3, 4, 5]], np.int64)),
                  (341, [2], np.asarray([tet], np.int64))])


def test_mixed_tet_prism_interface_conforming():
    m = _both(_tet_on_prism, [1])
    pb, tb = m.blocks
    assert len(pb.elem_ids) == 4 and len(tb.elem_ids) == 4
    ptop = {tuple(sorted(r[3:])) for r in pb.conn}
    tfaces = {tri for r in tb.conn
              for tri in combinations(sorted(map(int, r)), 3)
              if np.allclose(m.coords[list(tri), 2], 1.0)}
    assert ptop == tfaces


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_tet_cutting_prism_vertical_edge_raises(pkg):
    fn, mio = (adapt.adapt_mesh, meshio) if pkg == "torch" else \
        (jadapt.adapt_mesh, jmeshio)
    m = _tet_on_prism(None, mio, apex=(-1.0, 0.0, 0.5), tet=(0, 3, 2, 6))
    with pytest.raises(NotImplementedError, match="vertical edge"):
        fn(m, [2])


def test_other_element_types_raise():
    from frontistr_tpu_torch.meshgen import box_hex8
    with pytest.raises(NotImplementedError, match="tet4/prism6 blocks only"):
        adapt.adapt_mesh(box_hex8(2, 2, 2), [1])
