"""``!WRITE, VISUAL`` of the port (``vis/psf.py``, ``vis/pvr.py``,
``io/ucd.py``) against the JAX package's, on the CPU:

- ``extract_surface`` identical; ``render_surface`` + ``write_bmp``
  byte-equal from the same inputs;
- the PVR voxel grid, mask and float image within 1e-12 (of the
  largest) of ``frontistr_tpu.vis.pvr.voxelize`` and ``_composite``
  (res 16, 48 x 32 pixels, 40 slices);
- STATIC decks with PSR, PVR and AVS through ``run_directory``: the BMPs
  within the bar of
  ``_torch_vis_decks.assert_pictures_close`` (one level a byte; 0.1% of
  the pixels further apart), the UCD ``.inp`` equal but for values
  within 1e-8 (of each column's largest), and byte-equal when the
  port's writer is given the JAX run's result;
- the picture bar's witness: on a tet4 deck the JAX package's own PSR
  picture, its u changed by 1e-14 of itself, moves as far as the port's;
- the deliberate deviation of ROADMAP fault 13: a host error of a deck
  the visualizer cannot draw is printed and skipped, as the JAX runner
  does, but an error of the device render propagates.

STATICEIGEN's picture is held in ``test_torch_eigen_static.py``, NLSTATIC's
in ``test_torch_static.py``, heat's and dynamics' every FREQUENCY steps in
``test_torch_heat.py`` and ``test_torch_dynamic.py``.
"""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frontistr_tpu.vis import psf as jpsf
from frontistr_tpu.vis import pvr as jpvr
from frontistr_tpu_torch.io.ucd import static_result_ucd
from frontistr_tpu_torch.meshgen import box_hex8, box_tet4, plate_shell
from frontistr_tpu_torch.run import run_directory
from frontistr_tpu_torch.vis import psf, pvr

from _torch_decks import tet10_box
from _torch_vis_decks import (FAR_SHARE, assert_pictures_close, run_pair,
                              visual_deck)

SURFACES = {
    "tet4": lambda: box_tet4(3, 2, 2),
    "hex8": lambda: box_hex8(3, 2, 2),
    "tet10": lambda: tet10_box(2, 2, 1),
    "plate741": lambda: plate_shell(3, 2, etype=741),
}


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("FRONTISTR_TPU_COMPILE_CACHE", "0")
    monkeypatch.setenv("FRONTISTR_TPU_REORDER", "1")
    return monkeypatch


def _field(mesh, seed=0):
    """Coordinates moved a little and a smooth nodal field, from ``seed``."""
    rng = np.random.default_rng(seed)
    c = mesh.coords + 0.02 * rng.standard_normal(mesh.coords.shape)
    return c, np.sin(3.0 * c[:, 0]) + c[:, 2] ** 2 + 0.1 * c[:, 1]


@pytest.mark.parametrize("kind", list(SURFACES))
def test_surface_and_splat_match_jax(tmp_path, kind):
    mesh = SURFACES[kind]()
    tris = psf.extract_surface(mesh)
    np.testing.assert_array_equal(tris, jpsf.extract_surface(mesh))
    assert tris.dtype == np.int64 and len(tris) > 0
    coords, vals = _field(mesh)
    a, b = str(tmp_path / "port.bmp"), str(tmp_path / "jax.bmp")
    psf.render_surface(coords, tris, vals, a, width=96, height=72)
    jpsf.render_surface(coords, tris, vals, b, width=96, height=72)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_pvr_matches_jax():
    mesh = box_hex8(5, 4, 3)
    coords, vals = _field(mesh, seed=1)
    g, m, lo, ext = pvr.voxelize(coords, vals, res=16, device="cpu")
    gj, mj, loj, extj = jpvr.voxelize(coords, vals, res=16)
    assert g.dtype == torch.float64 and g.shape == (16, 16, 16)
    assert np.abs(g.numpy() - gj).max() <= 1e-12 * np.abs(gj).max()
    np.testing.assert_array_equal(m.numpy(), mj)
    np.testing.assert_array_equal(lo, loj)
    np.testing.assert_array_equal(ext, extj)
    starts, step = pvr.camera(16, 48, 32, (1.0, -2.0, 1.0), 40)
    vmin, vmax = float(vals.min()), float(vals.max())
    img = pvr.composite(g, m, torch.as_tensor(starts), torch.as_tensor(step),
                        40, vmin, vmax, 0.08).numpy()
    want = np.asarray(jpvr._composite(
        jnp.asarray(gj), jnp.asarray(mj, jnp.float64), jnp.asarray(starts),
        jnp.asarray(step), jnp.zeros(40), vmin, vmax, 0.08))
    assert img.shape == (32, 48, 3)
    assert np.abs(img - want).max() <= 1e-12
    # the whole render on the CPU: the same image
    full = pvr.render_image(coords, vals, 48, 32, res=16, n_steps=40,
                            device="cpu")
    np.testing.assert_array_equal(full.numpy(), img)


def _ucd_close(a, b):
    """Two UCD files of one deck: the header, nodes, cells and labels
    byte-equal; the data rows' ids equal and their values within 1e-8 of
    each column's largest (stresses of 1e-10 that are zero in exact
    arithmetic print differently)."""
    la, lb = open(a).read().splitlines(), open(b).read().splitlines()
    assert len(la) == len(lb)
    n_node, n_elem = (int(v) for v in la[5].split())
    head = 6 + n_node + n_elem + 4           # + component counts, labels
    assert la[:head] == lb[:head] and "MISES" in la[head - 1]
    x = np.asarray([[float(v) for v in r.split()] for r in la[head:]])
    y = np.asarray([[float(v) for v in r.split()] for r in lb[head:]])
    np.testing.assert_array_equal(x[:, 0], y[:, 0])
    assert (np.abs(x - y) <= 1e-8 * np.abs(y).max(axis=0)).all()


@pytest.mark.parametrize("method", ["PSR", "PVR", "AVS"])
def test_static_pictures_match_jax(tmp_path, env, capsys, method):
    more = "!output_type = COMPLETE_AVS\n" if method == "AVS" else ""
    wd = visual_deck(tmp_path, "PSR" if method == "AVS" else method,
                     more=more)
    ot, oj, wj = run_pair(wd)
    assert "visualizer skipped" not in capsys.readouterr().out
    u, uj = ot["static"].u, np.asarray(oj["static"].u)
    assert np.abs(u - uj).max() <= 1e-8 * np.abs(uj).max()
    if method == "AVS":
        name = "result.inp"
        _ucd_close(os.path.join(wd, name), os.path.join(wj, name))
        # the port's writer on the JAX run's result: byte-equal
        again = str(tmp_path / "again.inp")
        static_result_ucd(ot["mesh"], oj["static"], again)
        assert open(again, "rb").read() == \
            open(os.path.join(wj, name), "rb").read()
    else:
        name = "result.bmp"
        assert_pictures_close(os.path.join(wd, name), os.path.join(wj, name))
        if method == "PVR":
            assert {"pvr_splat", "pvr_sweeps", "pvr_composite"} <= \
                set(ot["timings"])
        else:
            assert {"psr_extract", "psr_render"} <= set(ot["timings"])
    assert ot["visual"] == os.path.join(wd, name)


def test_psr_ties_flip_within_the_reference(tmp_path, env):
    """The witness for ``FAR_SHARE``: PSR splats the surface points into a
    z-buffer, and a change of u by 1e-14 of itself breaks ties between
    faces the other way.  On the PSR deck of ``box_tet4(5, 4, 3)`` the JAX
    package's own picture, u so changed (seeds 0-3), has 0.130%, 0.141%,
    0.141% and 0.033% of its pixels more than one level from the
    unchanged one, so the bar's 0.1% is that noise and no more.  The
    port's picture of the deck (0.033% apart) lies within that spread."""
    wd = visual_deck(tmp_path, "PSR", mesh=box_tet4(5, 4, 3))
    ot, oj, wj = run_pair(wd)
    ref = os.path.join(wj, "result.bmp")
    spread = []
    for seed in range(4):
        r = copy.copy(oj["static"])
        u = np.asarray(r.u)
        r.u = u * (1.0 + 1e-14 * np.random.default_rng(seed).uniform(
            -1.0, 1.0, u.shape))
        moved = jpsf.visualize(oj["mesh"], oj["model"], r, wj, oj["cfg"],
                               basename=f"moved{seed}")
        d = psf.bmp_diff(ref, moved)
        spread.append(d["far"] / d["pixels"])
    assert max(spread) > FAR_SHARE
    d = psf.bmp_diff(os.path.join(wd, "result.bmp"), ref)
    assert d["far"] / d["pixels"] <= max(spread)


def test_host_error_is_skipped_as_in_jax(tmp_path, env, capsys):
    """A !VISUAL parameter the host code cannot read: both runners print
    the skip and finish the analysis."""
    wd = visual_deck(tmp_path, "PSR", more="!color_subcomp = x\n")
    ot, oj, wj = run_pair(wd)
    out = capsys.readouterr().out
    assert out.count("### visualizer skipped: could not convert") == 2
    assert ot["visual"] is None and "static" in ot
    assert not os.path.exists(os.path.join(wd, "result.bmp"))
    assert not os.path.exists(os.path.join(wj, "result.bmp"))


@pytest.mark.parametrize("error", [RuntimeError, IndexError])
def test_device_error_propagates(tmp_path, env, capsys, error):
    """ROADMAP fault 13: an error raised in the device stages of the PVR
    render (injected into its first Jacobi sweep) is never printed as a
    skipped picture; it propagates out of ``run_directory``, an
    IndexError there too."""
    def broken(*a, **kw):
        raise error("CUDA error: an illegal memory access was encountered")
    env.setattr(pvr, "_neighbours", broken)
    wd = visual_deck(tmp_path, "PVR")
    with pytest.raises(pvr.DeviceRenderError, match="illegal memory"):
        run_directory(wd, device="cpu")
    assert "visualizer skipped" not in capsys.readouterr().out
    assert not os.path.exists(os.path.join(wd, "result.bmp"))
