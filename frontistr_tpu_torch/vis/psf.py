"""In-situ PSF surface rendering -> BMP (host numpy; the PVR arm renders
on the run's device through ``vis/pvr.py``).

Rebuild of the reference visualizer's surface pipeline
(hecmw1/src/visualizer/: hecmw_visualizer.c:19-60, surface extraction
hecmw_vis_surface_main.c, software rendering + BMP output
hecmw_vis_resampling.c / output BMP): extract the boundary surface of the
mesh, color it by a nodal result component, optionally deform by the
displacement field, and rasterize with a vectorized z-buffer point-splat
(numpy scatter-min — no per-pixel loops, no GL).

Controls honored from the !VISUAL card (hecmw_vis_read_control.c):
x_resolution / y_resolution, viewpoint, deform_display_on,
color_comp_name, output_type=BMP.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Optional

import numpy as np

from frontistr_tpu_torch.assembly.loads import FACE_TABLES

def extract_surface(mesh):
    """Boundary faces of the mesh as triangles (n_tri, 3) node indices.

    A face is on the boundary iff its sorted corner-node set appears
    exactly once across all elements (the reference's surface extraction
    criterion).  Vectorised: the faces of every block, face number and
    element in the JAX loop's order, one stable sort of their sorted
    corner keys; the boundary faces keep their order of first occurrence
    (``frontistr_tpu/vis/psf.py:30-62``), a quad fanned into (0, 1, 2),
    (0, 2, 3)."""
    from frontistr_tpu_torch.elements.tables import ETYPE_INFO
    faces = []                   # (n, 4) corner rows, -1 pads a triangle
    for b in mesh.blocks:
        conn = np.asarray(b.conn, np.int64)
        if b.etype in (731, 741):          # shells: mid-surface is the face
            sel = [list(range(conn.shape[1]))]
        elif b.etype in ETYPE_INFO and ETYPE_INFO[b.etype][0] == 3:
            sel = [list(ln[:3] if ft in (231, 232) else ln[:4])
                   for ft, ln in FACE_TABLES.get(b.etype, ())]
        else:
            continue
        for corners in sel:
            f = np.full((len(conn), 4), -1, np.int64)
            f[:, :len(corners)] = conn[:, corners]
            faces.append(f)
    if not faces:
        return np.zeros((0, 3), np.int64)
    faces = np.concatenate(faces)
    keys = np.sort(faces, axis=1)            # a triangle's -1 sorts first
    srt = np.lexsort(keys.T[::-1])           # stable: ties keep face order
    ks = keys[srt]
    head = np.ones(len(ks), bool)
    head[1:] = (ks[1:] != ks[:-1]).any(axis=1)
    count = np.bincount(np.cumsum(head) - 1)
    once = faces[np.sort(srt[head][count == 1])]
    quad = once[:, 3] >= 0
    at = np.arange(len(once)) + np.cumsum(quad) - quad   # first triangle
    tris = np.empty((len(once) + int(quad.sum()), 3), np.int64)
    tris[at] = once[:, :3]
    tris[at[quad] + 1] = once[quad][:, [0, 2, 3]]
    return tris


def _rainbow(t):
    """t in [0,1] -> RGB uint8 (blue -> cyan -> green -> yellow -> red)."""
    t = np.clip(t, 0.0, 1.0)
    r = np.clip(np.minimum(4 * t - 2, -4 * t + 6), 0, 1)
    g = np.clip(np.minimum(4 * t, -4 * t + 4), 0, 1)
    b = np.clip(2 - 4 * t, 0, 1)
    return np.stack([r, g, b], -1)


def write_bmp(path: str, img: np.ndarray):
    """img (H, W, 3) float 0..1 or uint8 -> 24-bit BMP."""
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    h, w = img.shape[:2]
    row = w * 3
    pad = (4 - row % 4) % 4
    size = 54 + (row + pad) * h
    with open(path, "wb") as f:
        f.write(b"BM")
        f.write(struct.pack("<IHHI", size, 0, 0, 54))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0,
                            (row + pad) * h, 2835, 2835, 0, 0))
        zero = b"\x00" * pad
        for y in range(h - 1, -1, -1):
            bgr = img[y, :, ::-1].tobytes()
            f.write(bgr + zero)


def read_bmp(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a 24-bit BMP written by ``write_bmp``."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:2] != b"BM":
        raise ValueError(f"{path} is not a BMP")
    w, h = struct.unpack("<ii", raw[18:26])
    row = (w * 3 + 3) // 4 * 4
    img = np.frombuffer(raw[54:54 + row * h], np.uint8).reshape(h, row)
    return img[::-1, :w * 3].reshape(h, w, 3)[..., ::-1]


def bmp_stats(path: str) -> dict:
    """A BMP's (H, W), the share of its pixels that are not white and its
    number of colours."""
    img = read_bmp(path)
    return {"shape": img.shape[:2],
            "drawn": float((img != 255).any(axis=-1).mean()),
            "colours": len(np.unique(img.reshape(-1, 3), axis=0))}


def bmp_diff(a: str, b: str) -> dict:
    """Two BMPs of one size: the pixels that differ, those more than one
    level apart in some channel ("far") and the pixel count."""
    x, y = read_bmp(a).astype(int), read_bmp(b).astype(int)
    if x.shape != y.shape:
        raise ValueError(f"{a} and {b} differ in size")
    diff = np.abs(x - y).max(axis=-1)
    return {"differ": int((diff > 0).sum()), "far": int((diff > 1).sum()),
            "pixels": diff.size}


def render_surface(coords, tris, values, out_path,
                   width=500, height=500, viewpoint=(1.0, -2.0, 1.0),
                   samples_per_edge=8, background=(1.0, 1.0, 1.0),
                   vrange: Optional[tuple] = None):
    """Z-buffer splat rendering of a triangulated surface.

    coords (n,3) deformed node positions; values (n,) nodal scalar for the
    color map; orthographic projection looking along -viewpoint."""
    if len(tris) == 0:
        img = np.ones((height, width, 3)) * np.asarray(background)
        write_bmp(out_path, img)
        return
    vdir = np.asarray(viewpoint, float)
    vdir = vdir / np.linalg.norm(vdir)
    up = np.asarray([0.0, 0.0, 1.0])
    if abs(vdir @ up) > 0.9:
        up = np.asarray([0.0, 1.0, 0.0])
    ex = np.cross(up, vdir)
    ex /= np.linalg.norm(ex)
    ey = np.cross(vdir, ex)
    P = np.stack([ex, ey, vdir], 0)              # rows: screen x, y, depth

    p = coords[tris]                              # (T, 3, 3)
    val = values[tris]                            # (T, 3)
    # flat shading factor from the face normal
    nrm = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    nn = np.linalg.norm(nrm, axis=1)
    nrm = nrm / np.where(nn == 0, 1.0, nn)[:, None]
    shade = 0.45 + 0.55 * np.abs(nrm @ vdir)      # (T,)

    # screen frame from the corner projections
    qc = np.einsum("tkj,ij->tki", p, P)
    margin = 0.05
    xmin, xmax = qc[..., 0].min(), qc[..., 0].max()
    ymin, ymax = qc[..., 1].min(), qc[..., 1].max()
    span = max(xmax - xmin, ymax - ymin, 1e-30) * (1 + 2 * margin)
    cx, cy = 0.5 * (xmin + xmax), 0.5 * (ymin + ymax)
    px_per_unit = (width - 1) / span

    # adaptive sampling: ~2 samples per pixel along the longest edge
    edges = np.stack([qc[:, 1] - qc[:, 0], qc[:, 2] - qc[:, 1],
                      qc[:, 0] - qc[:, 2]], 1)[..., :2]
    elen = np.linalg.norm(edges, axis=-1).max(-1) * px_per_unit
    kreq = np.clip((2.0 * elen).astype(int) + 2, 2, 96)

    pts_l, vals_l, shades_l = [], [], []
    for k in np.unique(kreq):
        sel = kreq == k
        u, v = np.meshgrid(np.linspace(0, 1, k), np.linspace(0, 1, k))
        m = u + v <= 1.0 + 1e-12
        u, v = u[m], v[m]
        bary = np.stack([1.0 - u - v, u, v], -1)  # (S, 3)
        pts_l.append(np.einsum("sk,tkj->tsj", bary,
                               p[sel]).reshape(-1, 3))
        vals_l.append(np.einsum("sk,tk->ts", bary,
                                val[sel]).reshape(-1))
        shades_l.append(np.repeat(shade[sel], bary.shape[0]))
    pts = np.concatenate(pts_l)
    vals = np.concatenate(vals_l)
    shades = np.concatenate(shades_l)

    q = pts @ P.T                                 # screen coords + depth
    x, y, z = q[:, 0], q[:, 1], q[:, 2]
    px = ((x - cx) / span + 0.5) * (width - 1)
    py = ((y - cy) / span + 0.5) * (height - 1)
    # splat to the 4 neighbouring pixels so surfaces close up
    zbuf = np.full((height, width), -np.inf)
    cbuf = np.ones((height, width, 3)) * np.asarray(background)
    if vrange is None:
        vmin, vmax = float(vals.min()), float(vals.max())
    else:
        vmin, vmax = vrange
    t = (vals - vmin) / max(vmax - vmin, 1e-30)
    rgb = _rainbow(t) * shades[:, None]
    for dx in (0, 1):
        for dy in (0, 1):
            ix = np.clip(np.floor(px).astype(int) + dx, 0, width - 1)
            iy = np.clip(np.floor(py).astype(int) + dy, 0, height - 1)
            flat = iy * width + ix
            # scatter-max on depth, keep color of the winner
            order = np.argsort(z)                # far -> near; last wins
            np.maximum.at(zbuf.reshape(-1), flat[order], z[order])
            win = z[order] >= zbuf.reshape(-1)[flat[order]] - 1e-12
            cbuf.reshape(-1, 3)[flat[order][win]] = rgb[order][win]
    write_bmp(out_path, cbuf[::-1])


_COMP_INDEX = {"1": 0, "2": 1, "3": 2, "4": 3, "5": 4, "6": 5}


def _vis_params(cfg):
    vis = getattr(cfg, "visual", {}) or {}
    width = int(float(vis.get("x_resolution", 500)))
    height = int(float(vis.get("y_resolution", 500)))
    vp = vis.get("viewpoint")
    viewpoint = tuple(float(t) for t in vp.split()) if vp else \
        (1.0, -2.0, 1.0)
    return vis, width, height, viewpoint


def _render_psr(mesh, coords, vals, out, width, height, viewpoint,
                timings):
    """The PSR arm on the host: the boundary triangles, then the splat;
    ``timings`` gains ``psr_extract`` and ``psr_render`` (seconds)."""
    t0 = time.perf_counter()
    tris = extract_surface(mesh)
    t1 = time.perf_counter()
    render_surface(coords, tris, vals, out, width=width, height=height,
                   viewpoint=viewpoint)
    t2 = time.perf_counter()
    if timings is not None:
        for k, v in (("psr_extract", t1 - t0), ("psr_render", t2 - t1)):
            timings[k] = timings.get(k, 0.0) + v
    return out


def visualize_scalar(mesh, vals, workdir, cfg, basename="result",
                     device="cuda", timings=None):
    """Scalar nodal-field render (temperature, pressure, …) on the
    undeformed surface — the transient-heat in-situ arm
    (heat_solve_TRAN.f90:268-270 → hecmw_visualize per interval).  PVR
    renders on ``device``; ``timings`` gains each stage's seconds."""
    vis, width, height, viewpoint = _vis_params(cfg)
    coords = mesh.coords[:, :3]
    vals = np.asarray(vals, float).reshape(-1)
    out = os.path.join(workdir, basename + ".bmp")
    if (vis.get("method") or "PSR").upper() == "PVR":
        from frontistr_tpu_torch.vis.pvr import render_pvr
        return render_pvr(coords, vals, out, width=width, height=height,
                          viewpoint=viewpoint, device=device,
                          timings=timings)
    return _render_psr(mesh, coords, vals, out, width, height, viewpoint,
                       timings)


def visual_field(mesh, result, vis, comp, sub):
    """The picture's node positions (deformed by ``deform_display_on``,
    ``deform_scale``) and its nodal values: component ``comp`` (STRESS,
    STRAIN, subcomponent ``sub``; MISES; else the displacement's
    length) of ``result``."""
    u = np.asarray(result.u)
    coords = mesh.coords[:, :3].copy()
    if u.ndim == 1:
        u = u.reshape(mesh.n_node, -1)
    deform_on = str(vis.get("deform_display_on", "1")) not in ("0", "off")
    if deform_on:
        scale = float(vis.get("deform_scale", 0.0))
        if scale == 0.0:
            umax = np.abs(u[:, :3]).max()
            ext = coords.max(0) - coords.min(0)
            scale = 0.1 * ext.max() / max(umax, 1e-30)
        coords = coords + scale * u[:, :3]
    if comp.startswith("STRESS"):
        vals = result.nodal_stress[:, min(sub - 1, 5)]
    elif comp.startswith("STRAIN"):
        vals = result.nodal_strain[:, min(sub - 1, 5)]
    elif comp.startswith("MISES"):
        vals = result.nodal_mises
    else:
        vals = np.linalg.norm(u[:, :3], axis=1)
    return coords, vals


def visualize(mesh, model, result, workdir, cfg, basename="result",
              device="cuda", timings=None):
    """!WRITE,VISUAL entry: render the deformed, colored surface to
    <workdir>/<basename>.bmp (fstr static_output.f90:74-76 calls the
    visualizer in-situ the same way).  PVR renders on ``device``;
    ``timings`` gains each stage's seconds."""
    vis, width, height, viewpoint = _vis_params(cfg)
    comp = (vis.get("color_comp_name", "DISPLACEMENT") or "").upper()
    sub = int(float(vis.get("color_subcomp", 1)))

    # AVS UCD output modes (hecmw_vis_surface_main.c output_type=
    # AVS / COMPLETE_AVS / COMPLETE_REORDER_AVS / BIN_COMPLETE_AVS):
    # dump the full model + results as a UCD .inp instead of rendering
    otype = (vis.get("output_type", "") or "").upper()
    if "AVS" in otype:
        from frontistr_tpu_torch.io.ucd import static_result_ucd
        out = os.path.join(workdir, basename + ".inp")
        return static_result_ucd(mesh, result, out)

    coords, vals = visual_field(mesh, result, vis, comp, sub)
    out = os.path.join(workdir, basename + ".bmp")
    if (vis.get("method") or "PSR").upper() == "PVR":
        # volume rendering arm (hecmw_vis_pvr_main.c equivalent)
        from frontistr_tpu_torch.vis.pvr import render_pvr
        return render_pvr(coords, np.asarray(vals, float), out,
                          width=width, height=height,
                          viewpoint=viewpoint, device=device,
                          timings=timings)
    return _render_psr(mesh, coords, vals, out, width, height, viewpoint,
                       timings)
