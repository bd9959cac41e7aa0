"""PVR volume rendering (!VISUAL, METHOD=PVR) on the run's device (torch
port of ``frontistr_tpu/vis/pvr.py``; reference
hecmw1/src/visualizer/hecmw_vis_pvr_main.c ray-casts the unstructured
mesh per pixel).  Three batched stages:

  1. voxelize: trilinear-splat the nodal scalar field onto a regular
     grid over the mesh's bounding box (a host ``np.add.at``, in the
     JAX package's order, so the grid is the same on every device),
     then masked Jacobi diffusion sweeps in float64 on the device fill
     the element interiors;
  2. sample: orthographic rays, a (H, W) lattice of sample points per
     depth slice, trilinear gathers from the voxel grid;
  3. composite: front-to-back alpha blending over the S depth slices
     (a loop on the device, the JAX ``lax.scan``) with a rainbow
     transfer function over a white background.

No step falls back to the CPU: a CUDA device computes stages 1's sweeps
and 2-3 there, and a failure there raises ``DeviceRenderError``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from frontistr_tpu_torch import device as devmod
from frontistr_tpu_torch.vis.psf import write_bmp


class DeviceRenderError(RuntimeError):
    """A failure of the device stages of the volume render; the runner
    lets it propagate (it never passes as a skipped picture)."""


def _splat(coords: np.ndarray, vals: np.ndarray, res: int):
    """Host trilinear splat (``frontistr_tpu/vis/pvr.py:31-51``):
    (res, res, res) grid of weighted means, the occupancy mask, the
    box's low corner and extent."""
    lo = coords.min(axis=0)
    hi = coords.max(axis=0)
    ext = np.maximum(hi - lo, 1e-12)
    t = (coords - lo) / ext * (res - 1)
    i0 = np.clip(t.astype(np.int64), 0, res - 2)
    f = t - i0
    grid = np.zeros((res, res, res))
    wsum = np.zeros((res, res, res))
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (np.where(dx, f[:, 0], 1 - f[:, 0])
                     * np.where(dy, f[:, 1], 1 - f[:, 1])
                     * np.where(dz, f[:, 2], 1 - f[:, 2]))
                np.add.at(grid, (i0[:, 0] + dx, i0[:, 1] + dy,
                                 i0[:, 2] + dz), w * vals)
                np.add.at(wsum, (i0[:, 0] + dx, i0[:, 1] + dy,
                                 i0[:, 2] + dz), w)
    occ = wsum > 1e-9
    grid = np.where(occ, grid / np.maximum(wsum, 1e-12), 0.0)
    return grid, occ, lo, ext


def _neighbours(x: torch.Tensor) -> torch.Tensor:
    """Sum of the six periodic face neighbours, in ``jnp.roll`` order."""
    return (torch.roll(x, 1, 0) + torch.roll(x, -1, 0)
            + torch.roll(x, 1, 1) + torch.roll(x, -1, 1)
            + torch.roll(x, 1, 2) + torch.roll(x, -1, 2))


def _sweep(g: torch.Tensor, m: torch.Tensor, fill_sweeps: int):
    """Masked Jacobi diffusion (``frontistr_tpu/vis/pvr.py:58-70``):
    splatted voxels stay fixed, an empty voxel takes the mean of its
    filled neighbours and joins the mask."""
    for _ in range(fill_sweeps):
        gs = _neighbours(g)
        ms = _neighbours(m)
        g = torch.where(m > 0, g, gs / torch.clamp(ms, min=1e-12))
        m = torch.where(m > 0, m, (ms > 0.5).to(g.dtype))
    return g, m


def voxelize(coords: np.ndarray, vals: np.ndarray, res: int = 96,
             fill_sweeps: int = 24, device="cuda",
             timings: Optional[dict] = None):
    """Nodal field -> (res, res, res) float64 voxel grid and bool
    occupancy mask on ``device``, the box's low corner and extent.
    ``timings`` gains ``pvr_splat`` and ``pvr_sweeps`` (seconds)."""
    dev = devmod.resolve(device)
    t = {} if timings is None else timings
    with devmod.Phase(t, "pvr_splat", dev):
        grid, occ, lo, ext = _splat(np.asarray(coords, float),
                                    np.asarray(vals, float), res)
    try:
        with devmod.Phase(t, "pvr_sweeps", dev):
            g, m = _sweep(torch.as_tensor(grid, device=dev),
                          torch.as_tensor(occ, dtype=torch.float64,
                                          device=dev), fill_sweeps)
            mask = m > 0.5
    except Exception as e:
        raise DeviceRenderError(f"PVR sweeps on {dev}: {e}") from e
    return g, mask, lo, ext


def _sample(grid: torch.Tensor, mask: torch.Tensor, p: torch.Tensor):
    """Trilinear sample of the grid and the mask at points ``p`` (..., 3)
    in grid coordinates, the mask's weight zero outside the grid."""
    R = grid.shape[0]
    i0 = torch.clamp(torch.floor(p).to(torch.int64), 0, R - 2)
    f = p - i0
    gflat, mflat = grid.reshape(-1), mask.reshape(-1)
    v = torch.zeros(p.shape[:-1], dtype=grid.dtype, device=grid.device)
    a = torch.zeros_like(v)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[..., 0] if dx else 1 - f[..., 0])
                     * (f[..., 1] if dy else 1 - f[..., 1])
                     * (f[..., 2] if dz else 1 - f[..., 2]))
                idx = ((i0[..., 0] + dx) * R + i0[..., 1] + dy) * R + \
                    i0[..., 2] + dz
                v = v + w * gflat[idx]
                a = a + w * mflat[idx]
    inb = ((p >= 0) & (p <= R - 1)).all(dim=-1)
    return v, a * inb


def composite(grid: torch.Tensor, mask: torch.Tensor, starts: torch.Tensor,
              step: torch.Tensor, n_steps: int, vmin: float, vmax: float,
              opacity: float) -> torch.Tensor:
    """Front-to-back compositing along rays (``_composite``,
    ``frontistr_tpu/vis/pvr.py:77-131``): ``starts`` (H, W, 3) grid-space
    entry points, ``step`` (3,) the grid-space ray step, ``n_steps``
    slices.  Returns the (H, W, 3) float image on the grid's device."""
    mask = mask.to(grid.dtype)
    H, W = starts.shape[:2]
    color = torch.zeros((H, W, 3), dtype=grid.dtype, device=grid.device)
    alpha = torch.zeros((H, W), dtype=grid.dtype, device=grid.device)
    for s in range(n_steps):
        v, a = _sample(grid, mask, starts + s * step)
        t = torch.clamp((v - vmin) / (vmax - vmin + 1e-30), 0.0, 1.0)
        # rainbow transfer function (blue -> red)
        c = torch.stack([torch.clamp(1.5 - torch.abs(4 * t - k), 0, 1)
                         for k in (3.0, 2.0, 1.0)], dim=-1)
        # value-weighted opacity: high field values dominate the image
        da = torch.clamp(a * opacity * (0.08 + 2.0 * t ** 2),
                         0.0, 1.0)[..., None]
        color = color + (1.0 - alpha[..., None]) * da * c
        alpha = alpha + ((1.0 - alpha) * da[..., 0])
    return color + (1.0 - alpha[..., None]) * torch.ones_like(color)


def camera(res: int, width: int, height: int, viewpoint, n_steps: int):
    """Orthographic camera in grid coordinates: the (H, W, 3) ray entry
    points and the (3,) step along the view direction -viewpoint."""
    n = np.asarray(viewpoint, float)
    n = n / np.linalg.norm(n)
    up = np.array([0.0, 0.0, 1.0])
    if abs(n @ up) > 0.95:
        up = np.array([0.0, 1.0, 0.0])
    u = np.cross(up, n)
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    c = (res - 1) / 2.0
    diag = (res - 1) * np.sqrt(3.0) / 2.0
    xs = np.linspace(-diag, diag, width)
    ys = np.linspace(diag, -diag, height)
    U, V = np.meshgrid(xs, ys)
    starts = (c + U[..., None] * u + V[..., None] * v
              + diag * n)                       # (H, W, 3) grid coords
    step = -n * (2.0 * diag / n_steps)
    return starts, step


def render_image(coords: np.ndarray, vals: np.ndarray, width: int = 500,
                 height: int = 500, viewpoint=(1.0, -2.0, 1.0),
                 res: int = 96, n_steps: int = 160, opacity: float = 0.08,
                 device="cuda", timings: Optional[dict] = None):
    """The volume render of a nodal scalar field as an (H, W, 3) float64
    tensor on ``device`` (before ``write_bmp`` quantises it).
    ``timings`` gains ``pvr_splat``, ``pvr_sweeps`` and
    ``pvr_composite``."""
    dev = devmod.resolve(device)
    vals = np.asarray(vals, float)
    grid, mask, _, _ = voxelize(coords[:, :3], vals, res=res, device=dev,
                                timings=timings)
    starts, step = camera(grid.shape[0], width, height, viewpoint, n_steps)
    t = {} if timings is None else timings
    try:
        with devmod.Phase(t, "pvr_composite", dev):
            img = composite(grid, mask, torch.as_tensor(starts, device=dev),
                            torch.as_tensor(step, device=dev), n_steps,
                            float(vals.min()), float(vals.max()), opacity)
    except Exception as e:
        raise DeviceRenderError(f"PVR composite on {dev}: {e}") from e
    return img


def render_pvr(coords: np.ndarray, vals: np.ndarray, out_path: str,
               width: int = 500, height: int = 500,
               viewpoint=(1.0, -2.0, 1.0), res: int = 96,
               n_steps: int = 160, opacity: float = 0.08, device="cuda",
               timings: Optional[dict] = None) -> str:
    """Render a nodal scalar field as a volume on ``device``; writes a
    BMP and returns its path."""
    img = render_image(coords, vals, width=width, height=height,
                       viewpoint=viewpoint, res=res, n_steps=n_steps,
                       opacity=opacity, device=device, timings=timings)
    write_bmp(out_path, img.cpu().numpy())
    return out_path
